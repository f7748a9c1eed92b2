"""emi_iters_per_step: the EMI CG's iterations a step over the traced
run's window (``SimState.emi_iters`` of every step).  Moves ms_per_step."""


def read(rec):
    it = rec.get("iters")
    return float(it[:, 0].mean()) if it is not None and len(it) else None
