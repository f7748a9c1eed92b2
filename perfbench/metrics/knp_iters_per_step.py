"""knp_iters_per_step: the KNP GMRES's iterations a step (the most of
any block) over the traced run's window (``SimState.knp_iters`` of every
step).  Moves ms_per_step."""


def read(rec):
    it = rec.get("iters")
    return float(it[:, 1].mean()) if it is not None and len(it) else None
