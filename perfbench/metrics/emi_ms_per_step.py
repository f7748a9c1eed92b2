"""emi_ms_per_step: the step/emi phase's milliseconds a step, timed by
a synchronising span passed to ``Simulation.step`` over the traced
run's span steps.  Moves ms_per_step."""


def read(rec):
    t = rec.get("phase_s", {}).get("step/emi")
    return 1e3 * sum(t) / len(t) if t else None
