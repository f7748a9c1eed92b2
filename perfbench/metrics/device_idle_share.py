"""device_idle_share: 1 - (the union of device operations a step, from
the traced run's CUDA-only profile over whole steps) / (the window's
unprofiled seconds a step).  Never the profiled steps' wall time, which
the profiler stretches.  Moves ms_per_step."""

from perfbench import trace


def read(rec):
    ev = rec.get("events")
    if not ev:
        return None
    busy = trace.union_us(ev) * 1e-6 / rec["profile_steps"]
    return 1.0 - busy / (rec["ms_per_step"] * 1e-3)
