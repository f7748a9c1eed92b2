"""kernels_per_step: device kernels a step in the traced run's CUDA-only
profile over whole steps, the port's and PyTorch's alike (memory copies
and sets left out).  Moves ms_per_step."""


def read(rec):
    ev = rec.get("events")
    if not ev:
        return None
    n = sum(1 for name, _, _ in ev if not name.startswith(("Memcpy", "Memset")))
    return n / rec["profile_steps"]
