"""build_s: the host seconds of the program's set-up, the sum of
``Simulation.setup_seconds`` (P1 operators, systems, multigrid
hierarchies and their caches).  Moves setup_s."""


def read(rec):
    parts = rec.get("setup_seconds")
    return sum(parts.values()) if parts else None
