"""Cooperative critical sections for wall-clock watchdogs.

Counterpart of ``knpemi_tpu/utils/critical.py``.  A caller that bounds
its work with ``signal.alarm`` must not abandon some host work midway:
writing a cache entry (the multigrid hierarchy,
``solvers/mg.py::build_hierarchy_cached``; the t = 0 EMI assembly,
``sim/stepper.py::Simulation._assemble_emi_cached``) interrupted there
would leave an orphaned temporary file and lose the whole build.

Guarded code enters ``critical_section()``; a watchdog's SIGALRM handler
checks ``in_critical_section()`` and re-arms a short alarm instead of
raising, so that the timeout lands right after the guarded work.
CPython runs signal handlers on the main thread, so a plain counter is
enough.
"""

from __future__ import annotations

from contextlib import contextmanager

_depth = 0


@contextmanager
def critical_section():
    """Mark the enclosed block as not to be interrupted by a watchdog."""
    global _depth
    _depth += 1
    try:
        yield
    finally:
        _depth -= 1


def in_critical_section() -> bool:
    return _depth > 0
