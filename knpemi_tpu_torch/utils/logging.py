"""Progress prints and timers of the port's drivers.

Counterpart of ``knpemi_tpu/utils/logging.py`` (``bcolors``,
``log_step``, ``warn``, ``Timer``): ANSI-coloured step prints and a
scoped wall-clock timer.

Not ported: ``setup_mark``, the JAX package's set-up stage prints, which
an environment variable turns on; the port reads no environment
variable, and ``Simulation.setup_seconds`` (``sim/stepper.py``) records
each part of the set-up instead.  ``sim/stepper.py`` reports a solve
that did not converge or a skipped refresh by ``warnings.warn`` (a
``RuntimeWarning`` a caller can catch or filter), not by :func:`warn`.
"""

from __future__ import annotations

import time


class bcolors:
    HEADER = "\033[95m"
    OKBLUE = "\033[94m"
    OKCYAN = "\033[96m"
    OKGREEN = "\033[92m"
    WARNING = "\033[93m"
    FAIL = "\033[91m"
    ENDC = "\033[0m"
    BOLD = "\033[1m"
    UNDERLINE = "\033[4m"


def log_step(t: float, unit: str = "s", extra: str = ""):
    print(f"{bcolors.OKBLUE}Solving for t = {t:.4f} {unit}{bcolors.ENDC} {extra}")


def warn(msg: str):
    print(f"{bcolors.WARNING}WARNING: {msg}{bcolors.ENDC}")


class Timer:
    """Scoped wall-clock timer: ``with Timer('ODE step') as t: ...``."""

    def __init__(self, name: str, verbose: bool = True):
        self.name = name
        self.verbose = verbose
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        if self.verbose:
            print(f"\t{self.name}: {self.elapsed:.4f}s")
        return False
