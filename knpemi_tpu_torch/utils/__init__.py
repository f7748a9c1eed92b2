"""Host utilities of the port: watchdog-safe critical sections
(``critical``), progress prints and timers (``logging``) and the native
host toolkit (``native``, a C++ library built by ``g++`` at first use)."""

from .logging import bcolors, log_step, Timer

__all__ = ["bcolors", "log_step", "Timer"]
