"""The port's drivers: scripts a user runs with ``python -m``."""
