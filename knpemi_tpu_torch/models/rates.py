"""Numerically stable building blocks for membrane-model rate functions.

Counterpart of ``knpemi_tpu/models/rates.py``.  The classic HH rates
contain the removable singularity ``x / (exp(x/k) - 1)`` (alpha_m at
V = -40 mV, alpha_n at V = -55 mV); the raw form is 0/0 = NaN whenever
``exp`` rounds to exactly 1, a window an f32 RK4 sweep of the action
potential upstroke does hit.  ``exprel_inv`` evaluates z / (exp(z) - 1)
stably: a Bernoulli series for small z, z / expm1(z) elsewhere, with
the unselected branch's operand sanitized so it stays NaN-free.
"""

from __future__ import annotations

import torch

__all__ = ["exprel_inv"]


def exprel_inv(z: torch.Tensor) -> torch.Tensor:
    """z / (exp(z) - 1), finite for all z (limit 1 at z = 0)."""
    small = torch.abs(z) < 1e-4
    zs = torch.where(small, torch.ones_like(z), z)
    # z/(e^z - 1) = 1 - z/2 + z^2/12 - ... ; truncation error at
    # |z| = 1e-4 is ~1e-17, far below f32 roundoff
    series = 1.0 - z / 2.0 + (z * z) / 12.0
    return torch.where(small, series, zs / torch.expm1(zs))
