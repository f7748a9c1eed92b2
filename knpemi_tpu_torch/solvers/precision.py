"""Compensated (double-single) inner products for float32 runs.

Counterpart of ``knpemi_tpu/solvers/precision.py``: the product-
compensated dot (Ogita-Rump-Oishi Dot2 with Dekker splitting for the
exact product error).  Every elementwise product is split exactly into
p + e in float32 and both channels are summed; the result tracks the
float64 dot to ~1e-9 relative on physiological vectors.  float64 inputs
take the plain dot.
"""

from __future__ import annotations

import torch

_SPLIT = 4097.0  # 2^12 + 1: Dekker split constant for f32 (24-bit mantissa)


def _two_prod(a, b):
    """Exact product: a*b = p + e in f32 pairs (Dekker/Veltkamp)."""
    p = a * b
    ca = a * _SPLIT
    a_hi = ca - (ca - a)
    a_lo = a - a_hi
    cb = b * _SPLIT
    b_hi = cb - (cb - b)
    b_lo = b - b_hi
    e = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, e


def dot2(u, v):
    """Product-compensated dot of two vectors (0-d tensor)."""
    if u.dtype == torch.float64:
        return torch.dot(u, v)
    p, e = _two_prod(u, v)
    return p.sum() + e.sum()


def bdot2(u, v):
    """Batched compensated dot: (B, n) x (B, n) -> (B,)."""
    if u.dtype == torch.float64:
        return torch.einsum("bn,bn->b", u, v)
    p, e = _two_prod(u, v)
    return p.sum(dim=-1) + e.sum(dim=-1)



# ---------------------------------------------------------------------------
# distributed inner products (the multi-device modes, ``parallel/``)
# ---------------------------------------------------------------------------
def make_pdot2(comm):
    """Distributed :func:`dot2` over ``comm``'s ranks (the JAX package's
    ``make_pdot2``): the compensated partial sums stay local and one sum
    over the ranks carries (value, error); float64 inputs take the plain
    local dot and one sum."""

    def pdot2(u, v):
        if u.dtype == torch.float64:
            return comm.all_reduce(torch.dot(u, v), "dot")
        p, e = _two_prod(u, v)
        s = comm.all_reduce(torch.stack([p.sum(), e.sum()]), "dot")
        return s[0] + s[1]

    return pdot2


def make_pbdot2(comm):
    """Distributed :func:`bdot2`: (B, n_loc) rows -> (B,), the (value,
    error) pairs of all B rows in one sum over the ranks."""

    def pbdot2(u, v):
        if u.dtype == torch.float64:
            return comm.all_reduce(torch.einsum("bn,bn->b", u, v), "dot")
        p, e = _two_prod(u, v)
        s = comm.all_reduce(torch.stack([p.sum(dim=-1), e.sum(dim=-1)]), "dot")
        return s[0] + s[1]

    return pbdot2


def make_pdot(comm):
    """The plain distributed dot (float64, or uncompensated float32): the
    local dot and one sum over the ranks (the JAX package's ``pdot``)."""
    return lambda u, v: comm.all_reduce(torch.dot(u, v), "dot")


def make_pbdot(comm):
    """The plain distributed batched dot: (B, n_loc) rows -> (B,)."""
    return lambda u, v: comm.all_reduce(torch.einsum("bn,bn->b", u, v), "dot")
