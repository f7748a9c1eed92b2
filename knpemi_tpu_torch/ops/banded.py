"""Block-banded dense matvecs of the multigrid V-cycle (K7, K8).

Counterpart of ``knpemi_tpu/ops/pallas_banded.py``.  A block-banded
operator (``solvers/mg.py::_csr_to_banded``) stores, per block of R = 256
rows, one dense slab over that block's column window:

    slabT[b*W + w, r] = A[b*R + r, w0[b] + w]        slabT is (NB*W, R)

so ``y[b*R + r] = sum_w slabT[b*W + w, r] * x[w0[b] + w]`` with x read as
zero beyond its length m.  The caller (``solvers/mg.py::_banded_mv``)
sums an operator's windows and adds its COO remainder.

The slab may be stored in bfloat16 (a storage type: each value is upcast
after the read), float32 or float64; x is never rounded and the sum is
taken in x's type.  The TPU kernel's 128-aligned window starts and its
(rows, 128) table of x are its own memory rules; here ``w0`` is any
start.

On a CUDA tensor a wrapper launches its kernel (``csrc/mg.cu``) or
raises; the plain twin — the window gather and contraction of the JAX
package's non-Pallas path — runs only for CPU tensors.  The kernels sum
over w in order, the plain versions in whatever order the contraction
takes: they agree to ~1e-5 max|y| in float32 and ~1e-12 in float64.
"""

from __future__ import annotations

import torch

from . import assembly as A

# slab storage types and their codes in csrc/mg.cu
_SLAB_CODE = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}


def _check_band(slabT, w0, v, n: int, W: int, batch: bool):
    A._check_value(v, "X" if batch else "x")
    if v.dim() != (2 if batch else 1):
        raise ValueError(f"the vector argument has shape {tuple(v.shape)}")
    if slabT.dtype not in (v.dtype, torch.bfloat16):
        raise TypeError(f"slabT is {slabT.dtype}: expected {v.dtype} or bfloat16")
    if slabT.device != v.device or not slabT.is_contiguous() or slabT.dim() != 2:
        raise ValueError("slabT must be a contiguous matrix on the vector's device")
    rows, R = slabT.shape
    if W <= 0 or rows % W or not 0 < R <= 1024:
        raise ValueError(f"slabT has shape {(rows, R)}, not (NB*{W}, R <= 1024)")
    NB = rows // W
    A._check(w0, "w0", v, (NB,), index=True)
    if not (NB - 1) * R < n <= NB * R:
        raise ValueError(f"n = {n} does not fit {NB} blocks of {R} rows")
    return NB, R


def _windows(w0, X, W: int):
    """X (..., m) -> (..., NB, W): every block's window of X, zero beyond m."""
    xp = torch.nn.functional.pad(X, (0, W))
    idx = w0.long()[:, None] + torch.arange(W, device=X.device)[None, :]
    return xp[..., idx]


def banded_matvec_plain(slabT, w0, x, n: int, W: int):
    NB, R = slabT.shape[0] // W, slabT.shape[1]
    slab = slabT.reshape(NB, W, R).to(x.dtype)
    return torch.einsum("nwr,nw->nr", slab, _windows(w0, x, W)).reshape(NB * R)[:n]


def banded_matvec(slabT, w0, x, n: int, W: int):
    """K7.  One window of a block-banded operator times a vector.

    Replaces ``knpemi_tpu/ops/pallas_banded.py:_banded_mv_call`` (via
    ``banded_matvec``).  Bound on the H100: bytes — the slab read once
    (it is ~W times the vectors), x and w0 read once, y written once
    (``csrc/mg.cu``).  Design: one CTA per row block, thread r owns row
    r, so each slab read is coalesced over r; the window of x is staged
    in shared memory in tiles of 512 columns, read from there by every
    thread at once.

    slabT (NB*W, R), w0 (NB,) index, x (m,) -> y (n,)."""
    NB, R = _check_band(slabT, w0, x, n, W, batch=False)
    if not x.is_cuda:
        return banded_matvec_plain(slabT, w0, x, n, W)
    y = torch.empty(n, dtype=x.dtype, device=x.device)
    A._launch("banded_matvec", x, _SLAB_CODE[slabT.dtype], slabT.data_ptr(),
              w0.data_ptr(), x.data_ptr(), y.data_ptr(), NB, R, W, n, x.shape[0])
    banded_matvec.launches += 1
    return y


banded_matvec.launches = 0


def banded_matvec_batch_plain(slabT, w0, X, n: int, W: int):
    NB, R = slabT.shape[0] // W, slabT.shape[1]
    slab = slabT.reshape(NB, W, R).to(X.dtype)
    Y = torch.einsum("nwr,bnw->bnr", slab, _windows(w0, X, W))
    return Y.reshape(X.shape[0], NB * R)[:, :n]


def banded_matvec_batch(slabT, w0, X, n: int, W: int):
    """K8.  K7 for B vectors from one read of the slab.

    Replaces ``knpemi_tpu/ops/pallas_banded.py:_banded_mv_call_batch``
    (via ``banded_matvec_batch``).  Bound on the H100: bytes — the slab
    read once for all B vectors, X read once, Y written once
    (``csrc/mg.cu``).  Design: as K7, with the windows of all B vectors
    in one shared-memory tile (at most 8 x 512 values, 32 KB in float64,
    so no width of window outgrows a CTA) and B accumulators per thread;
    more than 8 vectors go through in groups of 8.

    slabT (NB*W, R), w0 (NB,) index, X (B, m) -> Y (B, n)."""
    NB, R = _check_band(slabT, w0, X, n, W, batch=True)
    if not X.is_cuda:
        return banded_matvec_batch_plain(slabT, w0, X, n, W)
    B, m = X.shape
    Y = torch.empty(B, n, dtype=X.dtype, device=X.device)
    for b0 in range(0, B, A.BATCH_MAX):
        A._launch("banded_matvec_batch", X, _SLAB_CODE[slabT.dtype],
                  slabT.data_ptr(), w0.data_ptr(), X[b0:].data_ptr(),
                  Y[b0:].data_ptr(), NB, R, W, n, m, min(A.BATCH_MAX, B - b0))
        banded_matvec_batch.launches += 1
    return Y


banded_matvec_batch.launches = 0


# (wrapper, plain version)
KERNELS = {
    "K7 banded_matvec": (banded_matvec, banded_matvec_plain),
    "K8 banded_matvec_batch": (banded_matvec_batch, banded_matvec_batch_plain),
}
