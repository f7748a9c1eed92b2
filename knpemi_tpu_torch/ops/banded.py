"""Block-banded matvecs of the multigrid V-cycle (K7, K8) on a packed form.

Counterpart of ``knpemi_tpu/ops/pallas_banded.py``.  A block-banded
operator (``solvers/mg.py::_csr_to_banded``, the JAX package's host
layout) stores, per block of R = 256 rows, one dense slab over that
block's column window:

    slabT[b*W + w, r] = A[b*R + r, w0[b] + w]        slabT is (NB*W, R)

so ``y[b*R + r] = sum_w slabT[b*W + w, r] * x[w0[b] + w]`` with x read as
zero beyond its length m.  The caller (``solvers/mg.py::_banded_mv``)
sums an operator's windows and adds its COO remainder.

The slabs are a few percent nonzero: the TPU reads the zeros because its
matrix unit wants dense (128, R) tiles; on the H100 they are wasted bytes.  So
the device never holds a slab.  :func:`pack_window` turns each host
window into a *packed window*, a sliced ELL of the slab's nonzeros: the
NB*R rows are cut into slices of 32, and slice s stores K[s] slots per
row (its longest row's nonzero count), ordered slice, then slot, then
row, so that the 32 rows' slot k lie side by side.  Each slot holds the
column offset inside the block's window (``off``: a uint16, kept in an
int16 tensor and widened with ``& 0xFFFF``, since PyTorch's uint16 lacks
most operators) and the value (``val``, in the slab's storage type:
float32, float64, or bfloat16 upcast after the read).  Within a row the
slots follow the slab's column order; padding slots hold value 0 at
offset 0.  A zero slab entry adds ``fma(0, x, acc) = acc`` exactly, so
the packed sum repeats the dense one's arithmetic on finite inputs.

On a CUDA tensor a wrapper launches its kernel (``csrc/mg.cu``) or
raises; the plain twin (gather x at the slots' columns, multiply, sum
per row) runs only for CPU tensors.  The kernels sum each row's slots
in column order with fused multiply-adds, the plain versions by an
unfused ``index_add_``: they agree to ~1e-5 max|y| in float32 and ~1e-12
in float64.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import assembly as A

# storage types of the values and their codes in csrc/mg.cu
_SLAB_CODE = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
# how a launch reads the window of x (codes in csrc/mg.cu): None picks
# "staged" (shared memory) where the B windows fit in STAGE_MAX_BYTES,
# else "l2"
_ROUTE_CODE = {None: 0, "staged": 1, "l2": 2}
STAGE_MAX_BYTES = 112 << 10  # csrc/mg.cu kStageMax: two staged CTAs per SM
SLICE = 32  # rows per slice: one warp
MAX_W = 1 << 16  # widest window a uint16 offset can address


@dataclasses.dataclass
class PackedWindow:
    """One window of a block-banded operator as the kernels read it.

    slot_ptr (NS + 1,) int32: slice s owns slots [slot_ptr[s],
    slot_ptr[s + 1]), 32 K[s] of them, NS = NB*R/32; off (slots,) int16,
    the bits of the uint16 column offset in the block's window; val
    (slots,) storage type; w0 (NB,) index: the window starts; W, R: the
    window width and the rows per block; nnz: the slab's nonzeros (the
    other slots are padding); slot_ptr_host: slot_ptr in numpy, the
    frozen shape a value refill keeps (:func:`repack_window`)."""

    slot_ptr: torch.Tensor
    off: torch.Tensor
    val: torch.Tensor
    w0: torch.Tensor
    W: int
    R: int
    nnz: int
    slot_ptr_host: Optional[np.ndarray] = None

    @property
    def NB(self) -> int:
        return self.w0.shape[0]

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.slot_ptr, self.off, self.val, self.w0))


def _pack(slabT, W: int, slot_ptr=None):
    """The packed arrays of a host slab (see :func:`pack_window`):
    ``(slot_ptr int64, off uint16, val, nnz, dropped, dropped_mass)``.
    With ``slot_ptr`` given (a frozen shape) a row with more nonzeros than
    its slice holds keeps its largest |values| and drops the others,
    ``dropped`` of them with ``dropped_mass`` of |value| in all."""
    slabT = np.asarray(slabT)
    rows, R = slabT.shape
    if R <= 0 or R % SLICE or R > 1024:
        raise ValueError(f"R = {R} rows per block: the packed form needs a "
                         f"multiple of {SLICE} up to 1024")
    if not 0 < W <= MAX_W or rows % W:
        raise ValueError(f"slabT has {rows} rows: not NB*W for W = {W} <= {MAX_W}")
    NB = rows // W
    # in (b, w, r) order; through a mask, ~5x faster than on the floats
    flat = np.flatnonzero(slabT != 0)
    vals = slabT.reshape(-1)[flat]
    w = (flat // R) % W
    row = flat // (R * W) * R + flat % R
    # per row in column order: a stable sort by row keeps w ascending
    order = np.argsort(row, kind="stable")
    row, w, vals = row[order], w[order], vals[order]
    count = np.bincount(row, minlength=NB * R)
    dropped, dropped_mass = 0, 0.0
    if slot_ptr is None:
        K = count.reshape(-1, SLICE).max(axis=1)
        slot_ptr = np.zeros(K.shape[0] + 1, np.int64)
        np.cumsum(SLICE * K, out=slot_ptr[1:])
        if slot_ptr[-1] >= 1 << 31:
            raise ValueError(f"{slot_ptr[-1]} slots: more than an int32 can address")
    else:
        slot_ptr = np.asarray(slot_ptr, np.int64)
        if slot_ptr.shape != (NB * R // SLICE + 1,):
            raise ValueError("the frozen slot_ptr does not describe NB*R/32 slices")
        cap = np.repeat(np.diff(slot_ptr) // SLICE, SLICE)
        if (count > cap).any():
            # each overfull row keeps its cap largest |values|, in column order
            first = np.cumsum(count) - count
            rank = np.empty_like(row)
            by_mag = np.lexsort((-np.abs(vals), row))
            rank[by_mag] = np.arange(row.shape[0]) - first[row[by_mag]]
            keep = rank < cap[row]
            dropped = int((~keep).sum())
            dropped_mass = float(np.abs(vals[~keep]).sum())
            row, w, vals = row[keep], w[keep], vals[keep]
            count = np.bincount(row, minlength=NB * R)
    first = np.cumsum(count) - count  # each row's first nonzero in `row`
    pos = np.arange(row.shape[0]) - first[row]
    slot = slot_ptr[row // SLICE] + pos * SLICE + row % SLICE
    off = np.zeros(slot_ptr[-1], np.uint16)
    off[slot] = w
    val = np.zeros(slot_ptr[-1], slabT.dtype)
    val[slot] = vals
    return slot_ptr, off, val, int(row.shape[0]), dropped, dropped_mass


def pack_window(slabT, w0, W: int, slab_dtype, device) -> PackedWindow:
    """The packed form of one host window ``(slabT (NB*W, R), w0 (NB,),
    W)`` of :func:`~knpemi_tpu_torch.solvers.mg._csr_to_banded`, values in
    ``slab_dtype`` on ``device``.  Built in numpy in one pass over the
    slab's nonzeros; the slab itself is not uploaded."""
    slot_ptr, off, val, nnz, _, _ = _pack(slabT, W)
    return PackedWindow(
        slot_ptr=torch.as_tensor(slot_ptr.astype(np.int32), device=device),
        off=torch.as_tensor(off.view(np.int16), device=device),
        # uploaded as built (the run dtype), cast on the device
        val=torch.as_tensor(val, device=device).to(slab_dtype),
        w0=torch.as_tensor(w0, dtype=A.index_dtype(device), device=device),
        W=int(W), R=int(np.shape(slabT)[1]), nnz=nnz, slot_ptr_host=slot_ptr,
    )


def repack_window(win: PackedWindow, slabT):
    """A refreshed slab of the same window geometry packed into ``win``'s
    frozen shape: ``([(win.off, off), (win.val, val)], dropped,
    dropped_mass)``, host arrays to copy into the device tensors.  A
    nonzero the slice has no slot for (float32 rounding creates and
    destroys exact zeros of the slab) is dropped, the row's smallest
    first, and counted: the caller holds the dropped |value| mass against
    its guard."""
    _, off, val, _, dropped, mass = _pack(slabT, win.W, win.slot_ptr_host)
    return [(win.off, off.view(np.int16)), (win.val, val)], dropped, mass


def _slot_rows(win: PackedWindow) -> torch.Tensor:
    """The row (0 .. NB*R) of every slot."""
    ptr = win.slot_ptr.long()
    dev = ptr.device
    slice_of = torch.repeat_interleave(torch.arange(ptr.shape[0] - 1, device=dev),
                                       ptr[1:] - ptr[:-1])
    # every slice starts at a multiple of 32: the lane is the slot's index mod 32
    return slice_of * SLICE + torch.arange(ptr[-1], device=dev) % SLICE


def _check_band(win: PackedWindow, v, n: int, batch: bool) -> int:
    A._check_value(v, "X" if batch else "x")
    if v.dim() != (2 if batch else 1) or v.shape[-1] == 0:
        raise ValueError(f"the vector argument has shape {tuple(v.shape)}")
    if win.val.dtype not in (v.dtype, torch.bfloat16):
        raise TypeError(f"val is {win.val.dtype}: expected {v.dtype} or bfloat16")
    R, W = win.R, win.W
    if R <= 0 or R % SLICE or R > 1024:
        raise ValueError(f"R = {R}: a multiple of {SLICE} up to 1024 is needed")
    if not 0 < W <= MAX_W:
        raise ValueError(f"W = {W}: the uint16 offsets address at most {MAX_W}")
    NB = win.NB
    A._check(win.w0, "w0", v, (NB,), index=True)
    if win.slot_ptr.dtype != torch.int32 or win.off.dtype != torch.int16:
        raise TypeError("slot_ptr must be int32 and off int16")
    for name in ("slot_ptr", "off", "val"):
        t = getattr(win, name)
        if t.device != v.device or not t.is_contiguous() or t.dim() != 1:
            raise ValueError(f"{name} must be a contiguous vector on the vector's device")
    if win.slot_ptr.shape[0] != NB * R // SLICE + 1 or win.off.shape != win.val.shape:
        raise ValueError("slot_ptr, off and val do not describe NB*R/32 slices")
    if not (NB - 1) * R < n <= NB * R:
        raise ValueError(f"n = {n} does not fit {NB} blocks of {R} rows")
    return NB


def _packed_plain(win: PackedWindow, X, n: int):
    """X (..., m) -> (..., n): every slot's value times x at its column,
    summed per row."""
    row = _slot_rows(win)
    col = win.w0.long()[row // win.R] + (win.off.long() & 0xFFFF)
    xp = torch.nn.functional.pad(X, (0, win.W))  # x is zero beyond m
    prod = win.val.to(X.dtype) * xp[..., col]
    Y = torch.zeros(*X.shape[:-1], win.NB * win.R, dtype=X.dtype, device=X.device)
    return Y.index_add_(-1, row, prod)[..., :n]


def banded_matvec_plain(win: PackedWindow, x, n: int):
    return _packed_plain(win, x, n)


def banded_matvec(win: PackedWindow, x, n: int, route=None):
    """K7.  One window of a block-banded operator times a vector.

    Replaces ``knpemi_tpu/ops/pallas_banded.py:_banded_mv_call`` (via
    ``banded_matvec``).  Bound on the H100: bytes — the packed window's
    nonzeros (a value and a 2-byte offset each), w0 and x read once, y
    written once (``csrc/mg.cu``); the padding slots come on top.  Design:
    one warp per 32-row slice reads slot k of its 32 rows in one coalesced
    load, several slots in flight per thread; the window of x is copied
    into shared memory asynchronously while the first slots load
    (``route`` "staged", the default where it fits) or read from L2
    (``route`` "l2").

    win (PackedWindow), x (m,) -> y (n,)."""
    NB = _check_band(win, x, n, batch=False)
    if not x.is_cuda:
        return banded_matvec_plain(win, x, n)
    y = torch.empty(n, dtype=x.dtype, device=x.device)
    A._launch("banded_matvec", x, _SLAB_CODE[win.val.dtype], win.slot_ptr.data_ptr(),
              win.off.data_ptr(), win.val.data_ptr(), win.w0.data_ptr(),
              x.data_ptr(), y.data_ptr(), NB, win.R, win.W, n, x.shape[0],
              _ROUTE_CODE[route])
    banded_matvec.launches += 1
    return y


banded_matvec.launches = 0


def banded_matvec_batch_plain(win: PackedWindow, X, n: int):
    return _packed_plain(win, X, n)


def banded_matvec_batch(win: PackedWindow, X, n: int, route=None):
    """K8.  K7 for B vectors from one read of the packed window.

    Replaces ``knpemi_tpu/ops/pallas_banded.py:_banded_mv_call_batch``
    (via ``banded_matvec_batch``).  Bound on the H100: bytes — the
    nonzeros read once for all B vectors, X read once, Y written once
    (``csrc/mg.cu``).  Design: as K7, with B accumulators per thread and
    the windows of all B vectors staged together where they fit in
    shared memory; more than 8 vectors go through in groups of 8.

    win (PackedWindow), X (B, m) -> Y (B, n)."""
    NB = _check_band(win, X, n, batch=True)
    if not X.is_cuda:
        return banded_matvec_batch_plain(win, X, n)
    B, m = X.shape
    Y = torch.empty(B, n, dtype=X.dtype, device=X.device)
    for b0 in range(0, B, A.BATCH_MAX):
        A._launch("banded_matvec_batch", X, _SLAB_CODE[win.val.dtype],
                  win.slot_ptr.data_ptr(), win.off.data_ptr(), win.val.data_ptr(),
                  win.w0.data_ptr(), X[b0:].data_ptr(), Y[b0:].data_ptr(), NB,
                  win.R, win.W, n, m, min(A.BATCH_MAX, B - b0), _ROUTE_CODE[route])
        banded_matvec_batch.launches += 1
    return Y


banded_matvec_batch.launches = 0


# (wrapper, plain version)
KERNELS = {
    "K7 banded_matvec": (banded_matvec, banded_matvec_plain),
    "K8 banded_matvec_batch": (banded_matvec_batch, banded_matvec_batch_plain),
}
