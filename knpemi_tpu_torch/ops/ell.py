"""Windowed-ELL sparse operators of the multigrid V-cycle (K4, K5, K6a, K6b).

Counterpart of ``knpemi_tpu/ops/pallas_ell.py``.  Two halves:

* **host layout** (numpy, copied from the JAX package): :class:`ELLW` and
  :func:`build_ellw` decide, exactly as there, whether a matrix gets this
  layout at all (``None`` when a row needs more than 256 slots or more
  than 10% of the entries fall outside every chunk's window), its chunk
  size ``C``, slot count ``K``, window height ``Wr`` and the far COO
  list.  ``solvers/mg.py`` reads those decisions: a refused layout falls
  back to plain ELL, and the fused post-smooth compares ``NCH*Wr*K*C``
  of two layouts.
* **device form** (:class:`DeviceELLW`, from :meth:`ELLW.device`): a plain
  row-major ELL ``cols, vals`` of shape (n_rows, K) with *global* column
  ids ``q*128 + lidx``.  The windows, the (G, 128) group layout and the
  8-group-aligned ``q`` exist on the TPU to turn a gather into one-hot
  matrix products over a short axis; on Hopper a gather is a load, so
  none of it reaches the device.  The far COO entries are **folded into
  the free slots of their rows** (a row has at most K nonzeros,
  ``build_ellw``), so the device operator is exactly A with no second
  pass; padded slots carry value 0.

The four applies, each with a plain PyTorch twin on the same tensors:

=====================  ====  ======================================
``ellw_matvec``        K4    y = A x        (``assembly.ell_matvec``)
``ellw_rmatvec``       K5    y = A^T r      scatter, ``atomicAdd``
``ellw_matvec_batch``  K6a   Y = X A^T      B vectors, indices read once
``ellw_rmatvec_batch`` K6b   Y = R A        B vectors, ``atomicAdd``
=====================  ====  ======================================

On a CUDA tensor a wrapper launches its kernel (``csrc/mg.cu``) or
raises; the plain twin runs only for CPU tensors.  The scatter kernels
sum with atomics in an order that changes from run to run: they agree
with their plain versions to ~1e-5 max|y| in float32 and ~1e-12 max|y|
in float64, not bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import assembly as A


# ---------------------------------------------------------------------------
# host layout (numpy), as in knpemi_tpu/ops/pallas_ell.py
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class DeviceELLW:
    """Row-major ELL form of an :class:`ELLW` on a device, far entries
    folded in.  ``C, K, NCH, Wr`` are the host layout's statics."""

    n_rows: int
    n_cols: int
    C: int
    K: int
    NCH: int
    Wr: int
    cols: torch.Tensor  # (n_rows, K) int32 on CUDA, int64 on the CPU
    vals: torch.Tensor  # (n_rows, K)


@dataclasses.dataclass
class ELLW:
    """Host-side windowed-ELL layout of one sparse matrix.  Lane layout is
    slot-blocked: lane j*C + c = (row c of the chunk, slot j)."""

    n_rows: int
    n_cols: int
    C: int          # rows per chunk
    K: int          # padded slots per row
    NCH: int        # number of chunks
    Wr: int         # window height in 128-element groups
    G: int          # padded source groups (>= max(q) + Wr, mult of 8)
    q: np.ndarray       # (NCH,) int32 window start group, multiple of 8
    lidx: np.ndarray    # (NCH, 1, K*C) int32 window-local ids
    vals: np.ndarray    # (NCH, 1, K*C) float
    far_rows: np.ndarray  # (far_cap,) int32 (zero-padded: val 0 -> no-op)
    far_cols: np.ndarray
    far_vals: np.ndarray
    far_cap: int

    def to_ell(self):
        """Row-major ELL (cols (n_rows, K) int32, vals (n_rows, K)) of the
        same matrix: global column ids, far entries in the free slots of
        their rows, padded slots at column 0 with value 0."""
        NCH, C, K, n = self.NCH, self.C, self.K, self.n_rows
        unlane = lambda a: (a.reshape(NCH, K, C).transpose(0, 2, 1)
                            .reshape(NCH * C, K)[:n])
        vals = unlane(self.vals).copy()
        gidx = self.q.astype(np.int64)[:, None] * 128 + self.lidx.reshape(NCH, K * C)
        cols = np.where(vals != 0, unlane(gidx), 0)
        far = np.flatnonzero(self.far_vals != 0)
        if len(far):
            rows = self.far_rows[far].astype(np.int64)
            # inside entries fill a row's slots from 0 up; its far entries
            # (listed row by row) take the free slots from K-1 down
            first = np.searchsorted(rows, rows, side="left")
            slot = K - 1 - (np.arange(len(rows)) - first)
            if slot.min() < 0 or (vals[rows, slot] != 0).any():
                raise ValueError("ellw: a row has no free slot for its far entries")
            vals[rows, slot] = self.far_vals[far]
            cols[rows, slot] = self.far_cols[far]
        return cols.astype(np.int32), vals

    def device(self, dtype, device) -> DeviceELLW:
        cols, vals = self.to_ell()
        return DeviceELLW(
            self.n_rows, self.n_cols, self.C, self.K, self.NCH, self.Wr,
            cols=torch.as_tensor(cols, dtype=A.index_dtype(device), device=device),
            vals=torch.as_tensor(vals, dtype=dtype, device=device),
        )


def _pad_pow2(k: int) -> int:
    p = 8
    while p < k:
        p *= 2
    return p


def build_ellw(A, Wr_cap: int = 128, far_frac_max: float = 0.10) -> Optional[ELLW]:
    """Build the windowed-ELL layout of a scipy CSR matrix.

    Returns None when a row needs more than 256 slots or more than
    ``far_frac_max`` of the entries would spill outside every chunk's
    window (the matrix is not bandwidth-ordered enough for this layout).
    The JAX package's ``force_shape`` refill belongs to its hierarchy
    refresh and is not ported."""
    A = A.tocsr()
    n, m = A.shape
    indptr, indices, data = A.indptr, A.indices, A.data
    row_nnz = np.diff(indptr)
    K = _pad_pow2(max(1, int(row_nnz.max())))
    if K > 256:
        return None
    C = max(8, 2048 // K)
    NCH = -(-n // C)

    # per-chunk window CENTER from the mean column group — robust to a
    # few stray entries (an absolute min would let one outlier drag the
    # window off the band and spill everything); start aligned down to
    # 8 groups, the JAX package's layout rule
    rows = np.repeat(np.arange(n), row_nnz)
    chunk = rows // C
    col_grp = indices // 128
    cnt = np.maximum(1, np.bincount(chunk, minlength=NCH))
    mean_g = np.bincount(chunk, weights=col_grp, minlength=NCH) / cnt

    def starts(Wr_try):
        # floor-alignment to 8 groups loses up to 7 groups of placement:
        # aiming the aligned start at (center - Wr/2 + 4) guarantees the
        # window covers a half-band of (Wr/2 - 4) groups either side
        q = np.rint(mean_g - Wr_try / 2.0 + 4.0).astype(np.int64)
        return np.clip((q // 8) * 8, 0, None)

    # smallest 8-multiple window covering enough entries — but keep
    # widening (up to 2x that width) if a spill-free window exists
    first = zero = None
    for Wc in range(8, Wr_cap + 1, 8):
        q_try = starts(Wc)
        off = col_grp - q_try[chunk]
        frac_out = np.mean((off < 0) | (off >= Wc))
        if first is None and frac_out <= 0.5 * far_frac_max:
            first = Wc
        if frac_out == 0.0:
            zero = Wc
            break
        if first is not None and Wc >= 2 * first:
            break
    if first is None and zero is None:
        Wr = -(-Wr_cap // 8) * 8
    elif zero is not None and (first is None or zero <= 2 * first):
        Wr = zero
    else:
        Wr = first
    qc = starts(Wr)

    inside = (col_grp - qc[chunk] >= 0) & (col_grp - qc[chunk] < Wr)
    n_far = int((~inside).sum())
    if n_far > far_frac_max * max(1, A.nnz):
        return None

    # compact inside entries per row into slots 0..k-1 (stable per row)
    ins_idx = np.flatnonzero(inside)
    r_ins = rows[ins_idx]
    slot = np.zeros(A.nnz, np.int64)
    csum = np.cumsum(inside)
    row_start_csum = np.concatenate([[0], csum])[indptr[:-1]]
    slot[ins_idx] = csum[ins_idx] - 1 - row_start_csum[r_ins]

    KC = K * C
    lidx = np.zeros((NCH, 1, KC), np.int32)
    vals = np.zeros((NCH, 1, KC), data.dtype)
    ch = chunk[ins_idx]
    c_loc = (rows[ins_idx] % C).astype(np.int64)
    lane = slot[ins_idx] * C + c_loc
    lidx[ch, 0, lane] = (indices[ins_idx] - qc[ch] * 128).astype(np.int32)
    vals[ch, 0, lane] = data[ins_idx]

    far_idx = np.flatnonzero(~inside)
    far_cap = 0
    while far_cap < n_far:
        far_cap = max(64, far_cap * 2)
    far_rows = np.zeros(far_cap, np.int32)
    far_cols = np.zeros(far_cap, np.int32)
    far_vals = np.zeros(far_cap, data.dtype)
    if n_far:
        far_rows[:n_far] = rows[far_idx]
        far_cols[:n_far] = indices[far_idx]
        far_vals[:n_far] = data[far_idx]

    # padded source groups of the JAX package's (G, 128) table
    G = int(max(qc.max() + Wr, -(-m // 128)))
    G = -(-G // 8) * 8
    return ELLW(
        n_rows=n, n_cols=m, C=C, K=K, NCH=NCH, Wr=Wr, G=G,
        q=qc.astype(np.int32), lidx=lidx, vals=vals,
        far_rows=far_rows, far_cols=far_cols, far_vals=far_vals,
        far_cap=far_cap,
    )


# ---------------------------------------------------------------------------
# applies on the device form
# ---------------------------------------------------------------------------
def _check_layout(e: DeviceELLW, v: torch.Tensor, name: str, length: int,
                  batch: bool):
    A._check_value(v, name)
    if v.dim() != (2 if batch else 1) or v.shape[-1] != length:
        want = f"(B, {length})" if batch else f"({length},)"
        raise ValueError(f"{name} has shape {tuple(v.shape)}, expected {want}")
    A._check(e.cols, "cols", v, (e.n_rows, e.K), index=True)
    A._check(e.vals, "vals", v, (e.n_rows, e.K))


def ellw_matvec_plain(e: DeviceELLW, x):
    return A.ell_matvec_plain(e.cols, e.vals, x)


def ellw_matvec(e: DeviceELLW, x):
    """K4.  y = A x; x (n_cols,) -> y (n_rows,).  The device form is plain
    ELL, so this is :func:`assembly.ell_matvec`, the B = 1 case of K6a,
    and counts as its launch."""
    _check_layout(e, x, "x", e.n_cols, batch=False)
    return A.ell_matvec(e.cols, e.vals, x)


def ellw_rmatvec_plain(e: DeviceELLW, r):
    ye = e.vals * r[:, None]
    y = torch.zeros(e.n_cols, dtype=r.dtype, device=r.device)
    return y.index_add_(0, e.cols.reshape(-1).long(), ye.reshape(-1))


def ellw_rmatvec(e: DeviceELLW, r):
    """K5.  y = A^T r from the layout of A: y[cols[i, k]] += vals[i, k] r[i].

    Replaces ``knpemi_tpu/ops/pallas_ell.py:_make_scatter_kernel`` (via
    ``ellw_rmatvec``).  Bound on the H100: bytes — cols, vals, r read
    once, y written once (``csrc/mg.cu``).  Design: one thread per row,
    exact loads, one ``atomicAdd`` per nonzero slot into a zeroed y
    (padded slots, value 0, are skipped: they would all hit one address).

    r (n_rows,) -> y (n_cols,)."""
    _check_layout(e, r, "r", e.n_rows, batch=False)
    if not r.is_cuda:
        return ellw_rmatvec_plain(e, r)
    y = torch.zeros(e.n_cols, dtype=r.dtype, device=r.device)
    A._launch("ell_rmatvec", r, e.cols.data_ptr(), e.vals.data_ptr(),
              r.data_ptr(), y.data_ptr(), e.n_rows, e.K)
    ellw_rmatvec.launches += 1
    return y


ellw_rmatvec.launches = 0


def ellw_matvec_batch_plain(e: DeviceELLW, X):
    return (e.vals[None] * X[:, e.cols.long()]).sum(dim=-1)


def ellw_matvec_batch(e: DeviceELLW, X):
    """K6a.  Y[b] = A X[b] for B vectors with the indices and values read
    once: Y[b, i] = sum_k vals[i, k] X[b, cols[i, k]].

    Replaces ``knpemi_tpu/ops/pallas_ell.py:_make_gather_kernel_batch``
    (via ``ellw_matvec_batch``).  Bound on the H100: bytes — cols, vals, X
    read once, Y written once (``csrc/mg.cu``).  Design: one thread per
    row, B accumulators in registers; more than 8 vectors go through in
    groups of 8.

    X (B, n_cols) -> Y (B, n_rows)."""
    _check_layout(e, X, "X", e.n_cols, batch=True)
    if not X.is_cuda:
        return ellw_matvec_batch_plain(e, X)
    B = X.shape[0]
    Y = torch.empty(B, e.n_rows, dtype=X.dtype, device=X.device)
    for b0 in range(0, B, A.BATCH_MAX):
        nb = min(A.BATCH_MAX, B - b0)
        A._launch("ell_matvec_batch", X, e.cols.data_ptr(), e.vals.data_ptr(),
                  X[b0:].data_ptr(), Y[b0:].data_ptr(), e.n_rows, e.K,
                  e.n_cols, nb)
        ellw_matvec_batch.launches += 1
    return Y


ellw_matvec_batch.launches = 0


def ellw_rmatvec_batch_plain(e: DeviceELLW, R):
    B = R.shape[0]
    Ye = e.vals[None] * R[:, :, None]
    Y = torch.zeros(B, e.n_cols, dtype=R.dtype, device=R.device)
    return Y.index_add_(1, e.cols.reshape(-1).long(), Ye.reshape(B, -1))


def ellw_rmatvec_batch(e: DeviceELLW, R):
    """K6b.  Y[b] = A^T R[b] for B vectors from the layout of A, indices
    and values read once.

    Replaces ``knpemi_tpu/ops/pallas_ell.py:_make_scatter_kernel_batch``
    (via ``ellw_rmatvec_batch``).  Bound on the H100: bytes — cols, vals,
    R read once, Y written once (``csrc/mg.cu``).  Design: one thread per
    row holds its B values of R in registers and adds B atomics per
    nonzero slot; more than 8 vectors go through in groups of 8.

    R (B, n_rows) -> Y (B, n_cols)."""
    _check_layout(e, R, "R", e.n_rows, batch=True)
    if not R.is_cuda:
        return ellw_rmatvec_batch_plain(e, R)
    B = R.shape[0]
    Y = torch.zeros(B, e.n_cols, dtype=R.dtype, device=R.device)
    for b0 in range(0, B, A.BATCH_MAX):
        nb = min(A.BATCH_MAX, B - b0)
        A._launch("ell_rmatvec_batch", R, e.cols.data_ptr(), e.vals.data_ptr(),
                  R[b0:].data_ptr(), Y[b0:].data_ptr(), e.n_rows, e.K,
                  e.n_cols, nb)
        ellw_rmatvec_batch.launches += 1
    return Y


ellw_rmatvec_batch.launches = 0


# (wrapper, plain version); ellw_matvec is K4 of ops/assembly.py
KERNELS = {
    "K5 ellw_rmatvec": (ellw_rmatvec, ellw_rmatvec_plain),
    "K6a ellw_matvec_batch": (ellw_matvec_batch, ellw_matvec_batch_plain),
    "K6b ellw_rmatvec_batch": (ellw_rmatvec_batch, ellw_rmatvec_batch_plain),
}
