"""Sparse operators of the multigrid V-cycle and of the coefficient maps
(K4, K5, K6a, K6b).

Counterpart of ``knpemi_tpu/ops/pallas_ell.py``.  Two halves:

* **host layout** (numpy, copied from the JAX package): :class:`ELLW` and
  :func:`build_ellw` decide, exactly as there, whether a matrix gets this
  layout at all (``None`` when a row needs more than 256 slots or more
  than 10% of the entries fall outside every chunk's window), its chunk
  size ``C``, slot count ``K``, window height ``Wr`` and the far COO
  list.  ``solvers/mg.py`` reads those decisions: a refused layout falls
  back to plain ELL, and the fused post-smooth compares ``NCH*Wr*K*C``
  of two layouts.  ``build_ellw(force_shape=...)`` refills a layout with
  the values of a matrix of the same structure (the hierarchy refresh).
* **device forms** (:class:`DeviceELLW`, from :meth:`ELLW.device`), with
  *global* column ids ``q*128 + lidx`` and the far COO entries **folded
  into the free slots of their rows** (a row has at most K nonzeros,
  ``build_ellw``), so each is exactly A with no second pass:

  - a *sliced* ELL of the nonzeros (``slot_ptr``, ``scol``, ``sval``;
    :func:`sliced_ell`): rows in slices of 32, slice s holding K[s]
    slots per row (its longest row's nonzeros), slot-major inside the
    slice, so that slot k of the slice's 32 rows lies in 32 consecutive
    words — the layout every forward apply reads, K4 on one vector and
    K6a on B, as K1/K11 (``ops/p1op.py``) and K7/K8 (``ops/banded.py``)
    do;
  - the *transposed* form, the CSR of A^T (``trow_ptr``, ``tcol``,
    ``tval``; :func:`transposed_csr`): A's nonzeros grouped by column,
    within a column by ascending row, with ``tgroup`` lanes per row of
    A^T chosen from its mean length — what the restrictions K5 and K6b
    gather from.  A transfer P is frozen for the life of its hierarchy,
    so this form is built once per upload and never refilled.

  A layout gets the forms its applies need (``solvers/mg.py``): the
  sliced one where a cycle applies it forward, the transposed one where
  a cycle restricts through it.  The windows, the (G, 128) group layout
  and the 8-group-aligned ``q`` exist on the TPU to turn a gather into
  one-hot matrix products over a short axis; on Hopper a gather is a
  load, so none of it reaches the device.

The frozen dof -> cell coefficient maps of the step (mean-vertex kappa
per cell, grad(phi) per cell: :func:`cell_mean_ell`,
:func:`cell_gradient_ell`) are built here in the same sliced form and
applied by the same K4.

The four applies, each with a plain PyTorch twin on the same tensors:

=====================  ====  ======================================
``ellw_matvec``        K4    y = A x        one vector, sliced form
``ellw_rmatvec``       K5    y = A^T r      gather, transposed form
``ellw_matvec_batch``  K6a   Y = X A^T      B vectors, sliced form
``ellw_rmatvec_batch`` K6b   Y = R A        B vectors, transposed form
=====================  ====  ======================================

On a CUDA tensor a wrapper launches its kernel (``csrc/mg.cu``) or
raises; the plain twin runs only for CPU tensors.  No kernel here sums
with atomics: each output element is summed by one thread or one group
of lanes in a fixed order, so every launch on the same inputs gives the
same bits.  The order differs from the plain versions', which they
match to ~1e-6 max|y| in float32 and ~1e-15 max|y| in float64.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import assembly as A


# ---------------------------------------------------------------------------
# host layout (numpy), as in knpemi_tpu/ops/pallas_ell.py
# ---------------------------------------------------------------------------
SLICE = 32  # rows per slice of the sliced form: one warp


@dataclasses.dataclass
class DeviceELLW:
    """The device forms of a sparse operator, far entries folded in.
    ``slot_ptr, scol, sval``: the sliced form (:func:`sliced_ell`) that
    K4 and K6a read, None where no forward apply reads it;
    ``trow_ptr, tcol, tval``: the CSR of A^T (:func:`transposed_csr`)
    with ``tgroup`` lanes per row, None where no restriction reads it.
    ``C, K, NCH, Wr``: the host windowed-ELL layout's statics (a
    coefficient map has no windows: ``K`` its widest row, the rest 0)."""

    n_rows: int
    n_cols: int
    C: int = 0
    K: int = 0
    NCH: int = 0
    Wr: int = 0
    slot_ptr: Optional[torch.Tensor] = None  # (NS + 1,) int32
    scol: Optional[torch.Tensor] = None      # (slots,) index
    sval: Optional[torch.Tensor] = None      # (slots,)
    nnz: int = 0                             # nonzeros of the sliced form
    # host copy of slot_ptr: the frozen shape a value refill must keep
    slot_ptr_host: Optional[np.ndarray] = None
    trow_ptr: Optional[torch.Tensor] = None  # (n_cols + 1,) int32
    tcol: Optional[torch.Tensor] = None      # (nnz,) int32: rows of A
    tval: Optional[torch.Tensor] = None      # (nnz,)
    tgroup: int = 0                          # lanes per row of A^T


# lanes per row of A^T


# lanes per row of A^T that the restriction kernels can take
GROUPS = (4, 8, 16, 32)
_INDEX_LIMIT = 1 << 31  # entries an int32 offset can address


def lanes_per_row(mean_row: float) -> int:
    """Lanes that share a row of A^T in K5/K6b: about a quarter of the
    mean row length, as a power of two in :data:`GROUPS` (rows of 30
    entries: 8 lanes, each summing about 4)."""
    if mean_row <= 0:
        return GROUPS[0]
    g = 1 << max(0, int(round(np.log2(mean_row / 4.0))))
    return min(max(g, GROUPS[0]), GROUPS[-1])


def _group_by_row(row_of: np.ndarray, n_rows: int):
    """A CSR's order and row pointers for entries of rows ``row_of``: a
    stable sort by row (a row's entries keep their order) and ``row_ptr``
    int64 (n_rows + 1,)."""
    row_of = np.asarray(row_of, np.int64)
    row_ptr = np.zeros(n_rows + 1, np.int64)
    np.cumsum(np.bincount(row_of, minlength=n_rows), out=row_ptr[1:])
    return np.argsort(row_of, kind="stable"), row_ptr


def _csr_rows(row_ptr: torch.Tensor, n_rows: int) -> torch.Tensor:
    """The row of every entry of a CSR (entries up to ``row_ptr[-1]``)."""
    ptr = row_ptr.long()
    return torch.repeat_interleave(torch.arange(n_rows, device=ptr.device),
                                   ptr[1:] - ptr[:-1])


def _check_csr(row_ptr, col, val, n_rows: int, ref: torch.Tensor, prefix: str = ""):
    """A CSR on ``ref``'s device: int32 ``row_ptr`` of n_rows + 1 entries,
    int32 ``col`` and ``val`` of one length."""
    if row_ptr.dtype != torch.int32 or tuple(row_ptr.shape) != (n_rows + 1,):
        raise TypeError(f"{prefix}row_ptr must be int32 of shape ({n_rows + 1},)")
    A._check(row_ptr, f"{prefix}row_ptr", ref, index=True)
    A._check(col, f"{prefix}col", ref, index=True)
    A._check(val, f"{prefix}val", ref, tuple(col.shape))


def transposed_csr(cols: np.ndarray, vals: np.ndarray, n_cols: int):
    """The CSR of A^T from a row-major ELL of A's nonzeros (``vals !=
    0``): row j of A^T holds the entries of column j of A in ascending
    order of their row (a stable sort of the row-major nonzeros by
    column), the order in which K5/K6b's lanes take them.  Returns
    ``(row_ptr int64 (n_cols + 1,), col int32, val, lanes per row)``;
    raises ``ValueError`` where the nonzeros are more than an int32 can
    address."""
    rows, ks = np.nonzero(vals != 0)
    if len(rows) >= _INDEX_LIMIT:
        raise ValueError(f"{len(rows)} nonzeros: more than an int32 can address")
    order, row_ptr = _group_by_row(cols[rows, ks], n_cols)
    group = lanes_per_row(len(rows) / max(n_cols, 1))
    return (row_ptr, rows[order].astype(np.int32), vals[rows[order], ks[order]], group)


class Sliced(NamedTuple):
    """:func:`sliced_ell`'s host arrays and what a refill dropped."""

    slot_ptr: np.ndarray   # (NS + 1,) int64
    col: np.ndarray        # (slots,) int32
    val: np.ndarray        # (slots,)
    nnz: int               # nonzeros stored
    dropped: int = 0       # nonzeros a refill had no slot for
    dropped_frac: float = 0.0  # their share of the matrix's |value| mass


def sliced_ell(cols: np.ndarray, vals: np.ndarray, n_cols: int,
               slot_ptr: Optional[np.ndarray] = None,
               max_drop_frac: float = 0.0) -> Sliced:
    """The sliced ELL of a row-major ELL's nonzeros (``vals != 0``): per
    slice of 32 rows, K[s] slots per row, slot k of row r at
    ``slot_ptr[r // 32] + 32 k + r % 32``, a row's nonzeros in its slot
    order; padding slots hold value 0 at column min(r, n_cols - 1).

    With ``slot_ptr`` given (a refill of a frozen shape, the hierarchy
    refresh), a row with more nonzeros than its slice holds keeps its
    largest in magnitude, in slot order, and drops the rest, counted in
    ``dropped`` and ``dropped_frac`` (float32 kappa rounding makes and
    unmakes exact zeros of the Galerkin products); raises ``ValueError``
    where they carry more than ``max_drop_frac`` of the matrix's |value|
    mass, or where ``slot_ptr`` does not fit the rows."""
    n, K = cols.shape
    NS = -(-n // SLICE)
    nz = vals != 0
    count = np.zeros(NS * SLICE, np.int64)
    count[:n] = nz.sum(axis=1)
    dropped, frac = 0, 0.0
    if slot_ptr is None:
        width = count.reshape(NS, SLICE).max(axis=1)
        slot_ptr = np.zeros(NS + 1, np.int64)
        np.cumsum(SLICE * width, out=slot_ptr[1:])
        if slot_ptr[-1] >= 1 << 31:
            raise ValueError(f"{slot_ptr[-1]} slots: more than an int32 can address")
    else:
        slot_ptr = np.asarray(slot_ptr, np.int64)
        if slot_ptr.shape != (NS + 1,):
            raise ValueError(f"sliced ELL refill: slot_ptr of shape {slot_ptr.shape} "
                             f"for {NS} slices")
        hold = np.repeat(np.diff(slot_ptr) // SLICE, SLICE)[:n]
        over = np.flatnonzero(count[:n] > hold)
        if len(over):
            # rank each over-full row's nonzeros by magnitude; keep the first
            mag = np.where(nz[over], np.abs(vals[over]), -1.0)
            rank = np.empty_like(mag, np.int64)
            np.put_along_axis(rank, np.argsort(-mag, axis=1, kind="stable"),
                              np.arange(K)[None], axis=1)
            cut = nz[over] & (rank >= hold[over, None])
            dropped = int(cut.sum())
            frac = float(np.abs(vals[over][cut]).sum()) / max(
                float(np.abs(vals).sum()), 1e-300)
            if frac > max_drop_frac:
                raise ValueError(
                    f"sliced ELL refill dropped {dropped} nonzeros, {frac:.2e} of the "
                    f"|A| mass (> {max_drop_frac:.0e}): no slot in their slice, "
                    "sparsity pattern drifted")
            nz = nz.copy()
            nz[over] &= ~cut
    rows, ks = np.nonzero(nz)
    pos = np.cumsum(nz, axis=1)[rows, ks] - 1  # rank of the slot among the row's nonzeros
    slot = slot_ptr[rows // SLICE] + SLICE * pos + rows % SLICE
    total = int(slot_ptr[-1])
    width_of = np.diff(slot_ptr) // SLICE
    pad_row = (np.repeat(np.arange(NS) * SLICE, SLICE * width_of)
               + (np.arange(total) - np.repeat(slot_ptr[:-1], SLICE * width_of)) % SLICE)
    col = np.minimum(pad_row, n_cols - 1).astype(np.int32)
    col[slot] = cols[rows, ks]
    val = np.zeros(total, vals.dtype)
    val[slot] = vals[rows, ks]
    return Sliced(slot_ptr, col, val, int(rows.shape[0]), dropped, frac)


def _upload_sliced(out: DeviceELLW, cols, vals, dtype, device) -> DeviceELLW:
    """Give ``out`` the sliced form of the row-major ELL ``cols, vals``."""
    s = sliced_ell(cols, vals, out.n_cols)
    out.slot_ptr_host, out.nnz = s.slot_ptr, s.nnz
    out.slot_ptr = torch.as_tensor(s.slot_ptr.astype(np.int32), device=device)
    out.scol = torch.as_tensor(s.col, dtype=A.index_dtype(device), device=device)
    out.sval = torch.as_tensor(s.val, dtype=dtype, device=device)
    return out


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

    def device(self, dtype, device, sliced: bool = False,
               transposed: bool = False) -> DeviceELLW:
        """Upload the forms asked for: the sliced ELL (:func:`sliced_ell`)
        and/or the CSR of A^T (:func:`transposed_csr`)."""
        cols, vals = self.to_ell()
        out = DeviceELLW(self.n_rows, self.n_cols, self.C, self.K, self.NCH, self.Wr)
        if sliced:
            _upload_sliced(out, cols, vals, dtype, device)
        if transposed:
            ptr, tcol, tval, out.tgroup = transposed_csr(cols, vals, self.n_cols)
            out.trow_ptr = torch.as_tensor(ptr.astype(np.int32), device=device)
            out.tcol = torch.as_tensor(tcol, dtype=A.index_dtype(device), device=device)
            out.tval = torch.as_tensor(tval, dtype=dtype, device=device)
        return out

    def refill_arrays(self, dev: DeviceELLW, max_drop_frac: float = 0.0):
        """``([(device tensor, host array)], dropped, dropped_frac)``: what
        carries this layout's values into ``dev``, a device form of a
        layout of the same shape (a refreshed hierarchy): the sliced form,
        in its frozen slices (:func:`sliced_ell`: a refreshed nonzero
        without a slot is dropped and counted, more than
        ``max_drop_frac`` of the |A| mass raises ``ValueError``); the
        transposed form belongs to a transfer, frozen with its hierarchy,
        and is never refilled.  Host numpy only."""
        if dev.slot_ptr is None:
            return [], 0, 0.0
        s = sliced_ell(*self.to_ell(), self.n_cols, dev.slot_ptr_host, max_drop_frac)
        return [(dev.scol, s.col), (dev.sval, s.val)], s.dropped, s.dropped_frac


def _pad_pow2(k: int) -> int:
    p = 8
    while p < k:
        p *= 2
    return p


def build_ellw(A, Wr_cap: int = 128, far_frac_max: float = 0.10,
               force_shape: Optional[tuple] = None) -> Optional[ELLW]:
    """Build the windowed-ELL layout of a scipy CSR matrix.

    Returns None when a row needs more than 256 slots or more than
    ``far_frac_max`` of the entries would spill outside every chunk's
    window (the matrix is not bandwidth-ordered enough for this layout).
    ``force_shape`` = (C, K, Wr, G, far_cap) reuses an earlier layout's
    shape, so that a refreshed hierarchy keeps every array's shape; it
    raises ``ValueError`` where the new matrix does not fit (structural
    drift), as the JAX package's does."""
    A = A.tocsr()
    n, m = A.shape
    indptr, indices, data = A.indptr, A.indices, A.data
    row_nnz = np.diff(indptr)
    if force_shape is None:
        K = _pad_pow2(max(1, int(row_nnz.max())))
        if K > 256:
            return None
        C = max(8, 2048 // K)
    else:
        C, K, Wr_f, G_f, far_cap_f = force_shape
        if int(row_nnz.max()) > K:
            raise ValueError(
                f"ellw refill: row nnz {int(row_nnz.max())} exceeds the "
                f"frozen K={K}: sparsity pattern drifted")
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

    if force_shape is None:
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
    else:
        Wr = Wr_f
    qc = starts(Wr)

    inside = (col_grp - qc[chunk] >= 0) & (col_grp - qc[chunk] < Wr)
    n_far = int((~inside).sum())
    if force_shape is None and n_far > far_frac_max * max(1, A.nnz):
        return None

    # compact inside entries per row into slots 0..k-1 (stable per row)
    ins_idx = np.flatnonzero(inside)
    r_ins = rows[ins_idx]
    slot = np.zeros(A.nnz, np.int64)
    csum = np.cumsum(inside)
    row_start_csum = np.concatenate([[0], csum])[indptr[:-1]]
    slot[ins_idx] = csum[ins_idx] - 1 - row_start_csum[r_ins]
    if force_shape is not None and len(ins_idx) and int(slot[ins_idx].max()) >= K:
        raise ValueError("ellw refill: slots exceed frozen K")

    KC = K * C
    lidx = np.zeros((NCH, 1, KC), np.int32)
    vals = np.zeros((NCH, 1, KC), data.dtype)
    ch = chunk[ins_idx]
    c_loc = (rows[ins_idx] % C).astype(np.int64)
    lane = slot[ins_idx] * C + c_loc
    lidx[ch, 0, lane] = (indices[ins_idx] - qc[ch] * 128).astype(np.int32)
    vals[ch, 0, lane] = data[ins_idx]

    far_idx = np.flatnonzero(~inside)
    if force_shape is None:
        far_cap = 0
        while far_cap < n_far:
            far_cap = max(64, far_cap * 2)
    else:
        far_cap = far_cap_f
        if n_far > far_cap:
            raise ValueError(
                f"ellw refill: {n_far} far entries exceed the frozen "
                f"capacity {far_cap}: sparsity pattern drifted")
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
    if force_shape is not None:
        if G > G_f:
            raise ValueError("ellw refill: source padding grew")
        G = G_f
    return ELLW(
        n_rows=n, n_cols=m, C=C, K=K, NCH=NCH, Wr=Wr, G=G,
        q=qc.astype(np.int32), lidx=lidx, vals=vals,
        far_rows=far_rows, far_cols=far_cols, far_vals=far_vals,
        far_cap=far_cap,
    )


# ---------------------------------------------------------------------------
# the frozen dof -> cell coefficient maps of the step
# ---------------------------------------------------------------------------
def _ell_from_cells(weights, cells, n_dofs):
    """Host ELL (cols, vals) of the dof -> cell map with per-slot
    ``weights`` (nc, R, k): row (c, r) is sum_j weights[c, r, j] x[cells[c, j]].
    Built through a scipy CSR (duplicates summed, columns sorted, zeros
    dropped) — the matrix ``pallas_assembly.py::build_interp_ellw``
    freezes; short rows are padded with value 0 at column 0."""
    import scipy.sparse as sp

    nc, R, k = weights.shape
    rows = np.broadcast_to(np.arange(nc * R).reshape(nc, R, 1), weights.shape)
    cols = np.broadcast_to(cells[:, None, :], weights.shape)
    M = sp.coo_matrix(
        (weights.ravel().astype(np.float64), (rows.ravel(), cols.ravel())),
        shape=(nc * R, n_dofs),
    ).tocsr()
    M.eliminate_zeros()
    nnz = np.diff(M.indptr)
    Kw = max(int(nnz.max()) if len(nnz) else 1, 1)
    r = np.repeat(np.arange(M.shape[0]), nnz)
    pos = np.arange(M.nnz) - np.repeat(M.indptr[:-1], nnz)
    ec = np.zeros((M.shape[0], Kw), np.int32)
    ev = np.zeros((M.shape[0], Kw), np.float64)
    ec[r, pos] = M.indices
    ev[r, pos] = M.data
    return ec, ev


def _cell_map(weights, cells, n_dofs, dtype, device) -> DeviceELLW:
    cols, vals = _ell_from_cells(weights, cells, n_dofs)
    out = DeviceELLW(cols.shape[0], n_dofs, K=cols.shape[1])
    return _upload_sliced(out, cols, vals, dtype, device)


def cell_mean_ell(cells, n_dofs, dtype, device) -> DeviceELLW:
    """The map kappa (n,) -> mean-vertex kappa per cell (nc,), in the
    sliced form K4 reads, on ``device`` in ``dtype``."""
    k = cells.shape[1]
    return _cell_map(np.full((cells.shape[0], 1, k), 1.0 / k), cells, n_dofs, dtype,
                     device)


def cell_gradient_ell(cells, grads, n_dofs, dtype, device) -> DeviceELLW:
    """The map phi (n,) -> grad(phi) per cell, rows (c, d) in (nc, dim)
    order, in the sliced form K4 reads."""
    w = np.swapaxes(np.asarray(grads, np.float64), 1, 2)  # (nc, dim, k)
    return _cell_map(w, cells, n_dofs, dtype, device)


# ---------------------------------------------------------------------------
# applies on the device form
# ---------------------------------------------------------------------------
def _check_sliced(e: DeviceELLW, X: torch.Tensor, batch: bool):
    name = "X" if batch else "x"
    A._check_value(X, name)
    if X.dim() != (2 if batch else 1) or X.shape[-1] != e.n_cols or 0 in X.shape:
        want = "(B, n_cols)" if batch else "(n_cols,)"
        raise ValueError(f"{name} has shape {tuple(X.shape)}, expected {want} "
                         f"with n_cols = {e.n_cols}")
    if e.slot_ptr is None:
        raise ValueError("this layout has no sliced form on the device: "
                         "upload it with ELLW.device(..., sliced=True)")
    NS = -(-e.n_rows // SLICE)
    if e.slot_ptr.dtype != torch.int32 or tuple(e.slot_ptr.shape) != (NS + 1,):
        raise TypeError(f"slot_ptr must be int32 of shape ({NS + 1},)")
    A._check(e.slot_ptr, "slot_ptr", X, index=True)
    A._check(e.scol, "scol", X, index=True)
    A._check(e.sval, "sval", X, tuple(e.scol.shape))


def _check_transposed(e: DeviceELLW, R: torch.Tensor, name: str, batch: bool):
    A._check_value(R, name)
    if R.dim() != (2 if batch else 1) or R.shape[-1] != e.n_rows or 0 in R.shape:
        want = f"(B, {e.n_rows})" if batch else f"({e.n_rows},)"
        raise ValueError(f"{name} has shape {tuple(R.shape)}, expected {want}")
    if e.trow_ptr is None:
        raise ValueError("this layout has no transposed form on the device: "
                         "upload it with ELLW.device(..., transposed=True)")
    _check_csr(e.trow_ptr, e.tcol, e.tval, e.n_cols, R, prefix="t")


def _transposed_rows(e: DeviceELLW) -> torch.Tensor:
    """The row of A^T (a column of A) of every entry of the transposed form."""
    return _csr_rows(e.trow_ptr, e.n_cols)


def ellw_rmatvec_plain(e: DeviceELLW, r):
    return ellw_rmatvec_batch_plain(e, r[None])[0]


def ellw_rmatvec(e: DeviceELLW, r):
    """K5.  y = A^T r from the transposed form of A: y[j] = sum over the
    entries s of row j of A^T of tval[s] r[tcol[s]].

    Replaces ``knpemi_tpu/ops/pallas_ell.py:_make_scatter_kernel`` (via
    ``ellw_rmatvec``).  Bound on the H100: bytes — an index and a value
    per nonzero, r read once, y written once (``csrc/mg.cu``).  Design:
    the B = 1 instance of K6b's gather: ``tgroup`` lanes per output row,
    no atomics and no memset, the same bits from every launch.

    r (n_rows,) -> y (n_cols,)."""
    _check_transposed(e, r, "r", batch=False)
    if not r.is_cuda:
        return ellw_rmatvec_plain(e, r)
    y = torch.empty(e.n_cols, dtype=r.dtype, device=r.device)
    A._launch("csr_gather_batch", r, e.trow_ptr.data_ptr(), e.tcol.data_ptr(),
              e.tval.data_ptr(), r.data_ptr(), y.data_ptr(), e.n_cols, e.n_rows, 1,
              e.tgroup)
    ellw_rmatvec.launches += 1
    return y


ellw_rmatvec.launches = 0


def _sliced_rows(e: DeviceELLW) -> torch.Tensor:
    """The row (0 .. 32 NS) of every slot of the sliced form."""
    ptr = e.slot_ptr.long()
    slice_of = torch.repeat_interleave(torch.arange(ptr.shape[0] - 1, device=ptr.device),
                                       ptr[1:] - ptr[:-1])
    return slice_of * SLICE + torch.arange(int(ptr[-1]), device=ptr.device) % SLICE


def ellw_matvec_plain(e: DeviceELLW, x):
    return ellw_matvec_batch_plain(e, x[None])[0]


def ellw_matvec(e: DeviceELLW, x):
    """K4.  y = A x from the sliced form of A: y[r] = sum over the slots s
    of row r of sval[s] x[scol[s]].  A is a multigrid level operator,
    prolongator or A P product, or a frozen coefficient map of the step
    (:func:`cell_mean_ell`, :func:`cell_gradient_ell`).

    Replaces ``knpemi_tpu/ops/pallas_ell.py:_make_gather_kernel`` (via
    ``ellw_matvec``), without its windows, bf16 passes or far-COO spill:
    the GPU gathers exactly.  Bound on the H100: bytes — an index and a
    value per nonzero, x read once, y written once (``csrc/mg.cu``); the
    padding slots of the slices come on top.  Design: one thread per
    row, one warp per 32-row slice: slot k of its rows is one coalesced
    load of columns and one of values, eight slots in flight per thread,
    x through the read-only path, one fused multiply-add per slot in
    slot order, y stored once into ``torch.empty``: no atomics, no
    memset, the same bits every launch.

    x (n_cols,) -> y (n_rows,)."""
    _check_sliced(e, x, batch=False)
    if not x.is_cuda:
        return ellw_matvec_plain(e, x)
    y = torch.empty(e.n_rows, dtype=x.dtype, device=x.device)
    A._launch("sliced_matvec", x, e.slot_ptr.data_ptr(), e.scol.data_ptr(),
              e.sval.data_ptr(), x.data_ptr(), y.data_ptr(), e.n_rows)
    ellw_matvec.launches += 1
    return y


ellw_matvec.launches = 0


def ellw_matvec_batch_plain(e: DeviceELLW, X):
    rows = _sliced_rows(e)
    Y = torch.zeros(X.shape[0], (e.slot_ptr.shape[0] - 1) * SLICE, dtype=X.dtype,
                    device=X.device)
    return Y.index_add_(1, rows, e.sval * X[:, e.scol.long()])[:, : e.n_rows]


def ellw_matvec_batch(e: DeviceELLW, X):
    """K6a.  Y[b] = A X[b] for B vectors from the sliced form, each slot's
    column and value read once for all B: Y[b, r] = sum over the slots s
    of row r of sval[s] X[b, scol[s]].

    Replaces ``knpemi_tpu/ops/pallas_ell.py:_make_gather_kernel_batch``
    (via ``ellw_matvec_batch``).  Bound on the H100: bytes — an index and
    a value per nonzero, X read once, Y written once (``csrc/mg.cu``);
    the padding slots come on top.  Design: one warp per 32-row slice,
    slot k of its 32 rows one coalesced load of columns and one of values,
    four slots in flight per thread, B accumulators, X read through the
    read-only path; more than 8 vectors go through in groups of 8.

    X (B, n_cols) -> Y (B, n_rows)."""
    _check_sliced(e, X, batch=True)
    if not X.is_cuda:
        return ellw_matvec_batch_plain(e, X)
    B = X.shape[0]
    Y = torch.empty(B, e.n_rows, dtype=X.dtype, device=X.device)
    for b0 in range(0, B, A.BATCH_MAX):
        nb = min(A.BATCH_MAX, B - b0)
        A._launch("sliced_matvec_batch", X, e.slot_ptr.data_ptr(), e.scol.data_ptr(),
                  e.sval.data_ptr(), X[b0:].data_ptr(), Y[b0:].data_ptr(), e.n_rows,
                  e.n_cols, nb)
        ellw_matvec_batch.launches += 1
    return Y


ellw_matvec_batch.launches = 0


def ellw_rmatvec_batch_plain(e: DeviceELLW, R):
    """Each row of A^T summed over its entries in their stored order."""
    Y = torch.zeros(R.shape[0], e.n_cols, dtype=R.dtype, device=R.device)
    return Y.index_add_(1, _transposed_rows(e), e.tval * R[:, e.tcol.long()])


def ellw_rmatvec_batch(e: DeviceELLW, R):
    """K6b.  Y[b] = A^T R[b] for B vectors from the transposed form of A,
    each entry's index and value read once for all B.

    Replaces ``knpemi_tpu/ops/pallas_ell.py:_make_scatter_kernel_batch``
    (via ``ellw_rmatvec_batch``).  Bound on the H100: bytes — an index
    and a value per nonzero, R read once, Y written once
    (``csrc/mg.cu``).  Design: a CSR gather from A^T, built once per
    hierarchy (P is frozen): ``tgroup`` lanes own a row, stride over its
    entries with coalesced loads, keep B sums each and reduce them by
    warp shuffles in a fixed order; one plain store per output, so no
    atomics and no memset (Y is ``torch.empty``).  More than 8 vectors
    go through in groups of 8.

    R (B, n_rows) -> Y (B, n_cols)."""
    _check_transposed(e, R, "R", batch=True)
    if not R.is_cuda:
        return ellw_rmatvec_batch_plain(e, R)
    B = R.shape[0]
    Y = torch.empty(B, e.n_cols, dtype=R.dtype, device=R.device)
    for b0 in range(0, B, A.BATCH_MAX):
        nb = min(A.BATCH_MAX, B - b0)
        A._launch("csr_gather_batch", R, e.trow_ptr.data_ptr(), e.tcol.data_ptr(),
                  e.tval.data_ptr(), R[b0:].data_ptr(), Y[b0:].data_ptr(), e.n_cols,
                  e.n_rows, nb, e.tgroup)
        ellw_rmatvec_batch.launches += 1
    return Y


ellw_rmatvec_batch.launches = 0


# ---------------------------------------------------------------------------
# the far remainder of a block-banded operator (solvers/mg.py::_banded_mv)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class DeviceCSR:
    """A sparse remainder F (``n_rows`` x ``n_cols``) as a CSR by row on
    the device: ``row_ptr`` (n_rows + 1,) int32, ``col`` int32 and ``val``
    of a fixed capacity (entries past ``row_ptr[-1]``: column 0, value 0,
    never read), ``group`` lanes per row; :func:`csr_add` adds F X."""

    n_rows: int
    n_cols: int
    row_ptr: torch.Tensor
    col: torch.Tensor
    val: torch.Tensor
    group: int


def far_csr(rows, cols, vals, n_rows: int, capacity: int):
    """The CSR by row of a COO list's nonzeros (``vals != 0``; a refill
    pads its list with zeros), a row's entries in their listed order (a
    stable sort by row): ``(row_ptr int32 (n_rows + 1,), col int32
    (capacity,), val (capacity,))``, the entries past ``row_ptr[-1]`` at
    column 0 with value 0.  Raises ``ValueError`` where the nonzeros
    outnumber ``capacity``."""
    rows, cols, vals = np.asarray(rows), np.asarray(cols), np.asarray(vals)
    nz = np.flatnonzero(vals != 0)
    if len(nz) > capacity:
        raise ValueError(f"{len(nz)} far entries for a capacity of {capacity}")
    order, row_ptr = _group_by_row(rows[nz], n_rows)
    order = nz[order]
    col = np.zeros(capacity, np.int32)
    val = np.zeros(capacity, vals.dtype)
    col[:len(order)] = cols[order]
    val[:len(order)] = vals[order]
    return row_ptr.astype(np.int32), col, val


def device_far(rows, cols, vals, n_rows: int, n_cols: int, dtype, device) -> DeviceCSR:
    """:func:`far_csr` of a far COO list on ``device``, its capacity the
    list's length; the lanes per row from the mean length of the rows
    that have entries, frozen with the upload (a refill keeps them)."""
    ptr, col, val = far_csr(rows, cols, vals, n_rows, len(rows))
    counts = np.diff(ptr)
    live = int((counts > 0).sum())
    return DeviceCSR(
        n_rows, n_cols, torch.as_tensor(ptr, device=device),
        torch.as_tensor(col, device=device),
        torch.as_tensor(val, dtype=dtype, device=device),
        lanes_per_row(counts.sum() / max(live, 1)))


def _check_csr_add(f: DeviceCSR, X: torch.Tensor, Y: torch.Tensor):
    A._check_value(X, "X")
    if X.dim() not in (1, 2) or X.shape[-1] != f.n_cols or 0 in X.shape:
        raise ValueError(f"X has shape {tuple(X.shape)}, expected (n_cols,) or "
                         f"(B, n_cols) with n_cols = {f.n_cols}")
    A._check(X, "X", X)
    A._check(Y, "Y", X, X.shape[:-1] + (f.n_rows,))
    _check_csr(f.row_ptr, f.col, f.val, f.n_rows, X)
    if f.group not in GROUPS:
        raise ValueError(f"group = {f.group}: one of {GROUPS} is needed")


def csr_add_plain(f: DeviceCSR, X, Y):
    """Y += F X, each row's entries added to Y in turn, in their stored
    order (``index_add_``, in order on the CPU)."""
    n = int(f.row_ptr[-1])
    return Y.index_add_(-1, _csr_rows(f.row_ptr, f.n_rows),
                        f.val[:n] * X[..., f.col[:n].long()])


def csr_add(f: DeviceCSR, X, Y):
    """Y += F X for a far remainder F (:class:`DeviceCSR`), in place: X
    (n_cols,) or (B, n_cols), Y (n_rows,) or (B, n_rows).

    The far-COO remainder of a block-banded multigrid operator, which the
    JAX package adds by a scatter (``knpemi_tpu/solvers/mg.py:1038``,
    :1075) outside any Pallas kernel.  It runs on K5/K6b's kernel
    (``csrc/mg.cu::csr_gather_batch_kernel``, its ``ADD`` form) and counts
    its launches under theirs: ``ellw_rmatvec`` for one vector,
    ``ellw_rmatvec_batch`` for a batch (groups of 8).  Each row's entries
    are summed in a fixed order (``group`` lanes, fused multiply-adds, a
    fixed shuffle tree, as K5) and added to Y by one plain load and
    store: no atomics, the same bits every launch.  Each launch also
    adds one to ``csr_add.launches``, the far remainder's share of
    K5's and K6b's counts."""
    _check_csr_add(f, X, Y)
    if not X.is_cuda:
        return csr_add_plain(f, X, Y)
    batch = X.dim() == 2
    B = X.shape[0] if batch else 1
    for b0 in range(0, B, A.BATCH_MAX):
        nb = min(A.BATCH_MAX, B - b0)
        A._launch("csr_gather_add_batch", X, f.row_ptr.data_ptr(), f.col.data_ptr(),
                  f.val.data_ptr(), X[b0:].data_ptr() if batch else X.data_ptr(),
                  Y[b0:].data_ptr() if batch else Y.data_ptr(), f.n_rows, f.n_cols, nb,
                  f.group)
        if batch:
            ellw_rmatvec_batch.launches += 1
        else:
            ellw_rmatvec.launches += 1
        csr_add.launches += 1
    return Y


csr_add.launches = 0


# (wrapper, plain version) of this module's kernels
KERNELS = {
    "K4 ellw_matvec": (ellw_matvec, ellw_matvec_plain),
    "K5 ellw_rmatvec": (ellw_rmatvec, ellw_rmatvec_plain),
    "K6a ellw_matvec_batch": (ellw_matvec_batch, ellw_matvec_batch_plain),
    "K6b ellw_rmatvec_batch": (ellw_rmatvec_batch, ellw_rmatvec_batch_plain),
}
