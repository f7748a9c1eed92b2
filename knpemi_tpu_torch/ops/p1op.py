"""The assembled P1 operator of a subdomain or a membrane: K1, K2, K3 and
K11 as row-parallel applies of values filled once per solve (K1f, K11f)
or summed once at setup (K2's surface mass).

Every cell operator of one subdomain -- the EMI weighted stiffness, the
unit stiffness of the EMI right-hand side, the P1 mass and each solved
ion's KNP operator (1/dt) M + D_b K + z_b psi D_b Drift(grad phi) --
lives on one sparsity pattern, the P1 graph of the cells.  :class:`P1Operator` holds
that pattern once per subdomain (``EMISystem`` and ``KNPSystem`` share
it), and once per membrane on its facets (:func:`membrane_operators`:
the pattern of the surface mass M_Gamma, whose incidence list the facet
scatter K10 of :mod:`.assembly` walks), built on the host in numpy:

* ``slot_ptr``, ``col``: a sliced ELL.  The rows are cut into slices of
  32; slice s stores K[s] slots per row (its longest row), ordered slot,
  then row, so that a warp reads slot k of its 32 rows as 32 consecutive
  words: row r's slot k is ``slot_ptr[r // 32] + 32 k + r % 32``.  A
  row's columns are ascending; padding slots hold column = the row
  (n - 1 for the rows past n of the last slice) and carry value 0.
* ``pos`` (nc, k, k) uint8: for every cell c and vertex pair (i, j), the
  slot k of column v_j within row v_i -- with ``cells`` and ``slot_ptr``
  it locates the pair's slot, in 16 bytes a tetrahedron.
* ``inc_ptr``, ``inc``: the incidence list, every row's (cell c, local
  vertex i) pairs with ``cells[c, i]`` = the row, c ascending, packed as
  ``c << 2 | i`` in the same 32-row sliced order (slice s holds L[s]
  entries a row, entry-major, then row; padding -1), so that the fills
  K1f and K11f walk it one thread per row and write each slot once.
* values, one per slot: constant ones summed once on the host in
  float64 from per-pair values (:meth:`P1Operator.assemble`; the systems
  that own the physics give it the COO helpers' element matrices), and
  per-solve ones filled on the device by K1f (:func:`emi_fill`) and
  K11f (:func:`drift_fill`).

**The row-sum form.**  A row's diagonal slot holds the row's SUM, not
the diagonal entry, and the apply computes

    y_i = V_ii x_i + sum_{j != i} V_ij (x_j - x_i),

which equals sum_j A_ij x_j.  A stiffness has zero row sums, so its
diagonal slots hold an exact 0 and a constant x gives y = 0 exactly,
whatever the rounding of the stored entries; the differences x_j - x_i
of a nearly uniform field (concentrations, potentials at rest) are
exact in floating point.  Summing A_ij x_j instead leaves
eps * sum_j |A_ij| |x| of noise, which in float32 moved the resting
EMI solve off equilibrium and the per-ion KNP solution by ~1e-3 from
the batched one.  :meth:`P1Operator.scipy_csr` turns the form back into
the matrix.

The JAX package applies these operators element by element inside its
Pallas kernels, and prepares per-solve cell coefficients outside them
(``knpemi_tpu/ops/pallas_assembly.py:prepare_emi_weight``,
``prepare_knp_drift``).  On the H100 the element-by-element form reads
68-80 bytes of geometry a cell (3.3-3.8x the bytes of the assembled
operator: a dof has 5-6 cells) and adds k results atomically; the
assembled form reads each slot once, four bytes of column and one value
per stream, and writes each row once without atomics.  The geometry is
read once per solve, by the fills.

On a CUDA tensor a wrapper launches its kernel (``csrc/cells.cu``) or
raises; the plain twin runs only for CPU tensors.  No kernel here uses
atomics: the fills add each row's incidences in the list's order (c
ascending) in shared memory and store every slot once, the applies sum
each row's slots in slot order with fused multiply-adds, so two
launches give the same bits; the plain versions sum in the same orders
with ``index_add_`` and agree to a few ulps (fused multiply-adds).
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import scipy.sparse as sp
import torch

from . import assembly as A

SLICE = 32  # rows per slice: one warp


class P1Operator:
    """The P1-graph pattern of one subdomain's cells as a sliced ELL, and
    the slot of every cell's vertex pair.

    Device tensors: ``slot_ptr`` (NS + 1,) int32, NS = ceil(n / 32);
    ``col`` (slots,) index; ``cells`` (nc, k) index; ``pos`` (nc, k, k)
    uint8; ``inc_ptr`` (NS + 1,) int32 and ``inc`` int32, the incidence
    list (:meth:`_incidence`).  Host: ``diag_slot`` (n,) int64, the slot
    of every row's diagonal, ``kmax`` the widest slice's slots a row,
    ``incidence_seconds`` the time the list took, and the arrays
    :meth:`assemble` and :meth:`scipy_csr` need."""

    def __init__(self, cells, n: int, device, rows=None):
        """``rows`` = (lo, hi): the operator of the rows lo .. hi - 1 alone
        (a rank's owned rows, ``parallel/``): the other rows of the n
        have no slots and apply to 0, and ``cells`` must hold every cell
        that touches an owned row; each owned row keeps the slots, the
        column order and so the sums it has in the whole operator."""
        cells = np.asarray(cells)
        nc, k = cells.shape
        if k > 4 or nc >= 1 << 29:
            raise ValueError(f"{nc} cells of {k} vertices: the incidence list packs "
                             "c << 2 | i in an int32 (k <= 4, nc < 2^29)")
        self.n, self.k, self.device = int(n), int(k), torch.device(device)
        self.lo, self.hi = (0, self.n) if rows is None else (int(rows[0]), int(rows[1]))
        if not 0 <= self.lo <= self.hi <= self.n:
            raise ValueError(f"rows {rows} do not lie in [0, {n}]")
        # every (v_i, v_j) pair of every cell as one int64 key, row-major
        r = np.repeat(cells, k, axis=1).reshape(-1).astype(np.int64)
        c = np.tile(cells, (1, k)).reshape(-1).astype(np.int64)
        key = r * n + c
        own = None
        if rows is not None:
            own = (r >= self.lo) & (r < self.hi)
            key = key[own]
        keys, inverse = np.unique(key, return_inverse=True)
        rows, cols = keys // n, keys % n
        count = np.bincount(rows, minlength=n)
        indptr = np.zeros(n + 1, np.int64)
        np.cumsum(count, out=indptr[1:])
        if own is None:
            pos = inverse.reshape(-1) - indptr[r]
        else:
            # the pairs of rows not owned have no slot: position 0, never read
            pos = np.zeros(r.shape[0], np.int64)
            pos[own] = inverse.reshape(-1) - indptr[r[own]]
        if pos.size and pos.max() > 255:
            raise ValueError(f"a row has {count.max()} columns: more than a "
                             "uint8 position addresses")
        NS = -(-n // SLICE)
        K = np.zeros(NS * SLICE, np.int64)
        K[:n] = count
        K = K.reshape(NS, SLICE).max(axis=1)
        slot_ptr = np.zeros(NS + 1, np.int64)
        np.cumsum(SLICE * K, out=slot_ptr[1:])
        if slot_ptr[-1] >= 1 << 31:
            raise ValueError(f"{slot_ptr[-1]} slots: more than an int32 can address")
        self.nnz, self.slots = int(keys.shape[0]), int(slot_ptr[-1])
        self._csr_cols, self._indptr = cols.astype(np.int32), indptr
        self._count, self._slot_ptr = count, slot_ptr
        self._cells, self._pos = cells, pos.astype(np.uint8).reshape(nc, k, k)
        sl = self.csr_slots()
        # the diagonal slot of every row, rows ascending
        on_diag = rows == cols
        if int(on_diag.sum()) != self.hi - self.lo:
            raise ValueError("a dof lies in no cell")
        self.diag_slot = sl[on_diag]
        # padding slots: column = the row, clipped to the last dof
        col = np.minimum(self._slot_rows_host(), n - 1)
        col[sl] = cols
        idt = A.index_dtype(device)
        self.slot_ptr = torch.as_tensor(slot_ptr.astype(np.int32), device=device)
        self.col = torch.as_tensor(col, dtype=idt, device=device)
        self.cells = torch.as_tensor(cells, dtype=idt, device=device)
        self.pos = torch.as_tensor(self._pos, device=device)
        self.kmax = int(K.max())
        t0 = time.perf_counter()
        inc_ptr, inc = self._incidence()
        self.inc_ptr = torch.as_tensor(inc_ptr, device=device)
        self.inc = torch.as_tensor(inc, device=device)
        self.incidence_seconds = time.perf_counter() - t0
        self._plain_cache = {}
        self._cell_rows = None  # scatter_cells' gather index

    def _incidence(self):
        """The (cell c, local vertex i) pairs of every row, c ascending,
        packed as ``c << 2 | i`` in the pattern's 32-row slices: slice s
        holds L[s] entries a row (its longest list), entry e of row r at
        ``inc_ptr[r // 32] + 32 e + r % 32``, padding -1.  (inc_ptr, inc)
        as int32 numpy arrays."""
        n, (nc, k) = self.n, self._cells.shape
        flat = self._cells.reshape(-1).astype(np.int64)  # entry c k + i
        order = np.argsort(flat, kind="stable")  # by row, then c ascending
        if (self.lo, self.hi) != (0, n):
            # the owned rows' entries alone
            order = order[(flat[order] >= self.lo) & (flat[order] < self.hi)]
        deg = np.bincount(flat[order], minlength=n)
        NS = self._slot_ptr.shape[0] - 1
        L = np.zeros(NS * SLICE, np.int64)
        L[:n] = deg
        L = L.reshape(NS, SLICE).max(axis=1)
        inc_ptr = np.zeros(NS + 1, np.int64)
        np.cumsum(SLICE * L, out=inc_ptr[1:])
        if inc_ptr[-1] >= 1 << 31:
            raise ValueError(f"{inc_ptr[-1]} incidence slots: more than an int32 addresses")
        start = np.zeros(n + 1, np.int64)
        np.cumsum(deg, out=start[1:])
        r = flat[order]
        e = np.arange(order.shape[0]) - start[r]
        inc = np.full(inc_ptr[-1], -1, np.int32)
        inc[inc_ptr[r // SLICE] + SLICE * e + r % SLICE] = \
            ((order // k) << 2 | order % k).astype(np.int32)
        return inc_ptr.astype(np.int32), inc

    # -- host side ------------------------------------------------------
    def _slot_rows_host(self) -> np.ndarray:
        """The row (0 .. 32 NS) of every slot."""
        width = np.diff(self._slot_ptr)
        start = np.repeat(self._slot_ptr[:-1], width)
        base = np.repeat(np.arange(width.shape[0]) * SLICE, width)
        return base + (np.arange(self.slots) - start) % SLICE

    def csr_slots(self) -> np.ndarray:
        """The slot of every nonzero of the operator in CSR order (rows
        ascending, columns ascending within a row): (nnz,) int64."""
        r = np.repeat(np.arange(self.n), self._count)
        p = np.arange(self.nnz) - np.repeat(self._indptr[:-1], self._count)
        return self._slot_ptr[r // SLICE] + SLICE * p + r % SLICE

    def pair_slots_host(self, off_diagonal: bool = False) -> np.ndarray:
        """The slot of every cell's vertex pair (i, j): (nc, k, k) int64,
        or (nc, k (k - 1)) for the pairs i != j in row-major order."""
        k = self.k
        ii, jj = np.nonzero(~np.eye(k, dtype=bool) if off_diagonal else np.ones((k, k), bool))
        v = self._cells[:, ii].astype(np.int64)
        s = self._slot_ptr[v // SLICE] + SLICE * self._pos[:, ii, jj].astype(np.int64) + v % SLICE
        return s if off_diagonal else s.reshape(-1, k, k)

    def assemble(self, *pair_vals) -> np.ndarray:
        """Constant slot values in the row-sum form, on the host in float64:
        for each per-pair array (nc, k, k) -- row v_i, column v_j, the order
        of the COO helpers of ``solvers/direct.py`` -- its off-diagonal
        values summed into their slots, (len(pair_vals), slots).  The
        diagonal slots hold 0, a stiffness's row sums; the caller writes
        any other row sums at :attr:`diag_slot`.  Whole operators only
        (a rank's rows take theirs from the whole one: ``parallel/``)."""
        if (self.lo, self.hi) != (0, self.n):
            raise ValueError("assemble needs the whole operator, not rows "
                             f"{self.lo} .. {self.hi - 1}")
        off = ~np.eye(self.k, dtype=bool)  # the order of pair_slots_host's pairs
        slots = self.pair_slots_host(off_diagonal=True).reshape(-1)
        return np.stack([np.bincount(slots, minlength=self.slots,
                                     weights=np.asarray(pv, np.float64)[:, off].reshape(-1))
                         for pv in pair_vals])

    def assemble_row_sums(self, pair_vals) -> np.ndarray:
        """:meth:`assemble` of one per-pair array (nc, k, k) with each row's
        sum at its diagonal slot: the row-sum form of an operator whose
        rows do not sum to 0 (a mass, a drift), (slots,) float64."""
        pair_vals = np.asarray(pair_vals, np.float64)
        v = self.assemble(pair_vals)[0]
        v[self.diag_slot] = np.bincount(self._cells.reshape(-1),
                                        weights=pair_vals.sum(axis=2).reshape(-1),
                                        minlength=self.n)
        return v

    def scatter_cells(self, V: torch.Tensor) -> torch.Tensor:
        """Per-cell vertex values V (..., nc, k) summed into their rows, (...,
        n): each row's (cell, vertex) entries in the incidence list's order
        (cells ascending), by a padded gather and a row sum, so that the
        card gives the same bits every call (``index_add_`` adds there with
        atomics in a varying order).  Plain PyTorch, for the Jacobi
        diagonals of the solves without a hierarchy; the gather index, (n,
        widest row) int64, is built on first use."""
        if self._cell_rows is None:
            flat = self._cells.reshape(-1).astype(np.int64)
            order = np.argsort(flat, kind="stable")
            deg = np.bincount(flat, minlength=self.n)
            start = np.zeros(self.n + 1, np.int64)
            np.cumsum(deg, out=start[1:])
            r = flat[order]
            idx = np.full((self.n, int(deg.max())), flat.size, np.int64)
            idx[r, np.arange(flat.size) - start[r]] = order
            self._cell_rows = torch.as_tensor(idx, device=self.device)
        v = V.reshape(V.shape[:-2] + (-1,))
        v = torch.cat([v, v.new_zeros(v.shape[:-1] + (1,))], dim=-1)
        return v[..., self._cell_rows].sum(dim=-1)

    def scipy_csr(self, vals) -> sp.csr_matrix:
        """The matrix whose row-sum form is ``vals`` (slots,), in float64 on
        the host (explicit zeros of the pattern kept): each diagonal entry
        is the row's sum less its off-diagonal entries."""
        v = np.asarray(torch.as_tensor(vals).detach().cpu(), np.float64)
        rows = np.repeat(np.arange(self.n), self._count)
        data = v[self.csr_slots()]
        diag = self._csr_cols == rows
        off_sum = np.bincount(rows[~diag], weights=data[~diag], minlength=self.n)
        # one diagonal per (owned) row, rows ascending
        data[diag] = v[self.diag_slot] - off_sum[rows[diag]]
        return sp.csr_matrix((data, self._csr_cols, self._indptr), shape=(self.n, self.n))

    @property
    def nbytes(self) -> int:
        """Device bytes of the pattern (slot_ptr, col, cells, pos) and of
        the incidence list (inc_ptr, inc)."""
        return sum(t.numel() * t.element_size() for t in
                   (self.slot_ptr, self.col, self.cells, self.pos, self.inc_ptr, self.inc))

    # -- for the plain versions -------------------------------------------
    def _plain(self, key: str):
        """From the device tensors, as int64: ``slot_rows`` (slots,), the
        row of every slot; ``incidence`` (c, i, row) of every entry of
        the incidence list in its order, padding left out.
        Kept only for a CPU operator (on the card the kernels need
        neither)."""
        t = self._plain_cache.get(key)
        if t is None:
            ptr = self.slot_ptr.long() if key == "slot_rows" else self.inc_ptr.long()
            size = int(ptr[-1])
            slice_of = torch.repeat_interleave(
                torch.arange(ptr.shape[0] - 1, device=ptr.device), ptr[1:] - ptr[:-1])
            rows = slice_of * SLICE + torch.arange(size, device=ptr.device) % SLICE
            if key == "slot_rows":
                t = rows
            else:
                at = torch.nonzero(self.inc >= 0).reshape(-1)
                ent = self.inc.long()[at]
                t = (ent >> 2, ent & 3, rows[at])
            if self.device.type == "cpu":
                self._plain_cache[key] = t
        return t


def p1_operators(geom, device) -> Dict[int, P1Operator]:
    """{subdomain tag: P1Operator} of a geometry."""
    return {t: P1Operator(s.cells, s.n_dofs, device)
            for t, s in geom.subdomains.items()}


def membrane_operators(geom, device) -> Dict[int, P1Operator]:
    """{membrane tag: P1Operator} of a geometry: the P1 graph of each
    membrane's facets (edges in 2-D, triangles in 3-D) in membrane
    numbering, the pattern of its surface mass M_Gamma (K2) and, in its
    incidence list, the row structure of the facet scatter K10."""
    return {m: P1Operator(sp.facet_dofs, sp.n_dofs, device)
            for m, sp in geom.membranes.items()}


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------
def _check_op(op: P1Operator, like: torch.Tensor):
    if op.col.device != like.device:
        raise ValueError(f"the operator is on {op.col.device}, the vector on {like.device}")
    if op.slot_ptr.dtype != torch.int32 or op.pos.dtype != torch.uint8:
        raise TypeError("slot_ptr must be int32 and pos uint8")
    A._check(op.col, "col", like, (op.slots,), index=True)
    A._check(op.cells, "cells", like, index=True)


def _check_apply(op: P1Operator, x, vals, name="vals"):
    A._check_value(x, "x")
    if x.dim() != 1 or x.shape[0] != op.n:
        raise ValueError(f"x has shape {tuple(x.shape)}, expected ({op.n},)")
    _check_op(op, x)
    A._check(vals, name, x, (op.slots,))


def _check_fill(op: P1Operator, grads, *cellwise):
    A._check_value(grads, "grads")
    nc, k = op.cells.shape
    dim = grads.shape[-1]
    A._check_mesh(k, dim)
    _check_op(op, grads)
    A._check_incidence(op, grads)
    A._check(grads, "grads", grads, (nc, k, dim))
    if grads.is_cuda and grads.data_ptr() % 16:
        raise ValueError("grads must be 16-byte aligned: the fills load a cell's "
                         "gradients as vectors")
    for name, t, shape in cellwise:
        A._check(t, name, grads, shape)
    return nc, k, dim


# ---------------------------------------------------------------------------
# K1 / K11: the apply
# ---------------------------------------------------------------------------
def _apply_plain(op: P1Operator, x, V1, a: float, V2=None, b: float = 0.0):
    """a (V1 x) + b (V2 x) in the row-sum form: each slot's value times
    x_i (the diagonal slot) or x_j - x_i (the others), summed per row."""
    rows, col = op._plain("slot_rows"), op.col.long()
    xr = x[rows.clamp(max=op.n - 1)]  # the padding rows past n hold zeros
    xg = torch.where(col == rows, xr, x[col] - xr)
    n_pad = (op.slot_ptr.shape[0] - 1) * SLICE
    y = a * torch.zeros(n_pad, dtype=x.dtype, device=x.device).index_add_(0, rows, V1 * xg)
    if V2 is not None:
        y = y + b * torch.zeros_like(y).index_add_(0, rows, V2 * xg)
    return y[: op.n]


def _launch_apply(x, op, V1, a, V2, b):
    y = torch.empty_like(x)
    A._launch("p1_apply", x, op.slot_ptr.data_ptr(), op.col.data_ptr(),
              V1.data_ptr(), None if V2 is None else V2.data_ptr(), x.data_ptr(),
              y.data_ptr(), float(a), float(b), op.n)
    return y


def emi_stiffness_plain(x, op: P1Operator, vals, scale: float = 1.0):
    return _apply_plain(op, x, vals, float(scale))


def emi_stiffness(x, op: P1Operator, vals, scale: float = 1.0):
    """K1.  y = scale * (V x) for the P1 operator ``op`` with slot values
    ``vals`` in the row-sum form: the EMI weighted stiffness with the
    values :func:`emi_fill` made for this solve, and (``scale`` -1) the
    right-hand side's unit-weight stiffness (``EMISystem``'s ``kst``).

    Replaces ``knpemi_tpu/ops/pallas_assembly.py:_make_emi_kernel`` (via
    ``emi_stiffness_blocked``) together with :func:`emi_fill`.
    Bound on the H100: bytes — each slot's column and value read once, x
    read once, y written once (``csrc/cells.cu``).  Design: one thread
    per row; a warp streams slot k of its 32 rows in one coalesced load,
    eight slots in flight per thread, x gathered through the read-only
    path (it lives in L2), no atomics.

    x (n,), op, vals (slots,) -> y (n,)."""
    _check_apply(op, x, vals)
    if not x.is_cuda:
        return emi_stiffness_plain(x, op, vals, scale)
    y = _launch_apply(x, op, vals, scale, None, 0.0)
    emi_stiffness.launches += 1
    return y


emi_stiffness.launches = 0


def knp_apply_plain(x, op: P1Operator, P, Dr, zpsiD: float):
    return _apply_plain(op, x, P, 1.0, Dr, float(zpsiD))


def knp_apply(x, op: P1Operator, P, Dr, zpsiD: float):
    """K11.  y = P x + zpsiD (Dr x) for ONE ion: P = dt_inv M + D K, the
    ion's constant values (``systems/knp.py::ion_operator_values``), and
    Dr the drift values along grad(phi) of this solve (:func:`drift_fill`),
    which the ions of a subdomain share; ``zpsiD`` = z psi D arrives by
    value (a Python float: no coefficient tensor, no upload per ion).  The
    per-ion KNP solve applies it once per GMRES iteration of every
    (subdomain, ion) block.

    Replaces ``knpemi_tpu/ops/pallas_assembly.py:_make_knp_kernel`` (via
    ``knp_apply_blocked``, whose scalars sit in SMEM) together with
    :func:`drift_fill`.  Bound on the H100: bytes — each slot's column
    and two values read once, x read once, y written once
    (``csrc/cells.cu``).  Design: :func:`emi_stiffness`'s kernel with a
    second value stream and two accumulators, four slots in flight per
    thread (32 registers: the whole grid stays resident).

    x (n,), op, P (slots,), Dr (slots,) -> y (n,)."""
    _check_apply(op, x, P, "P")
    A._check(Dr, "Dr", x, (op.slots,))
    if not x.is_cuda:
        return knp_apply_plain(x, op, P, Dr, zpsiD)
    y = _launch_apply(x, op, P, 1.0, Dr, zpsiD)
    knp_apply.launches += 1
    return y


knp_apply.launches = 0


# ---------------------------------------------------------------------------
# K2: the membrane surface mass
# ---------------------------------------------------------------------------
def surface_mass_plain(x, op: P1Operator, vals, scale: float = 1.0):
    return _apply_plain(op, x, vals, float(scale))


def surface_mass(x, op: P1Operator, vals, scale: float = 1.0):
    """K2.  y = scale * (M_Gamma x) in membrane numbering: the surface
    mass of one membrane on its P1 operator (:func:`membrane_operators`),
    ``vals`` = :func:`mass_values` of its facets and areas, area (1 +
    delta_ij) / (k (k + 1)) per facet pair, summed once at setup in the
    row-sum form; ``scale`` = C_phi, the EMI coupling's factor.

    Replaces ``knpemi_tpu/ops/pallas_assembly.py:_make_facet_mass_kernel``
    (via ``facet_mass_blocked``).  Bound on the H100: bytes — each of
    M_Gamma's nonzeros (a column and a value) read once, x read once, y
    written once (``csrc/cells.cu``).  Design: K1's apply
    (:func:`emi_stiffness`) on the membrane's operator: one thread per
    row, slots streamed coalesced, the scale applied in registers, y
    written once into ``torch.empty``: no atomics, no memset, the same
    bits every launch.  (The facet form, one thread per facet adding k
    results with atomics into a zeroed y, reads fewer bytes and waits on
    one dependent load fewer, so its kernel alone is faster; with the
    zeroing kernel and the separate C_phi multiply it needs, the two cost
    about the same device time a call: PERF.md.)

    x (n_mem,), op, vals (slots,) -> y (n_mem,)."""
    _check_apply(op, x, vals)
    if not x.is_cuda:
        return surface_mass_plain(x, op, vals, scale)
    y = _launch_apply(x, op, vals, scale, None, 0.0)
    surface_mass.launches += 1
    return y


surface_mass.launches = 0


# ---------------------------------------------------------------------------
# K3: the batched KNP apply
# ---------------------------------------------------------------------------
def mass_values(op: P1Operator, cells, vols, dtype) -> torch.Tensor:
    """The unit P1 mass on ``op`` in the row-sum form (the diagonal slot
    holds the row's sum, vol/k per cell vertex), summed on the host in
    float64 from the COO helper's element matrices and cast to
    ``dtype``: K3's first value stream, and with a membrane's facets and
    areas K2's M_Gamma (the facet mass has the same element matrix).
    ``cells`` are the cells ``op`` was built from."""
    from ..solvers import direct

    Me = direct._mass_coo(np.asarray(cells), np.asarray(vols, np.float64))[2]
    return torch.as_tensor(op.assemble_row_sums(Me), dtype=dtype, device=op.device)


def _check_batch(op: P1Operator, X, coef, M, Kst, Dr):
    A._check_value(X, "X")
    if X.dim() != 2 or X.shape[1] != op.n or X.shape[0] == 0:
        raise ValueError(f"X has shape {tuple(X.shape)}, expected (B, {op.n})")
    _check_op(op, X)
    A._check(coef, "coef", X, (X.shape[0], 3))
    A._check(M, "M", X, (op.slots,))
    if (Kst is None) != (Dr is None):
        raise ValueError("give both Kst and Dr, or neither (the mass-only apply)")
    if Kst is not None:
        A._check(Kst, "Kst", X, (op.slots,))
        A._check(Dr, "Dr", X, (op.slots,))


def knp_apply_batch_plain(X, op: P1Operator, coef, M, Kst=None, Dr=None):
    rows, col = op._plain("slot_rows"), op.col.long()
    xr = X[:, rows.clamp(max=op.n - 1)]  # the padding rows past n hold zeros
    xg = torch.where(col == rows, xr, X[:, col] - xr)
    V = coef[:, 0:1] * M
    if Kst is not None:
        V = V + coef[:, 1:2] * Kst + coef[:, 2:3] * Dr
    n_pad = (op.slot_ptr.shape[0] - 1) * SLICE
    Y = torch.zeros(X.shape[0], n_pad, dtype=X.dtype, device=X.device)
    return Y.index_add_(1, rows, V * xg)[:, : op.n]


def knp_apply_batch(X, op: P1Operator, coef, M, Kst=None, Dr=None):
    """K3.  For every row b of X (one solved ion),

        y_b = c_b0 (M x_b) + c_b1 (Kst x_b) + c_b2 (Dr x_b),

    with ``coef`` rows [c_b0, c_b1, c_b2] = [1/dt, D_b, z_b psi D_b]: the
    P1 mass M (:func:`mass_values`), the unit stiffness Kst (the one the
    EMI system holds for its right-hand side) and the drift values Dr of
    this solve (:func:`drift_fill`, once per solve and subdomain), three
    value streams in the row-sum form on the subdomain's P1 operator.
    Without Kst and Dr it is the mass-only apply of the KNP right-hand
    side, (1/dt) M c_prev, and reads neither stream.

    Replaces ``knpemi_tpu/ops/pallas_assembly.py:_make_knp_kernel_batch``
    (via ``knp_apply_blocked_batch``) together with :func:`drift_fill`.
    Bound on the H100: bytes — each slot's column and three values (one
    for the mass-only apply) read once for all B ions, X read once, Y
    written once (``csrc/cells.cu``).  Design: :func:`emi_stiffness`'s
    row-parallel apply (one warp per 32-row slice, no atomics), each
    slot's value for ion b combined in registers from the three streams
    and B accumulators per row; more than 8 ions go through in groups
    of 8.

    X (B, n), op, coef (B, 3), M, Kst, Dr (slots,) -> Y (B, n)."""
    _check_batch(op, X, coef, M, Kst, Dr)
    if not X.is_cuda:
        return knp_apply_batch_plain(X, op, coef, M, Kst, Dr)
    B = X.shape[0]
    Y = torch.empty_like(X)
    mass_only = Kst is None
    for b0 in range(0, B, A.BATCH_MAX):
        A._launch("p1_apply_batch", X, op.slot_ptr.data_ptr(), op.col.data_ptr(),
                  M.data_ptr(), None if mass_only else Kst.data_ptr(),
                  None if mass_only else Dr.data_ptr(), coef[b0:].data_ptr(),
                  X[b0:].data_ptr(), Y[b0:].data_ptr(), op.n,
                  min(A.BATCH_MAX, B - b0))
        knp_apply_batch.launches += 1
    return Y


knp_apply_batch.launches = 0


# ---------------------------------------------------------------------------
# K1f / K11f: the fills
# ---------------------------------------------------------------------------
def _incidence_slots(op: P1Operator):
    """(c, i, slots (E, k)) of the incidence list's entries in its order:
    slots[e, j] is the slot of column v_j of the entry's cell in the
    entry's row, the row read from the entry's place in the list (so
    that a misplaced entry writes a wrong slot)."""
    c, i, r = op._plain("incidence")
    base = op.slot_ptr.long()[r // SLICE] + r % SLICE
    return c, i, base[:, None] + SLICE * op.pos.long()[c, i]


def _off_diagonal(op: P1Operator, i):
    """(E, k) mask of the columns j != i of every entry."""
    return torch.arange(op.k, device=i.device) != i[:, None]


def _fill_plain(op: P1Operator, slots, v):
    out = torch.zeros(op.slots, dtype=v.dtype, device=v.device)
    return out.index_add_(0, slots, v)


def _launch_fill(kernel: str, op: P1Operator, vals, per_cell: int, *inputs):
    """A fill's kernels into ``vals``: the first pass stages ``per_cell``
    values a cell in a scratch array, the second walks the incidence
    list.  ``inputs``: the kernel's input tensors in its order."""
    nc, k = op.cells.shape
    scratch = torch.empty(nc * per_cell, dtype=vals.dtype, device=vals.device)
    A._launch(kernel, vals, op.inc_ptr.data_ptr(), op.inc.data_ptr(), op.pos.data_ptr(),
              op.slot_ptr.data_ptr(), *(t.data_ptr() for t in inputs), scratch.data_ptr(),
              vals.data_ptr(), op.n, nc, op.kmax, k, 3 if k == 4 else 2)


def emi_fill_plain(op: P1Operator, grads, wv):
    c, i, slots = _incidence_slots(op)
    v = wv[c, None] * (grads[c] * grads[c, i][:, None, :]).sum(-1)  # (E, k)
    off = _off_diagonal(op, i)  # the diagonal slots keep the row sums' 0
    return _fill_plain(op, slots[off], v[off])


def emi_fill(op: P1Operator, grads, wv):
    """K1f.  The slot values of the EMI weighted stiffness for one solve,
    in the row-sum form: wv_c (g_ci . g_cj) added into the slot of every
    vertex pair i != j of every cell, with wv_c = vol_c * mean-vertex
    kappa (K4); the diagonal slots keep the row sums' exact 0.

    Replaces ``knpemi_tpu/ops/pallas_assembly.py:_make_emi_kernel``
    together with :func:`emi_stiffness`: the geometry the TPU kernel
    reads on every apply is read here once per solve.
    Bound on the H100: bytes — cells, pos, grads, wv read once, the
    values written once (``csrc/cells.cu``).
    Design: two kernels.  One thread per cell writes the cell's k (k - 1)
    / 2 pair values wv_c (g_ci . g_cj) to a scratch array (coalesced, 24
    bytes a tetrahedron in float32: small enough for L2).  Then one thread
    per row, one warp per 32-row slice, walks the row's entries of the
    incidence list (``op.inc``, coalesced like the slots), eight in
    flight, gathering each entry's slot positions and its cell's pair
    values; the slice's K[s] x 32 sums live in shared memory, slot-major,
    one column per thread, and are stored once with coalesced writes,
    padding zeros included: no atomics, no memset, the same bits every
    launch.  (Gathering the cell's gradients in one pass instead read
    48 bytes a cell from device memory per entry: twice as long on the
    H100 with two entries in flight, and still slower with sixteen:
    PERF.md.)

    op, grads (nc, k, dim), wv (nc,) -> vals (slots,)."""
    nc, k, dim = _check_fill(op, grads, ("wv", wv, (op.cells.shape[0],)))
    if not grads.is_cuda:
        return emi_fill_plain(op, grads, wv)
    vals = torch.empty(op.slots, dtype=grads.dtype, device=grads.device)
    _launch_fill("emi_fill", op, vals, k * (k - 1) // 2, grads, wv)
    emi_fill.launches += 1
    return vals


emi_fill.launches = 0


def drift_fill_plain(op: P1Operator, grads, vols, w):
    c, i, slots = _incidence_slots(op)
    k = op.k
    q = (vols[c] / k) * (w[c] * grads[c, i]).sum(-1)  # (E,)
    # q into the k - 1 off-diagonal slots of the row, k q (the row's sum) into its diagonal
    v = torch.where(_off_diagonal(op, i), q[:, None], k * q[:, None])
    return _fill_plain(op, slots.reshape(-1), v.reshape(-1))


def drift_fill(op: P1Operator, grads, vols, w):
    """K11f.  The slot values of the P1 drift along the per-cell vector w
    = grad(phi), in the row-sum form: q_ci = vol_c (w_c . g_ci) / k added
    into the slots (i, j != i) and k q_ci into the diagonal slot (i, i) of
    every cell.  Once per KNP solve and subdomain; every solved ion's K11
    shares it.

    Replaces ``knpemi_tpu/ops/pallas_assembly.py:_make_knp_kernel``
    together with :func:`knp_apply`: the drift part of the geometry the
    TPU kernel reads on every apply.
    Bound on the H100: bytes — cells, pos, grads, vols, w read once, the
    values written once (``csrc/cells.cu``).
    Design: :func:`emi_fill`'s two kernels.  One thread per cell writes
    the cell's k values q_ci to a scratch array (16 bytes a tetrahedron
    in float32), then one thread per row walks the incidence list,
    sixteen entries in flight, gathering each entry's slot positions and
    q_ci, and adds q into its row's k - 1 off-diagonal sums and k q into
    the diagonal one, in shared memory: each diagonal has one owner
    thread (the cell-parallel form serialised ~21 atomics on it), no
    memset, the same bits every launch.  (Gathering g_ci, w_c and vol_c
    per entry in one pass took three times as long on the H100 with four
    entries in flight, and was still slower with sixteen: PERF.md.)

    op, grads (nc, k, dim), vols (nc,), w (nc, dim) -> Dr (slots,)."""
    nc, k, dim = _check_fill(op, grads, ("vols", vols, (op.cells.shape[0],)),
                             ("w", w, (op.cells.shape[0], grads.shape[-1])))
    if not grads.is_cuda:
        return drift_fill_plain(op, grads, vols, w)
    vals = torch.empty(op.slots, dtype=grads.dtype, device=grads.device)
    _launch_fill("drift_fill", op, vals, k, grads, vols, w)
    drift_fill.launches += 1
    return vals


drift_fill.launches = 0


# (wrapper, plain version)
KERNELS = {
    "K1 emi_stiffness": (emi_stiffness, emi_stiffness_plain),
    "K1f emi_fill": (emi_fill, emi_fill_plain),
    "K2 surface_mass": (surface_mass, surface_mass_plain),
    "K3 knp_apply_batch": (knp_apply_batch, knp_apply_batch_plain),
    "K11 knp_apply": (knp_apply, knp_apply_plain),
    "K11f drift_fill": (drift_fill, drift_fill_plain),
}
