"""Smoothed-aggregation AMG preconditioner (Vanek/Mandel/Brezina).

Counterpart of ``knpemi_tpu/solvers/mg.py`` with its default damped-Jacobi
V(1,1) cycle:

* **setup on the host, once** (numpy/scipy, copied from the JAX
  package so the hierarchy comes out identical): strength-of-connection
  filtering with B-compatible lumping, Vanek root-node aggregation,
  near-null-weighted tentative prolongators, Jacobi-smoothed P, Galerkin
  RAP and an eigenfactored coarsest inverse;
* **apply on the device, every iteration** (PyTorch): the symmetric
  V-cycle with damped-Jacobi smoothing; every level operator (the
  finest included, lagged) and every transfer is stored in ELL form and
  applied as a gather + row sum, the coarsest inverse is a dense matmul.

With ``banded=True`` every level operator A, transfer P and P^T and
product AP additionally gets the JAX package's block-banded layout
(:func:`_csr_to_banded`, applied by kernels K7/K8 of ``ops/banded.py``)
or, where that is refused, its windowed-ELL layout (``ops/ell.py``,
kernels K4, K5, K6a, K6b); the cycle takes band, then windowed ELL, then
plain ELL, and computes the post-smoothing residual from AP where that
is stored.  The layout *decisions* are the JAX package's (they were made
for TPU costs and are kept so the two cycles do the same arithmetic);
its value refresh of a built hierarchy is not ported.

The hierarchy is *lagged*: built from the initial operator and reused
as the preconditioner while the Krylov solve targets the current
operator exactly.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import pickle
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np
import scipy.sparse as sp
import torch

from ..ops import banded as band_ops
from ..ops import ell as ell_ops
from ..ops.assembly import index_dtype


# ---------------------------------------------------------------------------
# host-side setup
# ---------------------------------------------------------------------------
def strength_filter(A: sp.csr_matrix, theta: float,
                    B: Optional[np.ndarray] = None) -> sp.csr_matrix:
    """Keep |a_ij| >= theta sqrt(a_ii a_jj); lump dropped entries onto
    the diagonal.

    Lumping is B-COMPATIBLE when the near-null vector is given:
    a_ii += a_ij * B_j / B_i, so that Af B = A B exactly.  Plain lumping
    (the B = constant special case) silently breaks near-null
    preservation for equilibrated operators — B = 1/sqrt(diag) varies by
    orders of magnitude at membrane rows, the Jacobi-smoothed P then
    fails to reproduce B, and every Galerkin level compounds the defect
    (measured: the level-1 EMI solve needed 43 CG iterations while the
    fine-level two-grid took 5)."""
    A = A.tocsr()
    d = np.abs(A.diagonal())
    C = A.tocoo()
    keep = (np.abs(C.data) >= theta * np.sqrt(d[C.row] * d[C.col])) | (
        C.row == C.col
    )
    Af = sp.csr_matrix((C.data[keep], (C.row[keep], C.col[keep])), shape=A.shape)
    drow, dcol, dval = C.row[~keep], C.col[~keep], C.data[~keep]
    if B is not None:
        Bs = np.where(B != 0, B, 1.0)
        dval = dval * (B[dcol] / Bs[drow])
    # bincount returns int64 when drow/dval are both empty (nothing
    # filtered); keep the diagonal float so sp.diags doesn't warn/cast
    lump = np.bincount(drow, weights=dval, minlength=A.shape[0])
    return (Af + sp.diags(lump.astype(A.data.dtype, copy=False))).tocsr()


def vanek_aggregate(Af: sp.csr_matrix):
    """Root-node aggregation on the strength graph (Vanek phases 1-3): the
    sequential sweep of ``knpemi_tpu/solvers/mg.py::vanek_aggregate`` and
    of its native twin ``native/host_toolkit.cpp``, which give the same
    aggregates."""
    Af = Af.tocsr()
    n = Af.shape[0]
    agg = np.full(n, -1, dtype=np.int64)
    nc = 0
    indptr, indices = Af.indptr, Af.indices
    for i in range(n):  # phase 1: roots with fully free neighborhoods
        if agg[i] >= 0:
            continue
        nb = indices[indptr[i] : indptr[i + 1]]
        if (agg[nb] == -1).all():
            agg[nb] = nc
            agg[i] = nc
            nc += 1
    for i in range(n):  # phase 2: attach stragglers
        if agg[i] >= 0:
            continue
        nb = indices[indptr[i] : indptr[i + 1]]
        cand = nb[agg[nb] >= 0]
        agg[i] = agg[cand[0]] if len(cand) else -2
    for i in range(n):  # phase 3: isolated nodes become singletons
        if agg[i] == -2:
            agg[i] = nc
            nc += 1
    return agg, nc


def _attach_singletons(agg: np.ndarray, nc: int, A: sp.csr_matrix):
    """Re-attach singleton aggregates to the aggregate of their
    largest-|a_ij| RAW-graph neighbor.

    Strength-isolated rows (every coupling below theta) come out of
    Vanek aggregation as singletons and stay singletons on every
    Galerkin level, so coarsening STALLS: measured on the flagship
    tissue's KNP operators (mass/dt-dominated after one coarsening),
    280k -> 32k -> ... -> 7.5k rows that never shrink, ending in a
    7509^2 dense eigh costing ~45 host-minutes.  Such rows are
    diagonally dominant — the smoother owns them — so folding them into
    a neighboring aggregate costs nothing in interpolation quality while
    restoring geometric coarsening.  Rows with agg == -1 (diagonal-only)
    stay excluded."""
    if nc == 0:
        return agg, nc
    sizes = np.bincount(agg[agg >= 0], minlength=nc)
    single = (agg >= 0) & (sizes[np.maximum(agg, 0)] == 1)
    if not single.any():
        return agg, nc
    A = A.tocsr()
    indptr, indices, adata = A.indptr, A.indices, np.abs(A.data)
    new_agg = agg.copy()
    still = []
    for i in np.flatnonzero(single):
        sl = slice(indptr[i], indptr[i + 1])
        nb, val = indices[sl], adata[sl]
        # one-shot attach to a NON-singleton neighbor's aggregate; a
        # singleton target would be a moving chain (with uniform weights
        # every node points at its first neighbor and nc barely drops)
        ok = (nb != i) & (agg[nb] >= 0) & (
            sizes[np.maximum(agg[nb], 0)] > 1
        )
        if ok.any():
            new_agg[i] = agg[nb[ok][np.argmax(val[ok])]]
        else:
            still.append(i)
    if still:
        # pure-singleton regions (e.g. an entirely mass-dominated
        # subdomain where EVERY row is strength-isolated): rows are
        # locality-ordered (RCM/Morton, ops/geometry.py), so packing
        # RUNS of consecutive singleton rows into fixed-size groups
        # yields compact spatial aggregates without any graph walk
        still = np.asarray(still)
        run_id = np.cumsum(np.r_[0, np.diff(still) != 1])
        # group size 8: within each run, chunk consecutive rows
        pos_in_run = np.arange(len(still)) - np.maximum.accumulate(
            np.where(np.r_[True, np.diff(still) != 1],
                     np.arange(len(still)), 0)
        )
        key = run_id * (len(still) + 1) + pos_in_run // 8
        _, packed = np.unique(key, return_inverse=True)
        new_agg[still] = nc + packed
        nc = nc + int(packed.max()) + 1
    used = np.zeros(nc, bool)
    used[new_agg[new_agg >= 0]] = True
    remap = np.full(nc, -1, np.int64)
    remap[used] = np.arange(int(used.sum()))
    new_agg = np.where(new_agg >= 0, remap[np.maximum(new_agg, 0)], -1)
    return new_agg, int(used.sum())


def _tentative_prolongator(agg: np.ndarray, nc: int, B: np.ndarray):
    """SA tentative prolongator: per aggregate, an orthonormal basis (QR)
    of the near-null candidates restricted to the aggregate; returns
    (Pt, B_coarse).  With B = [constant] this is classic single-vector SA
    (the only case build_hierarchy takes)."""
    n, m = B.shape
    # agg == -1 marks rows excluded from the coarse space (isolated
    # rows, see build_hierarchy): their P rows stay identically zero
    valid = np.flatnonzero(agg >= 0)
    order = valid[np.argsort(agg[valid], kind="stable")]
    counts = np.bincount(agg[valid], minlength=nc)
    starts = np.zeros(nc + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    rows = []
    cols = []
    vals = []
    Bc = np.zeros((nc * m, m))
    # group aggregates by size so each group QRs as one batched einsum
    for size in np.unique(counts):
        if size == 0:
            continue
        aggs = np.flatnonzero(counts == size)
        idx = np.stack(
            [order[starts[a] : starts[a] + size] for a in aggs]
        )  # (na, size)
        Bb = B[idx]  # (na, size, m)
        Q, R = np.linalg.qr(Bb)  # (na, size, k), (na, k, m); k=min(size,m)
        k = Q.shape[2]
        # fix QR sign ambiguity (diag(R) >= 0) for determinism
        sign = np.sign(np.einsum("aii->ai", R[:, :k, :k]))
        sign = np.where(sign == 0, 1.0, sign)
        Q = Q * sign[:, None, :]
        R = R * sign[:, :, None]
        na = len(aggs)
        rows.append(np.repeat(idx.reshape(na, size), k, axis=1).ravel())
        cols.append(
            (aggs[:, None, None] * m
             + np.arange(k)[None, None, :]).repeat(size, axis=1).ravel()
        )
        vals.append(Q.reshape(-1))
        Bc[(aggs[:, None] * m + np.arange(k)[None, :]).ravel()] = (
            R.reshape(na * k, m)
        )
    Pt = sp.csr_matrix(
        (np.concatenate(vals),
         (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, nc * m),
    )
    # drop numerically-zero columns (aggregates smaller than m produce
    # rank-deficient blocks); keep shapes simple by keeping them — the
    # zero columns yield zero coarse rows/cols and a harmless singular
    # direction handled by the coarse eigenvalue cutoff.
    return Pt, Bc


def _lam_max_jacobi(A: sp.csr_matrix, iters: int = 30) -> float:
    d = A.diagonal()
    d = np.where(d != 0, d, 1.0)
    x = np.random.default_rng(0).standard_normal(A.shape[0])
    lam = 1.0
    for _ in range(iters):
        x = (A @ x) / d
        lam = np.linalg.norm(x)
        x /= max(lam, 1e-30)
    return float(max(lam, 1e-30))


def _csr_to_ell(A: sp.csr_matrix, pad_diag=True):
    """ELL layout (cols, vals) of a CSR matrix, rows padded to the widest."""
    A = A.tocsr()
    n = A.shape[0]
    Kmax = max(int(np.diff(A.indptr).max()), 1)
    cols = np.zeros((n, Kmax), dtype=np.int32)
    vals = np.zeros((n, Kmax))
    nnz_per_row = np.diff(A.indptr)
    rows = np.repeat(np.arange(n), nnz_per_row)
    pos = np.arange(A.nnz) - np.repeat(A.indptr[:-1], nnz_per_row)
    cols[rows, pos] = A.indices
    vals[rows, pos] = A.data
    if pad_diag:
        # unused slots point at the row itself with zero value
        pos_mask = np.zeros((n, Kmax), dtype=bool)
        pos_mask[rows, pos] = True
        cols[~pos_mask] = np.repeat(np.arange(n)[:, None], Kmax, 1)[~pos_mask]
    return cols, vals


@dataclasses.dataclass
class MGLevel:
    n: int
    diag: np.ndarray
    # damped-Jacobi weight of the smoother
    omega: float
    # lagged level operator in ELL form (None: level 0 smooths with the
    # caller's matrix-free operator)
    a_cols: Optional[np.ndarray] = None
    a_vals: Optional[np.ndarray] = None
    # prolongator P (n x nc) and restriction P^T (nc x n) in ELL form
    p_cols: Optional[np.ndarray] = None
    p_vals: Optional[np.ndarray] = None
    pt_cols: Optional[np.ndarray] = None
    pt_vals: Optional[np.ndarray] = None
    # block-banded dense forms (see _csr_to_banded) of A, P, P^T and of
    # the product A P (n x nc), which gives the post-smoothing residual as
    # res1 - (AP) xc from a slab ~nc/n the size of A's; None -> next form
    a_band: Optional[tuple] = None
    p_band: Optional[tuple] = None
    pt_band: Optional[tuple] = None
    ap_band: Optional[tuple] = None
    # windowed-ELL forms (ops/ell.py) where banding is refused; pt_ellw is
    # a layout of P, applied transposed
    a_ellw: Optional[ell_ops.ELLW] = None
    ap_ellw: Optional[ell_ops.ELLW] = None
    p_ellw: Optional[ell_ops.ELLW] = None
    pt_ellw: Optional[ell_ops.ELLW] = None
    P_csr: Optional[sp.csr_matrix] = None


def _csr_to_banded(A: sp.csr_matrix, R: int = 256, W_cap: int = 4096,
                   density_min: float = 0.002, mem_cap: int = 512 << 20,
                   n_windows: int = 2, dtype=np.float64):
    """Multi-window block-banded dense layout of a sparse matrix whose
    rows are locality-ordered: rows are grouped into blocks of R; each
    block stores up to ``n_windows`` dense slabs
    ``A[r0:r0+R, w0_s[b]:w0_s[b]+W_s]`` and a COO list of the few entries
    outside every window.

    Returns ``(windows, far_rows, far_cols, far_vals, n, m)`` with
    ``windows = [(slabT (NB*W, R), w0 (NB,), W), ...]``, or None when
    the layout is unprofitable (windows too wide / slabs too empty).

    Copied from the JAX package so both build the same layouts: the
    width ladder, the 128-aligned window starts (+128 of width), the
    coverage and density thresholds and the byte budget (counted at 4
    bytes per value whatever ``dtype``) are its choices for the TPU."""
    A = A.tocsr()
    n, m = A.shape
    NB = -(-n // R)
    indptr, indices, data = A.indptr, A.indices, A.data
    rows = np.repeat(np.arange(n), np.diff(indptr))
    blk = rows // R
    m128 = -(-m // 128) * 128
    mem_left = mem_cap

    remaining = np.ones(A.nnz, bool)
    windows = []
    for _ in range(n_windows):
        rem_nnz = int(remaining.sum())
        if rem_nnz == 0 or (windows and rem_nnz < 0.02 * A.nnz):
            break  # leftover is cheap enough as a COO remainder
        # split remaining entries by row-block in one pass (blk is
        # nondecreasing in CSR order)
        rem_idx = np.flatnonzero(remaining)
        bounds = np.searchsorted(blk[rem_idx], np.arange(1, NB))
        block_cols = [
            np.sort(part) for part in np.split(indices[rem_idx], bounds)
        ]

        def coverage(W):
            near = 0
            for c in block_cols:
                if len(c):
                    near += int(
                        (np.searchsorted(c, c + W) - np.arange(len(c))).max()
                    )
            return near

        # smallest ladder W capturing >= 85% of the remaining entries —
        # but keep scanning (to <= 2x that width) for FULL coverage
        W = W85 = best_W = None
        best_near = -1
        for Wc in (128, 256, 512, 1024, 1536, 2048, 3072, 4096):
            if Wc > min(W_cap, m128) or NB * R * Wc * 4 > mem_left:
                break
            near = coverage(Wc)
            if near > best_near:
                best_near, best_W = near, Wc
            if W85 is None and near >= 0.85 * rem_nnz:
                W85 = Wc
            if near >= rem_nnz:
                W = Wc if (W85 is None or Wc <= 2 * W85) else W85
                break
            if W85 is not None and Wc >= 2 * W85:
                W = W85
                break
        if W is None:
            W = W85
        if W is None:
            # a follow-up window is accepted at lower coverage
            accept = 0.5 if not windows else 0.35
            if best_W is None or best_near < accept * rem_nnz:
                break  # this window wouldn't pay for itself
            W = best_W
        if not windows and m128 <= min(W_cap, mem_left // (4 * NB * R)) \
                and m128 < 2 * W:
            W = m128  # window can cover everything: store dense
        # densest width-W window per block (two-pointer on sorted cols),
        # start aligned down to 128 (+128 of width)
        w0 = np.zeros(NB, np.int32)
        for b, c in enumerate(block_cols):
            if len(c) == 0:
                continue
            cover = np.searchsorted(c, c + W) - np.arange(len(c))
            w0[b] = c[int(np.argmax(cover))]
        w0 = (w0 // 128 * 128).astype(np.int32)
        W = W + 128
        if NB * R * W * 4 > mem_left:
            break
        loc = indices - w0[blk]
        inside = remaining & (loc >= 0) & (loc < W)
        nnz_in = int(inside.sum())
        # follow-up windows accept much sparser slabs than the first
        dmin = density_min if not windows else density_min / 4
        if nnz_in < dmin * NB * R * W and n > 2048:
            break  # slab nearly empty: leftovers stay COO
        slabT = np.zeros((NB * W, R), dtype)
        slabT[blk[inside] * W + loc[inside], rows[inside] % R] = data[inside]
        windows.append((slabT, w0, W))
        remaining = remaining & ~inside
        mem_left -= NB * R * W * 4

    if not windows:
        return None
    if int(remaining.sum()) > 0.25 * A.nnz:
        return None  # windows miss too much: layout not applicable
    far_rows = rows[remaining].astype(np.int32)
    far_cols = indices[remaining].astype(np.int32)
    far_vals = data[remaining]
    return windows, far_rows, far_cols, far_vals, n, m


def _device_band(band, dtype, device, slab_dtype=None):
    """A :func:`_csr_to_banded` layout as device tensors: slabs in
    ``slab_dtype`` (default ``dtype``), far values in ``dtype``."""
    if band is None:
        return None
    windows, far_rows, far_cols, far_vals, n, m = band
    as_i = lambda a: torch.as_tensor(a, dtype=torch.int64, device=device)
    return dict(
        windows=[dict(
            # uploaded as built (the run dtype), cast on the device
            slabT=torch.as_tensor(sT, device=device).to(slab_dtype or dtype),
            w0=torch.as_tensor(w0, dtype=index_dtype(device), device=device),
            W=W,
        ) for sT, w0, W in windows],
        far_rows=as_i(far_rows), far_cols=as_i(far_cols),
        far_vals=torch.as_tensor(far_vals, dtype=dtype, device=device), n=n, m=m,
    )


@dataclasses.dataclass
class MGHierarchy:
    """Host hierarchy; coarse solve eigenfactored, C^-1 = V diag(1/lam) V^T
    (the large numbers stay in an exact diagonal scale).  ``perm`` is the
    optional row/column permutation applied to the operator before the
    build (the global RCM of the solver layout, sim/stepper.py)."""

    levels: List[MGLevel]
    coarse_V: np.ndarray
    coarse_ilam: np.ndarray
    nu: int = 1
    perm: Optional[np.ndarray] = None

    def device(self, dtype, device, band_dtype=None) -> "DeviceMG":
        """Upload to ``device`` in ``dtype``.  ``band_dtype`` is the STORAGE
        type of the fine-level smoothing slab (``torch.bfloat16`` halves
        its bytes; default ``dtype``): the kernel upcasts each value after
        the read and never rounds the vector, so the preconditioner stays
        one fixed linear operator.  It applies to ``levels[0].a_band``
        only: the Galerkin coarse operators and the transfers must keep
        the near-null space exactly."""
        as_f = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
        as_i = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64, device=device)
        np_dtype = np.float32 if dtype == torch.float32 else np.float64
        iperm = np.argsort(self.perm) if self.perm is not None else None
        dev_band = lambda band, slab_dt=None: _device_band(band, dtype, device, slab_dt)
        ellw_done = {}  # p_ellw and pt_ellw are often one layout

        def dev_ellw(e):
            if e is None:
                return None
            if id(e) not in ellw_done:
                ellw_done[id(e)] = e.device(dtype, device)
            return ellw_done[id(e)]

        out = []
        for ilv, lv in enumerate(self.levels):
            # matrix-free permuted fine level: the smoothing diagonal in
            # SOLVER layout, so level 0 smooths with the caller's operator
            # without permuting every application
            dinv_solver = None
            if (ilv == 0 and iperm is not None and lv.a_cols is None
                    and lv.a_band is None and lv.a_ellw is None):
                dinv_solver = as_f((1.0 / lv.diag)[iperm])
            out.append(dict(
                n=lv.n,
                dinv=as_f(1.0 / lv.diag),
                dinv_solver=dinv_solver,
                # rounded to the run dtype, as the JAX arrays are
                omega=float(np_dtype(lv.omega)),
                a_cols=None if lv.a_cols is None else as_i(lv.a_cols),
                a_vals=None if lv.a_vals is None else as_f(lv.a_vals),
                p_cols=as_i(lv.p_cols), p_vals=as_f(lv.p_vals),
                pt_cols=as_i(lv.pt_cols), pt_vals=as_f(lv.pt_vals),
                a_band=dev_band(lv.a_band, band_dtype if ilv == 0 else None),
                ap_band=dev_band(lv.ap_band), p_band=dev_band(lv.p_band),
                pt_band=dev_band(lv.pt_band),
                a_ellw=dev_ellw(lv.a_ellw), ap_ellw=dev_ellw(lv.ap_ellw),
                p_ellw=dev_ellw(lv.p_ellw), pt_ellw=dev_ellw(lv.pt_ellw),
            ))
        return DeviceMG(
            out, as_f(self.coarse_V), as_f(self.coarse_ilam), self.nu,
            perm=None if self.perm is None else as_i(self.perm),
            iperm=None if iperm is None else as_i(iperm),
        )


# byte budgets of the block-banded layouts (the JAX package's defaults):
# per level operator, and per transfer or A P product
BAND_CAP = 1024 << 20
TBAND_CAP = 512 << 20


def build_hierarchy(
    A0: sp.csr_matrix,
    B: Optional[np.ndarray] = None,
    theta: float = 0.08,
    coarse_max: int = 800,
    max_levels: int = 10,
    nu: int = 1,
    omega_p: float = 4.0 / 3.0,
    fine_ell="auto",
    banded: bool = False,
    slab_dtype=np.float64,
) -> MGHierarchy:
    """Build the SA hierarchy of ``knpemi_tpu/solvers/mg.py::build_hierarchy``
    with its default damped-Jacobi smoother.  ``B`` is the near-null
    vector of A0 (1/s for an operator equilibrated by S = diag(s)).

    With ``fine_ell`` the finest operator is stored too and the V-cycle
    smooths with it, not with the caller's.  ``"auto"`` means yes, except
    that with ``banded`` a finest operator that takes neither the banded
    nor the windowed-ELL layout is dropped again.

    With ``banded`` every level operator, transfer and A P product gets a
    block-banded layout (:func:`_csr_to_banded`, slabs in ``slab_dtype``)
    within ``BAND_CAP`` bytes per level operator and ``TBAND_CAP`` per
    transfer or product, or else a windowed-ELL layout
    (``ops/ell.py::build_ellw``); what takes neither keeps plain ELL."""
    A = A0.tocsr()
    if B is None:
        B = np.ones(A.shape[0])
    B = np.asarray(B)
    if B.ndim == 1:
        B = B[:, None]
    m_cand = B.shape[1]
    if m_cand != 1:
        raise NotImplementedError("multi-candidate near-null spaces are not ported")
    levels: List[MGLevel] = []
    while A.shape[0] > coarse_max and len(levels) < max_levels:
        n = A.shape[0]
        diag = A.diagonal()
        diag = np.where(np.abs(diag) > 0, diag, 1.0)
        Af = strength_filter(A, theta, B=B[:, 0])
        agg, nc = vanek_aggregate(Af)
        # drop isolated (diagonal-only) rows from the coarse space: the
        # smoother alone handles their error
        nnz_row = np.diff(A.indptr)
        iso = nnz_row <= 1
        if iso.any():
            keep_agg = np.ones(nc, bool)
            keep_agg[agg[iso]] = False
            remap = np.full(nc, -1, np.int64)
            remap[keep_agg] = np.arange(int(keep_agg.sum()))
            agg = np.where(iso, -1, remap[agg])
            nc = int(keep_agg.sum())
        agg, nc = _attach_singletons(agg, nc, A)
        # relabel aggregates by their minimum fine index, keeping coarse
        # levels locality-ordered like the fine one
        valid = agg >= 0
        first = np.full(nc, n, np.int64)
        np.minimum.at(first, agg[valid], np.flatnonzero(valid))
        ranks = np.empty(nc, np.int64)
        ranks[np.argsort(first, kind="stable")] = np.arange(nc)
        agg = np.where(valid, ranks[np.maximum(agg, 0)], -1)
        if nc * m_cand > 0.7 * n:
            break  # coarsening stalled
        Pt, B = _tentative_prolongator(agg, nc, B)
        lam_f = _lam_max_jacobi(Af)
        df = Af.diagonal()
        df = np.where(df != 0, df, 1.0)
        P = (Pt - (omega_p / lam_f) * (sp.diags(1.0 / df) @ (Af @ Pt))).tocsr()
        lam = _lam_max_jacobi(A)
        lv = MGLevel(n=n, diag=diag, omega=4.0 / (3.0 * lam), P_csr=P)
        if levels or fine_ell:
            lv.a_cols, lv.a_vals = _csr_to_ell(A)
        lv.p_cols, lv.p_vals = _csr_to_ell(P, pad_diag=False)
        lv.pt_cols, lv.pt_vals = _csr_to_ell(P.T.tocsr(), pad_diag=False)
        AP = (A @ P).tocsr()  # reused below for the Galerkin RAP
        if banded:
            if lv.a_cols is not None:
                lv.a_band = _csr_to_banded(A, mem_cap=BAND_CAP, dtype=slab_dtype)
                if lv.a_band is None:
                    lv.a_ellw = ell_ops.build_ellw(A)
                # fused post-smooth operand (see MGLevel.ap_band); only
                # where the level smooths with its own lagged operator —
                # with the caller's current fine operator a lagged AP
                # would break the cycle's symmetry
                lv.ap_band = _csr_to_banded(AP, mem_cap=TBAND_CAP, dtype=slab_dtype)
                if lv.ap_band is None:
                    lv.ap_ellw = ell_ops.build_ellw(AP)
            lv.p_band = _csr_to_banded(P, mem_cap=TBAND_CAP, dtype=slab_dtype)
            if lv.p_band is None:
                # one windowed-ELL layout of P serves BOTH directions
                # (gather = P, scatter = P^T)
                lv.p_ellw = ell_ops.build_ellw(P)
                lv.pt_ellw = lv.p_ellw
            else:
                lv.pt_band = _csr_to_banded(P.T.tocsr(), mem_cap=TBAND_CAP,
                                            dtype=slab_dtype)
                if lv.pt_band is None:
                    lv.pt_ellw = ell_ops.build_ellw(P)
        if (not levels and fine_ell == "auto" and banded
                and lv.a_band is None and lv.a_ellw is None):
            # no storable fine layout: drop the stored operator so the
            # cycle smooths level 0 with the caller's operator
            lv.a_cols = lv.a_vals = None
            lv.ap_band = lv.ap_ellw = None
        levels.append(lv)
        A = (P.T @ AP).tocsr()
    if A.shape[0] > 20 * coarse_max:
        raise RuntimeError(
            f"AMG coarsening stalled at n={A.shape[0]} "
            f"(coarse_max={coarse_max}); dense coarse solve refused"
        )
    lam, V = np.linalg.eigh(A.toarray())
    lmax = np.abs(lam).max() if len(lam) else 1.0
    ilam = np.where(np.abs(lam) > 1e-10 * lmax, 1.0 / lam, 0.0)
    return MGHierarchy(levels=levels, coarse_V=V, coarse_ilam=ilam, nu=nu)


# cache-key version: bump whenever build_hierarchy's algorithm changes
_BUILD_VERSION = "torch-v2"  # v2: banded and windowed-ELL layouts
CACHE_DIR = Path(__file__).resolve().parents[1] / "build" / "mg_cache"


def build_hierarchy_cached(A0: sp.csr_matrix, B: Optional[np.ndarray] = None,
                           cache_dir: Optional[Path] = None, **kw) -> MGHierarchy:
    """Disk-cached :func:`build_hierarchy`, keyed by the operator's exact CSR
    content, the near-null vector and every build parameter.  The cache
    is the port's own (``knpemi_tpu_torch/build/mg_cache``, git-ignored):
    the JAX package's pickles hold its own classes."""
    cache_dir = Path(cache_dir or CACHE_DIR)
    A = A0.tocsr()
    h = hashlib.sha256()
    h.update(_BUILD_VERSION.encode())
    h.update(np.asarray(A.shape, np.int64).tobytes())
    h.update(np.ascontiguousarray(A.indptr, np.int64).tobytes())
    h.update(np.ascontiguousarray(A.indices, np.int64).tobytes())
    h.update(np.ascontiguousarray(A.data, np.float64).tobytes())
    if B is not None:
        h.update(np.ascontiguousarray(B, np.float64).tobytes())
    h.update(repr(sorted(kw.items())).encode())
    path = cache_dir / (h.hexdigest()[:32] + ".pkl")
    if path.exists():
        try:
            with open(path, "rb") as f:
                return pickle.load(f)
        except Exception:
            pass  # corrupt entry: rebuild below
    hier = build_hierarchy(A, B=B, **kw)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    try:
        cache_dir.mkdir(parents=True, exist_ok=True)
        with open(tmp, "wb") as f:
            pickle.dump(hier, f, protocol=4)
        os.replace(tmp, path)
    except OSError:
        tmp.unlink(missing_ok=True)  # caching is best-effort
    return hier


# ---------------------------------------------------------------------------
# device-side application
# ---------------------------------------------------------------------------
def _ell_mv(cols, vals, x):
    return (vals * x[cols]).sum(dim=1)


def _ell_mv_batch(cols, vals, X):
    return (vals[None] * X[:, cols]).sum(dim=-1)


def _banded_mv(band, x, batch: bool):
    """y = A x (or Y = X A^T for X (B, m)) with A in multi-window
    block-banded form: each window through K7 (K8 for a batch, one slab
    read for all B vectors), summed, plus the COO remainder."""
    mv = band_ops.banded_matvec_batch if batch else band_ops.banded_matvec
    y = None
    for win in band["windows"]:
        ys = mv(win["slabT"], win["w0"], x, band["n"], win["W"])
        y = ys if y is None else y + ys
    if band["far_rows"].shape[0]:
        far = band["far_vals"] * x[..., band["far_cols"]]
        y.index_add_(-1, band["far_rows"], far)  # y is this call's own
    return y


class DeviceMG:
    """Symmetric V(nu, nu)-cycle on the device with damped-Jacobi
    smoothing.  Level operators are the lagged matrices, each in the
    first form it has of block-banded, windowed ELL and plain ELL; a
    level-0 without one smooths with the operator the caller passes.
    ``fine_diag`` (set by the caller) is the raw diagonal of the operator
    the hierarchy was built from, the solvers' lagged equilibration
    scale."""

    def __init__(self, levels, coarse_V, coarse_ilam, nu, perm=None,
                 iperm=None, fine_diag=None):
        self.levels = levels
        self.coarse_V = coarse_V
        self.coarse_ilam = coarse_ilam
        self.nu = nu
        self.perm = perm
        self.iperm = iperm
        self.fine_diag = fine_diag

    def layout(self):
        """Per level, the form the cycle takes for A, P, P^T and AP: 'band',
        'ellw', 'ell' or, for a level-0 A without a stored operator,
        'caller'; AP is None where the post-smooth is not fused."""
        pick = lambda lv, w: ("band" if lv[w + "_band"] is not None
                              else "ellw" if lv[w + "_ellw"] is not None else None)
        return [dict(
            n=lv["n"],
            A=pick(lv, "a") or ("ell" if lv["a_cols"] is not None else "caller"),
            P=pick(lv, "p") or "ell", Pt=pick(lv, "pt") or "ell",
            AP=pick(lv, "ap") if self._fused_post(lv) else None,
        ) for lv in self.levels]

    def _op(self, i: int, A0: Callable, batch: bool):
        lv = self.levels[i]
        if lv["a_band"] is not None:
            return lambda x: _banded_mv(lv["a_band"], x, batch)
        if lv["a_ellw"] is not None:
            mv = ell_ops.ellw_matvec_batch if batch else ell_ops.ellw_matvec
            return lambda x: mv(lv["a_ellw"], x)
        if lv["a_cols"] is None:
            return A0
        mv = _ell_mv_batch if batch else _ell_mv
        return lambda x: mv(lv["a_cols"], lv["a_vals"], x)

    @staticmethod
    def _transfer(lv, which: str, x, batch: bool):
        if lv[which + "_band"] is not None:
            return _banded_mv(lv[which + "_band"], x, batch)
        ellw = lv[which + "_ellw"]
        if ellw is not None:
            # the stored layout is always of P; restriction applies it
            # transposed
            if which == "pt":
                mv = ell_ops.ellw_rmatvec_batch if batch else ell_ops.ellw_rmatvec
            else:
                mv = ell_ops.ellw_matvec_batch if batch else ell_ops.ellw_matvec
            return mv(ellw, x)
        mv = _ell_mv_batch if batch else _ell_mv
        return mv(lv[which + "_cols"], lv[which + "_vals"], x)

    def _fused_post(self, lv) -> bool:
        """Take the post-smoothing residual as res1 - (AP) xc instead of a
        second full-operator apply.  Valid for the V(1,1) cycle on a level
        that smooths with its LAGGED operator (AP is lagged too; AP is
        only ever stored for such a level).  A banded AP always fuses; a
        windowed-ELL AP only when the JAX package's static work product
        NCH*Wr*K*C says it is cheaper than the operator's own layout —
        a TPU cost rule, kept so both cycles do the same arithmetic."""
        if self.nu != 1:
            return False
        if lv["ap_band"] is not None:
            return True
        ap = lv["ap_ellw"]
        if ap is None:
            return False
        a = lv["a_ellw"]
        if a is not None:
            return ap.NCH * ap.Wr * ap.K * ap.C <= a.NCH * a.Wr * a.K * a.C
        return lv["a_band"] is None

    @staticmethod
    def _ap_apply(lv, xc, batch: bool):
        if lv["ap_band"] is not None:
            return _banded_mv(lv["ap_band"], xc, batch)
        mv = ell_ops.ellw_matvec_batch if batch else ell_ops.ellw_matvec
        return mv(lv["ap_ellw"], xc)

    def _coarse(self, r, batch: bool):
        V, ilam = self.coarse_V, self.coarse_ilam
        if batch:
            return ((r @ V) * ilam) @ V.T
        return V @ (ilam * (V.T @ r))

    def apply(self, A0: Callable, r: torch.Tensor) -> torch.Tensor:
        return self._apply(A0, r, batch=False)

    def apply_batch(self, A0b: Callable, R: torch.Tensor) -> torch.Tensor:
        """V-cycle on B residuals at once (R is (B, n)); ``A0b`` is the
        batched fine operator (unused when level 0 stores its own)."""
        return self._apply(A0b, R, batch=True)

    def _apply(self, A0, r, batch: bool):
        if self.perm is None:
            return self._cycle(0, A0, r, batch)
        perm, iperm = self.perm, self.iperm
        gather = lambda v: v[..., perm]
        scatter = lambda v: v[..., iperm]
        if self.levels and self.levels[0]["dinv_solver"] is not None:
            return self._fine_solver_cycle(A0, r, gather, scatter, batch)
        # the hierarchy lives in the permuted space; A0 is consulted only
        # when level 0 has no lagged operator
        A0p = lambda x: gather(A0(scatter(x)))
        return scatter(self._cycle(0, A0p, gather(r), batch))

    def _smooth(self, A, dinv, omega, r, x, sweeps: int):
        for _ in range(sweeps):
            x = x + omega * (dinv * (r - A(x)))
        return x

    def _smooth_pre(self, A, dinv, omega, r):
        # the first sweep from x = 0 needs no operator apply
        x = omega * (dinv * r)
        return self._smooth(A, dinv, omega, r, x, self.nu - 1)

    def _fine_solver_cycle(self, A0, r, gather, scatter, batch: bool):
        """Level-0 smoothing in the caller's dof layout with its operator;
        the coarse sub-cycle runs in the hierarchy's permuted layout."""
        lv = self.levels[0]
        dinv, omega = lv["dinv_solver"], lv["omega"]
        x = self._smooth_pre(A0, dinv, omega, r)
        res1 = r - A0(x)
        rc = self._transfer(lv, "pt", gather(res1), batch)
        xc = self._cycle(1, None, rc, batch)
        x = x + scatter(self._transfer(lv, "p", xc, batch))
        return self._smooth(A0, dinv, omega, r, x, self.nu)

    def _cycle(self, i: int, A0, r, batch: bool):
        if i == len(self.levels):
            return self._coarse(r, batch)
        lv = self.levels[i]
        A = self._op(i, A0, batch)
        dinv, omega = lv["dinv"], lv["omega"]
        x = self._smooth_pre(A, dinv, omega, r)
        res1 = r - A(x)
        rc = self._transfer(lv, "pt", res1, batch)
        xc = self._cycle(i + 1, A0, rc, batch)
        x = x + self._transfer(lv, "p", xc, batch)
        if self._fused_post(lv):
            # res(x + P xc) = res1 - (AP) xc: the same arithmetic from a
            # much smaller read than a second full-operator apply
            res2 = res1 - self._ap_apply(lv, xc, batch)
            return x + omega * (dinv * res2)
        return self._smooth(A, dinv, omega, r, x, self.nu)
