"""Smoothed-aggregation AMG preconditioner (Vanek/Mandel/Brezina).

Counterpart of ``knpemi_tpu/solvers/mg.py``: the V(nu, nu) cycle with
damped-Jacobi (``smoother="jacobi"``, one step a sweep) or
Chebyshev-Richardson (``"cheby"``, ``degree`` steps at the Chebyshev
points of [lam_max / 4, lam_max]) smoothing, the W-cycle
(``DeviceMG.gamma = 2``: the coarse problem solved twice, the second
time on its own residual) and the asymmetric V(1, 0) cycle
(``DeviceMG.post_smooth = False``: for the flexible GMRES of the KNP
solve, never for CG):

* **setup on the host, once** (numpy/scipy, copied from the JAX
  package so the hierarchy comes out identical): strength-of-connection
  filtering with B-compatible lumping, Vanek root-node aggregation
  (the native host toolkit's sweep, ``utils/native.py``),
  near-null-weighted tentative prolongators, Jacobi-smoothed P, Galerkin
  RAP and an eigenfactored coarsest inverse;
* **apply on the device, every iteration** (PyTorch): the cycle, each
  smoothing sweep Richardson steps over 1/diag (post-smoothing takes
  them in reverse, so that the cycle stays symmetric for CG); every
  level operator (the finest included, lagged) and every transfer is
  stored in ELL form and applied as a gather + row sum, the coarsest
  inverse is a dense matmul.

With ``banded=True`` every level operator A, transfer P and P^T and
product AP additionally gets the JAX package's block-banded layout
(:func:`_csr_to_banded`; uploaded as the packed nonzeros of its slabs and
applied by kernels K7/K8 of ``ops/banded.py``)
or, where that is refused, its windowed-ELL layout (``ops/ell.py``,
kernels K4, K5, K6a, K6b); the cycle takes band, then windowed ELL, then
plain ELL, and computes the post-smoothing residual from AP where that
is stored.  The layout *decisions* are the JAX package's (they were made
for TPU costs and are kept so the two cycles do the same arithmetic).

The hierarchy is *lagged*: built from the initial operator and reused
as the preconditioner while the Krylov solve targets the current
operator exactly.  :func:`refresh_hierarchy` (the JAX package's) gives a
built hierarchy the values of a new operator of the same structure,
with the transfers frozen and every array's shape kept;
:meth:`DeviceMG.refill_arrays` pairs them with the tensors the device
cycle already holds and :meth:`DeviceMG.install` copies them in, so
that no tensor is reallocated.  :func:`build_hierarchy_cached` keeps
built hierarchies on disk in the port's own cache directory (written
atomically inside ``utils/critical.py::critical_section``), bounded by
:func:`_evict_lru`.
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
from ..utils import native
from ..utils.critical import critical_section


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
    """Root-node aggregation on the strength graph (Vanek phases 1-3), by
    the native host toolkit's sweep (``utils/native.py``, built at first
    use; a failed build raises): the sweep of
    ``knpemi_tpu/solvers/mg.py::vanek_aggregate`` and of its native twin,
    which give the same aggregates."""
    Af = Af.tocsr()
    return native.vanek_aggregate(Af.indptr, Af.indices, Af.shape[0])


def vanek_aggregate_plain(Af: sp.csr_matrix):
    """The same sweep in Python, the plain twin of :func:`vanek_aggregate`
    that tests hold it against; no build calls it."""
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


def _csr_to_ell(A: sp.csr_matrix, pad_diag=True, K=None):
    """ELL layout (cols, vals) of a CSR matrix, rows padded to the widest;
    ``K`` forces the width (the frozen shape of a refresh): rows wider
    than K drop their smallest-|value| entries."""
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
    pos_mask = np.zeros((n, Kmax), dtype=bool)
    pos_mask[rows, pos] = True
    if K is not None and K != Kmax:
        if Kmax > K:
            order = np.argsort(-np.abs(vals), axis=1)[:, :K]
            r = np.arange(n)[:, None]
            cols, vals, pos_mask = cols[r, order], vals[r, order], pos_mask[r, order]
        else:
            pad = K - Kmax
            cols = np.pad(cols, ((0, 0), (0, pad)))
            vals = np.pad(vals, ((0, 0), (0, pad)))
            pos_mask = np.pad(pos_mask, ((0, 0), (0, pad)))
        Kmax = K
    if pad_diag:
        # unused slots point at the row itself with zero value
        cols[~pos_mask] = np.repeat(np.arange(n)[:, None], Kmax, 1)[~pos_mask]
    return cols, vals


def _cheb_steps(lam_max: float, degree: int, eig_ratio: float = 4.0):
    """Richardson step sizes 1/r_i at the Chebyshev points of
    [lam_max / eig_ratio, lam_max] for D^-1 A: the hypre/PyAMG-style
    polynomial smoother.  degree 1 is damped Jacobi with omega = 1/r_0."""
    lmin = lam_max / eig_ratio
    d = 0.5 * (lam_max + lmin)
    c = 0.5 * (lam_max - lmin)
    roots = d + c * np.cos(np.pi * (2 * np.arange(degree) + 1) / (2.0 * degree))
    return (1.0 / roots).astype(np.float64)


def _smoother_steps(lam: float, smoother: str, degree: int) -> np.ndarray:
    """A level's Richardson steps: the Chebyshev ones, or [4 / (3 lam)]
    (damped Jacobi)."""
    if smoother == "cheby":
        return _cheb_steps(lam, degree)
    return np.array([4.0 / (3.0 * lam)])


@dataclasses.dataclass
class MGLevel:
    n: int
    diag: np.ndarray
    # damped-Jacobi weight, 4 / (3 lam_max(D^-1 A))
    omega: float
    # the smoother's Richardson step sizes over 1/diag, one per step of a
    # sweep: [omega] for damped Jacobi, the Chebyshev ones otherwise
    steps: Optional[np.ndarray] = None
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


def _csr_fill_banded(A: sp.csr_matrix, band):
    """Refill a block-banded layout with the values of ``A``, keeping the
    window geometry (w0, W) and so every array's shape; ``A`` has the
    sparsity of the matrix the layout was built from up to small drift:
    far entries that disappeared are padded with zeros, the smallest
    extra ones dropped (the JAX package's ``_csr_fill_banded``)."""
    windows, fr, fc, fv, n, m = band
    A = A.tocsr()
    assert A.shape == (n, m)
    indptr, indices, data = A.indptr, A.indices, A.data
    rows = np.repeat(np.arange(n), np.diff(indptr))
    R = windows[0][0].shape[1]
    blk = rows // R
    remaining = np.ones(A.nnz, bool)
    new_windows = []
    for slabT_old, w0, W in windows:
        loc = indices - w0[blk]
        inside = remaining & (loc >= 0) & (loc < W)
        slabT = np.zeros_like(slabT_old)
        slabT[blk[inside] * W + loc[inside], rows[inside] % R] = data[inside]
        new_windows.append((slabT, w0, W))
        remaining = remaining & ~inside
    far_rows = rows[remaining].astype(np.int32)
    far_cols = indices[remaining].astype(np.int32)
    far_vals = data[remaining]
    target = len(fr)
    if len(far_rows) < target:
        pad = target - len(far_rows)
        far_rows = np.concatenate([far_rows, np.zeros(pad, np.int32)])
        far_cols = np.concatenate([far_cols, np.zeros(pad, np.int32)])
        far_vals = np.concatenate([far_vals, np.zeros(pad, far_vals.dtype)])
    elif len(far_rows) > target:
        keep = np.argsort(np.abs(far_vals))[::-1][:target]
        far_rows, far_cols, far_vals = far_rows[keep], far_cols[keep], far_vals[keep]
    return new_windows, far_rows, far_cols, far_vals, n, m


def _drop_guard(what: str, ilev: int, total: float, kept: float, max_drop_frac: float):
    if total > 0 and (total - kept) > max_drop_frac * total:
        raise ValueError(
            f"{what} at level {ilev} dropped {(total - kept) / total:.2e} of |A| "
            f"mass (> {max_drop_frac:.0e}): sparsity pattern drifted")


def _band_mass(band) -> float:
    windows, _, _, fv, _, _ = band
    return float(sum(np.abs(w[0]).sum() for w in windows) + np.abs(fv).sum())


def _device_band(band, dtype, device, slab_dtype=None):
    """A :func:`_csr_to_banded` layout as device tensors: each window in
    the packed form K7/K8 read (``ops/banded.py::pack_window``, values in
    ``slab_dtype``, default ``dtype``; the dense slab stays on the host),
    the far COO list as a CSR by row of its capacity
    (``ops/ell.py::device_far``, values in ``dtype``), which K5/K6b's
    kernel adds row by row; the COO triplets stay on the host."""
    if band is None:
        return None
    windows, far_rows, far_cols, far_vals, n, m = band
    return dict(
        windows=[band_ops.pack_window(sT, w0, W, slab_dtype or dtype, device)
                 for sT, w0, W in windows],
        far=ell_ops.device_far(far_rows, far_cols, far_vals, n, m, dtype, device)
        if len(far_rows) else None, n=n, m=m,
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
    # the cycle index: 1 V-cycle, 2 W-cycle
    gamma: int = 1
    perm: Optional[np.ndarray] = None

    def device(self, dtype, device, band_dtype=None) -> "DeviceMG":
        """Upload to ``device`` in ``dtype``.  A windowed-ELL layout gets
        the device forms its applies read: the sliced form (K4 on one
        vector, K6a on B) where a cycle applies it forward, the
        transposed form (the CSR of P^T that K5/K6b gather from) where it
        restricts through it.  ``band_dtype`` is the STORAGE
        type of the fine-level smoothing slab's packed values
        (``torch.bfloat16`` halves their bytes; default ``dtype``): the
        kernel upcasts each value after the read and never rounds the
        vector, so the preconditioner stays one fixed linear operator.
        It applies to ``levels[0].a_band``
        only: the Galerkin coarse operators and the transfers must keep
        the near-null space exactly."""
        as_f = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
        as_i = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64, device=device)
        iperm = np.argsort(self.perm) if self.perm is not None else None
        dev_band = lambda band, slab_dt=None: _device_band(band, dtype, device, slab_dt)
        # the forms each layout needs (sliced, transposed): p_ellw and
        # pt_ellw are often one layout, applied forward and transposed
        need = {}
        for lv in self.levels:
            for w in ("a", "ap", "p", "pt"):
                e = getattr(lv, w + "_ellw")
                if e is not None:
                    sl, tr = need.get(id(e), (False, False))
                    need[id(e)] = (sl or w != "pt", tr or w == "pt")
        ellw_done = {}

        def dev_ellw(e):
            if e is None:
                return None
            if id(e) not in ellw_done:
                sl, tr = need[id(e)]
                ellw_done[id(e)] = e.device(dtype, device, sliced=sl, transposed=tr)
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
                # a tensor, so that a refill can overwrite it in place
                steps=as_f(lv.steps if lv.steps is not None else [lv.omega]),
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
            out, as_f(self.coarse_V), as_f(self.coarse_ilam), self.nu, gamma=self.gamma,
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
    smoother: str = "jacobi",
    degree: int = 3,
    gamma: int = 1,
    slab_dtype=np.float64,
    band_cap: int = BAND_CAP,
    tband_cap: int = TBAND_CAP,
) -> MGHierarchy:
    """Build the SA hierarchy of ``knpemi_tpu/solvers/mg.py::build_hierarchy``.
    ``B`` is the near-null vector of A0 (1/s for an operator equilibrated
    by S = diag(s)).  ``smoother``: ``"jacobi"`` (one damped step a sweep)
    or ``"cheby"`` (``degree`` Chebyshev-Richardson steps a sweep);
    ``nu`` sweeps before and after the coarse correction; ``gamma`` the
    cycle index (2: W-cycle).

    With ``fine_ell`` the finest operator is stored too and the V-cycle
    smooths with it, not with the caller's.  ``"auto"`` means yes, except
    that with ``banded`` a finest operator that takes neither the banded
    nor the windowed-ELL layout is dropped again.

    With ``banded`` every level operator, transfer and A P product gets a
    block-banded layout (:func:`_csr_to_banded`, slabs in ``slab_dtype``)
    within ``BAND_CAP`` bytes per level operator and ``TBAND_CAP`` per
    transfer or product (``band_cap`` / ``tband_cap``: the sharded
    mode's larger budgets, ``parallel/sharded_mg.py``), or else a
    windowed-ELL layout
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
        lv = MGLevel(n=n, diag=diag, omega=4.0 / (3.0 * lam), P_csr=P,
                     steps=_smoother_steps(lam, smoother, degree))
        if levels or fine_ell:
            lv.a_cols, lv.a_vals = _csr_to_ell(A)
        lv.p_cols, lv.p_vals = _csr_to_ell(P, pad_diag=False)
        lv.pt_cols, lv.pt_vals = _csr_to_ell(P.T.tocsr(), pad_diag=False)
        AP = (A @ P).tocsr()  # reused below for the Galerkin RAP
        if banded:
            if lv.a_cols is not None:
                lv.a_band = _csr_to_banded(A, mem_cap=band_cap, dtype=slab_dtype)
                if lv.a_band is None:
                    lv.a_ellw = ell_ops.build_ellw(A)
                # fused post-smooth operand (see MGLevel.ap_band); only
                # where the level smooths with its own lagged operator —
                # with the caller's current fine operator a lagged AP
                # would break the cycle's symmetry
                lv.ap_band = _csr_to_banded(AP, mem_cap=tband_cap, dtype=slab_dtype)
                if lv.ap_band is None:
                    lv.ap_ellw = ell_ops.build_ellw(AP)
            lv.p_band = _csr_to_banded(P, mem_cap=tband_cap, dtype=slab_dtype)
            if lv.p_band is None:
                # one windowed-ELL layout of P serves BOTH directions
                # (gather = P, scatter = P^T)
                lv.p_ellw = ell_ops.build_ellw(P)
                lv.pt_ellw = lv.p_ellw
            else:
                lv.pt_band = _csr_to_banded(P.T.tocsr(), mem_cap=tband_cap,
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
    return MGHierarchy(levels=levels, coarse_V=V, coarse_ilam=ilam, nu=nu, gamma=gamma)


# cache-key version: bump whenever build_hierarchy's algorithm changes
_BUILD_VERSION = "torch-v3"  # v3: smoother steps, the cycle index
CACHE_DIR = Path(__file__).resolve().parents[1] / "build" / "mg_cache"
# the cache's bound in bytes (the JAX package's default, 24 GiB)
CACHE_MAX_BYTES = 24 << 30


def _bands(hier: MGHierarchy):
    for lv in hier.levels:
        for attr in ("a_band", "ap_band", "p_band", "pt_band"):
            if getattr(lv, attr) is not None:
                yield lv, attr


def _cast_band_dtype(hier: MGHierarchy, slab_dtype) -> MGHierarchy:
    """Cast a loaded hierarchy's banded slabs to ``slab_dtype`` in place, so
    that one cache entry serves every run dtype (a slab built in float64
    and cast is the slab a float32 build writes: both round each value
    to nearest)."""
    for lv, attr in _bands(hier):
        windows, fr, fc, fv, n, m = getattr(lv, attr)
        if windows and windows[0][0].dtype != np.dtype(slab_dtype):
            windows = [(sT.astype(slab_dtype), w0, W) for sT, w0, W in windows]
            setattr(lv, attr, (windows, fr, fc, fv, n, m))
    return hier


def _serves(hier: MGHierarchy, slab_dtype) -> bool:
    """Whether a cached hierarchy's slabs hold ``slab_dtype``'s precision:
    a float32 entry cannot serve a float64 run."""
    want = np.dtype(slab_dtype).itemsize
    return all(w[0].dtype.itemsize >= want
               for lv, attr in _bands(hier) for w in getattr(lv, attr)[0])


def _evict_lru(cache_dir, keep=None, max_bytes: int = CACHE_MAX_BYTES) -> None:
    """Bound the hierarchy cache ``cache_dir``: remove its ``.pkl`` entries,
    oldest modification time first (a hit touches its entry), until they
    take at most ``max_bytes``; never ``keep``.  Only ``.pkl`` files
    directly in ``cache_dir`` are considered.  Best effort: a file another
    process removed is skipped."""
    keep = None if keep is None else os.fspath(keep)
    try:
        entries = []
        with os.scandir(cache_dir) as it:
            for d in it:
                if not d.name.endswith(".pkl"):
                    continue
                try:
                    st = d.stat()
                except OSError:
                    continue
                entries.append((st.st_mtime, st.st_size, d.path))
        total = sum(size for _, size, _ in entries)
        for _, size, path in sorted(entries):
            if total <= max_bytes:
                break
            if path == keep:
                continue
            try:
                os.remove(path)
                total -= size
            except OSError:
                continue
    except OSError:
        return


def build_hierarchy_cached(A0: sp.csr_matrix, B: Optional[np.ndarray] = None,
                           cache_dir: Optional[Path] = None, **kw) -> MGHierarchy:
    """Disk-cached :func:`build_hierarchy`, keyed by the operator's exact CSR
    content, the near-null vector and every build parameter (theta, the
    smoother, its degree, nu, the cycle index, ...) except
    ``slab_dtype``: the slabs are storage only, so an entry serves every
    run dtype of at most its slabs' precision, cast on load
    (:func:`_cast_band_dtype`); a narrower entry is rebuilt and
    replaced.  The cache is the port's own (``knpemi_tpu_torch/build/mg_cache``, git-ignored):
    the JAX package's pickles hold its own classes.  A hit touches its
    entry; after a build the cache is bounded to ``CACHE_MAX_BYTES``
    (:func:`_evict_lru`)."""
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
    slab_dtype = kw.get("slab_dtype", np.float64)
    h.update(repr(sorted((k, v) for k, v in kw.items() if k != "slab_dtype")).encode())
    path = cache_dir / (h.hexdigest()[:32] + ".pkl")
    if path.exists():
        try:
            with open(path, "rb") as f:
                hier = pickle.load(f)
            if _serves(hier, slab_dtype):
                try:
                    os.utime(path)  # eviction goes by modification time
                except OSError:
                    pass
                return _cast_band_dtype(hier, slab_dtype)
        except Exception:
            pass  # corrupt entry: rebuild below
    hier = build_hierarchy(A, B=B, **kw)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    try:
        # a watchdog alarm (signal.alarm) landing mid-dump would orphan
        # the .tmp and lose the build: cooperating handlers defer it
        # until the entry is on disk (utils/critical.py)
        with critical_section():
            cache_dir.mkdir(parents=True, exist_ok=True)
            with open(tmp, "wb") as f:
                pickle.dump(hier, f, protocol=4)
            os.replace(tmp, path)
    except BaseException as exc:
        tmp.unlink(missing_ok=True)
        # caching is best-effort, but an interruption (KeyboardInterrupt,
        # a watchdog's TimeoutError) goes on to the caller
        if not isinstance(exc, OSError):
            raise
    _evict_lru(cache_dir, keep=path)
    return hier


def refresh_hierarchy(hier: MGHierarchy, A_hat_new: sp.csr_matrix,
                      max_drop_frac: float = 1e-5) -> MGHierarchy:
    """The values of ``hier`` for a new operator ``A_hat_new`` of the same
    structure (already permuted by ``hier.perm``), every array's shape
    kept: the JAX package's ``refresh_hierarchy``, which it runs every
    ``mg_refresh_every`` steps on the EMI hierarchy.

    The transfers P are FROZEN at their setup values; each level's
    operator is recomputed as the Galerkin product P^T A P with the
    frozen P, its diagonal, its smoother weight and steps (Chebyshev
    ones of the level's degree) from a new power iteration, its stored
    ELL, banded and windowed-ELL layouts refilled in their frozen
    shapes, and the coarsest level re-factored by eigh.
    Small pattern drift (float32 kappa rounding makes and unmakes exact
    zeros) is tolerated as there: entries that vanished leave zeros, the
    smallest extra ones are dropped.  Raises ``ValueError`` where a
    refill drops more than ``max_drop_frac`` of a level's |A| (or |AP|)
    mass, where a windowed-ELL layout no longer fits
    (``build_ellw(force_shape)``), or on a level-size mismatch: the
    caller keeps the stale hierarchy."""
    A = A_hat_new.tocsr()
    new_levels: List[MGLevel] = []
    for ilev, lv in enumerate(hier.levels):
        if A.shape[0] != lv.n:
            raise ValueError("level size mismatch during refresh")
        diag = A.diagonal()
        diag = np.where(np.abs(diag) > 0, diag, 1.0)
        lam = _lam_max_jacobi(A)
        deg = 1 if lv.steps is None else len(lv.steps)
        nl = MGLevel(
            n=lv.n, diag=diag, omega=4.0 / (3.0 * lam),
            steps=_smoother_steps(lam, "cheby" if deg > 1 else "jacobi", deg),
            p_cols=lv.p_cols, p_vals=lv.p_vals,
            pt_cols=lv.pt_cols, pt_vals=lv.pt_vals,
            p_band=lv.p_band, pt_band=lv.pt_band,
            # transfer ellw layouts are frozen with P itself
            p_ellw=lv.p_ellw, pt_ellw=lv.pt_ellw, P_csr=lv.P_csr,
        )
        total_mass = float(np.abs(A.data).sum())
        if lv.a_cols is not None:
            nl.a_cols, nl.a_vals = _csr_to_ell(A, K=lv.a_vals.shape[1])
            _drop_guard("ELL refill", ilev, total_mass,
                        float(np.abs(nl.a_vals).sum()), max_drop_frac)
        if lv.a_band is not None:
            nl.a_band = _csr_fill_banded(A, lv.a_band)
            _drop_guard("banded refill", ilev, total_mass, _band_mass(nl.a_band),
                        max_drop_frac)
        if lv.a_ellw is not None:
            e = lv.a_ellw
            nl.a_ellw = ell_ops.build_ellw(A, force_shape=(e.C, e.K, e.Wr, e.G, e.far_cap))
        AP = (A @ lv.P_csr).tocsr()  # reused for the Galerkin RAP below
        if lv.ap_ellw is not None:
            e = lv.ap_ellw
            nl.ap_ellw = ell_ops.build_ellw(AP, force_shape=(e.C, e.K, e.Wr, e.G, e.far_cap))
        if lv.ap_band is not None:
            nl.ap_band = _csr_fill_banded(AP, lv.ap_band)
            _drop_guard("AP banded refill", ilev, float(np.abs(AP.data).sum()),
                        _band_mass(nl.ap_band), max_drop_frac)
        new_levels.append(nl)
        A = (lv.P_csr.T @ AP).tocsr()
    lam, V = np.linalg.eigh(A.toarray())
    lmax = np.abs(lam).max() if len(lam) else 1.0
    ilam = np.where(np.abs(lam) > 1e-10 * lmax, 1.0 / lam, 0.0)
    return MGHierarchy(levels=new_levels, coarse_V=V, coarse_ilam=ilam,
                       nu=hier.nu, gamma=hier.gamma, perm=hier.perm)


# ---------------------------------------------------------------------------
# device-side application
# ---------------------------------------------------------------------------
def _ell_mv(cols, vals, x):
    return (vals * x[cols]).sum(dim=1)


def _ell_mv_batch(cols, vals, X):
    return (vals[None] * X[:, cols]).sum(dim=-1)


def _banded_mv(band, x, batch: bool):
    """y = A x (or Y = X A^T for X (B, m)) with A in multi-window
    block-banded form: each packed window through K7 (K8 for a batch, one
    read of its nonzeros for all B vectors), summed, plus the far
    remainder, each row's entries in a fixed order (``ell.csr_add`` on
    K5/K6b's kernel): the same bits from every call."""
    mv = band_ops.banded_matvec_batch if batch else band_ops.banded_matvec
    y = None
    for win in band["windows"]:
        ys = mv(win, x, band["n"])
        y = ys if y is None else y + ys
    if band["far"] is not None:
        # y is this call's own (a plain window sum may be a strided view)
        y = ell_ops.csr_add(band["far"], x, y.contiguous())
    return y


class DeviceMG:
    """The multigrid cycle on the device: ``nu`` smoothing sweeps before
    and after the coarse correction (``post_smooth=False``: none after,
    the V(nu, 0) cycle, for flexible GMRES only), each sweep the level's
    Richardson steps over 1/diag (damped Jacobi: one; Chebyshev:
    ``degree``), the coarse problem solved ``gamma`` times (2: the
    W-cycle).  Level operators are the lagged matrices, each in the
    first form it has of block-banded, windowed ELL and plain ELL; a
    level-0 without one smooths with the operator the caller passes.
    ``fine_diag`` (set by the caller) is the raw diagonal of the operator
    the hierarchy was built from, the solvers' lagged equilibration
    scale."""

    def __init__(self, levels, coarse_V, coarse_ilam, nu, gamma: int = 1, perm=None,
                 iperm=None, fine_diag=None, post_smooth: bool = True):
        self.levels = levels
        self.coarse_V = coarse_V
        self.coarse_ilam = coarse_ilam
        self.nu = nu
        self.gamma = gamma
        self.post_smooth = post_smooth
        self.perm = perm
        self.iperm = iperm
        self.fine_diag = fine_diag

    def refill_arrays(self, hier: MGHierarchy, max_drop_frac: float = 1e-5):
        """What :meth:`install` copies to give this cycle the values of
        ``hier``, a refreshed copy of the host hierarchy it was uploaded
        from: ``([(device tensor, host array)], stats)``.  Host numpy only
        (safe on a worker thread): the diagonals, smoother weights, the
        lagged operators' ELL, windowed-ELL (sliced form) and packed band
        values, AP's, and the coarse factors; the transfers are frozen,
        and with them the transposed forms K5/K6b read.  A packed band
        window and a sliced form keep the slots they were built with: a
        refreshed nonzero without a slot is dropped and counted in
        ``stats`` (``band_dropped``, ``band_dropped_frac`` of the
        window's |A| mass; ``ellw_dropped``, ``ellw_dropped_frac`` of the
        layout's), and more than ``max_drop_frac`` raises
        ``ValueError``."""
        iperm = None if hier.perm is None else np.argsort(hier.perm)
        pairs, stats = [], dict(band_dropped=0, band_dropped_frac=0.0,
                                ellw_dropped=0, ellw_dropped_frac=0.0)
        if len(hier.levels) != len(self.levels):
            raise ValueError("the refreshed hierarchy has another number of levels")
        for i, (lv, hl) in enumerate(zip(self.levels, hier.levels)):
            dinv = 1.0 / hl.diag
            steps = hl.steps if hl.steps is not None else np.array([hl.omega])
            pairs += [(lv["dinv"], dinv), (lv["steps"], steps)]
            if lv["dinv_solver"] is not None:
                pairs.append((lv["dinv_solver"], dinv[iperm]))
            if lv["a_cols"] is not None:
                pairs += [(lv["a_cols"], hl.a_cols), (lv["a_vals"], hl.a_vals)]
            for w in ("a", "ap"):
                band, hband = lv[w + "_band"], getattr(hl, w + "_band")
                if band is not None:
                    windows, far_rows, far_cols, far_vals, _, _ = hband
                    dropped = 0.0
                    for win, (slabT, _, _) in zip(band["windows"], windows):
                        wp, nd, mass = band_ops.repack_window(win, slabT)
                        pairs += wp
                        stats["band_dropped"] += nd
                        dropped += mass
                    frac = dropped / max(_band_mass(hband), 1e-300)
                    stats["band_dropped_frac"] = max(stats["band_dropped_frac"], frac)
                    if frac > max_drop_frac:
                        raise ValueError(
                            f"packed {w}_band refill at level {i} dropped {frac:.2e} "
                            f"of its |A| mass (> {max_drop_frac:.0e}): no slot for "
                            "a refreshed nonzero")
                    far = band["far"]
                    if far is not None:
                        # the refreshed list, sorted by row anew into the
                        # frozen capacity: its rows may have moved
                        ptr, col, val = ell_ops.far_csr(far_rows, far_cols, far_vals,
                                                        far.n_rows, far.col.shape[0])
                        pairs += [(far.row_ptr, ptr), (far.col, col), (far.val, val)]
                e = lv[w + "_ellw"]
                if e is not None:
                    ep, nd, frac = getattr(hl, w + "_ellw").refill_arrays(e, max_drop_frac)
                    pairs += ep
                    stats["ellw_dropped"] += nd
                    stats["ellw_dropped_frac"] = max(stats["ellw_dropped_frac"], frac)
        pairs += [(self.coarse_V, hier.coarse_V), (self.coarse_ilam, hier.coarse_ilam)]
        for t, a in pairs:
            if tuple(t.shape) != tuple(np.shape(a)):
                raise ValueError(f"refill of shape {np.shape(a)} into a tensor of "
                                 f"shape {tuple(t.shape)}")
        return pairs, stats

    @staticmethod
    def install(pairs):
        """Copy each host array into its device tensor in place (stream-
        ordered ``copy_``): shapes and storage stay as they were."""
        with torch.no_grad():
            for t, a in pairs:
                t.copy_(torch.as_tensor(np.asarray(a)))

    def tensors(self):
        """Every device tensor of the cycle (for checks that a refill keeps
        them in place)."""
        out = [self.coarse_V, self.coarse_ilam]
        for t in (self.perm, self.iperm, self.fine_diag):
            if t is not None:
                out.append(t)
        for lv in self.levels:
            for key, v in lv.items():
                if torch.is_tensor(v):
                    out.append(v)
                elif isinstance(v, dict):  # a band
                    if v["far"] is not None:
                        out += [v["far"].row_ptr, v["far"].col, v["far"].val]
                    for win in v["windows"]:
                        out += [win.slot_ptr, win.off, win.val, win.w0]
                elif isinstance(v, ell_ops.DeviceELLW):
                    out += [t for t in (v.slot_ptr, v.scol, v.sval, v.trow_ptr, v.tcol,
                                        v.tval) if t is not None]
        return out

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
            # the stored layout is always of P; restriction gathers from
            # its transposed form
            if which == "pt":
                mv = ell_ops.ellw_rmatvec_batch if batch else ell_ops.ellw_rmatvec
            else:
                mv = ell_ops.ellw_matvec_batch if batch else ell_ops.ellw_matvec
            return mv(ellw, x)
        mv = _ell_mv_batch if batch else _ell_mv
        return mv(lv[which + "_cols"], lv[which + "_vals"], x)

    def _fused_post(self, lv) -> bool:
        """Take the post-smoothing residual as res1 - (AP) xc instead of a
        second full-operator apply.  Valid only for the plain V(1,1)
        Jacobi cycle (one step a sweep, nu = 1, post-smoothing on) on a
        level that smooths with its LAGGED operator (AP is lagged too; AP
        is only ever stored for such a level).  A banded AP always fuses;
        a windowed-ELL AP only when the JAX package's static work product
        NCH*Wr*K*C says it is cheaper than the operator's own layout —
        a TPU cost rule, kept so both cycles do the same arithmetic."""
        if self.nu != 1 or not self.post_smooth or lv["steps"].shape[0] != 1:
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

    def _smooth(self, A, dinv, steps, r, x, sweeps: int, reverse: bool = False):
        """``sweeps`` sweeps of the Richardson steps x += step (dinv (r - A
        x)), in reverse order for the post-smoothing (the cycle stays
        symmetric)."""
        order = range(steps.shape[0] - 1, -1, -1) if reverse else range(steps.shape[0])
        for _ in range(sweeps):
            for j in order:
                x = x + steps[j] * (dinv * (r - A(x)))
        return x

    def _smooth_pre(self, A, dinv, steps, r):
        # the first step from x = 0 needs no operator apply
        x = steps[0] * (dinv * r)
        for j in range(1, steps.shape[0]):
            x = x + steps[j] * (dinv * (r - A(x)))
        return self._smooth(A, dinv, steps, r, x, self.nu - 1)

    def _coarse_correction(self, i: int, A0, rc, batch: bool):
        """The correction from level i + 1: the cycle there, repeated
        gamma - 1 times on its own residual (the W-cycle for gamma = 2)."""
        xc = self._cycle(i + 1, A0, rc, batch)
        if i + 1 < len(self.levels):
            Ac = self._op(i + 1, A0, batch)
            for _ in range(self.gamma - 1):
                xc = xc + self._cycle(i + 1, A0, rc - Ac(xc), batch)
        return xc

    def _fine_solver_cycle(self, A0, r, gather, scatter, batch: bool):
        """Level-0 smoothing in the caller's dof layout with its operator;
        the coarse sub-cycle runs in the hierarchy's permuted layout."""
        lv = self.levels[0]
        dinv, steps = lv["dinv_solver"], lv["steps"]
        x = self._smooth_pre(A0, dinv, steps, r)
        res1 = r - A0(x)
        rc = self._transfer(lv, "pt", gather(res1), batch)
        xc = self._coarse_correction(0, None, rc, batch)  # coarse levels: lagged
        x = x + scatter(self._transfer(lv, "p", xc, batch))
        if not self.post_smooth:
            return x
        return self._smooth(A0, dinv, steps, r, x, self.nu, reverse=True)

    def _cycle(self, i: int, A0, r, batch: bool):
        if i == len(self.levels):
            return self._coarse(r, batch)
        lv = self.levels[i]
        A = self._op(i, A0, batch)
        dinv, steps = lv["dinv"], lv["steps"]
        x = self._smooth_pre(A, dinv, steps, r)
        res1 = r - A(x)
        rc = self._transfer(lv, "pt", res1, batch)
        xc = self._coarse_correction(i, A0, rc, batch)
        x = x + self._transfer(lv, "p", xc, batch)
        if not self.post_smooth:
            return x
        if self._fused_post(lv):
            # res(x + P xc) = res1 - (AP) xc: the same arithmetic from a
            # much smaller read than a second full-operator apply
            res2 = res1 - self._ap_apply(lv, xc, batch)
            return x + steps[0] * (dinv * res2)
        return self._smooth(A, dinv, steps, r, x, self.nu, reverse=True)
