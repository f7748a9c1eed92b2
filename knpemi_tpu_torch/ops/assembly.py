"""The six Hopper assembly kernels of the coupled step, with plain twins.

Each wrapper below launches a hand-written CUDA kernel (``ops/csrc``,
built by :mod:`._build`) for CUDA tensors and uses its plain PyTorch
version for CPU tensors — the only reason it ever takes the plain path.
On a CUDA tensor it launches or raises; there is no fallback.  Every
wrapper counts its launches in a plain integer attribute
(``wrapper.launches``) and checks device, dtype, shape and contiguity.

The JAX package's TPU kernels compute the same operators through one-hot
MXU products, bf16 split passes, 128-lane alignment, Morton windows and
an XLA tail of outlier cells (``knpemi_tpu/ops/pallas_assembly.py:1-36``,
``pallas_ell.py:1-42``) — all of it a way around slow random gathers on
the TPU.  On Hopper a gather is a load: every cell or facet goes through
one kernel that reads its k vertex values, does a few dozen flops in
registers and atomically adds k results.  None of the kernels does
enough arithmetic per byte to be compute-bound; the least time each can
take is the bytes it must move over the card's 3.35 TB/s.

Sums taken with ``atomicAdd`` are order-dependent: a kernel agrees with
its plain version to ~1e-5 max|y| in float32 and ~1e-12 max|y| in
float64, not bit for bit.

Index tensors: int32 on CUDA (the kernels' type), int32 or int64 on the
CPU.
"""

from __future__ import annotations

import ctypes

import torch

from . import kernels as K
from . import _build

_c_int = ctypes.c_int
_c_ptr = ctypes.c_void_p

# C signatures of ops/csrc/*.cu: (library, entry point, argument types)
_SIGS = {
    "emi_stiffness": ("cells", "knp_emi_stiffness",
                      [_c_int] + [_c_ptr] * 5 + [_c_int] * 3 + [_c_ptr]),
    "knp_apply_batch": ("cells", "knp_knp_apply_batch",
                        [_c_int] + [_c_ptr] * 7 + [_c_int] * 5 + [_c_ptr]),
    "ell_matvec": ("cells", "knp_ell_matvec",
                   [_c_int] + [_c_ptr] * 4 + [_c_int] * 2 + [_c_ptr]),
    "facet_mass": ("facets", "knp_facet_mass",
                   [_c_int] + [_c_ptr] * 4 + [_c_int] * 2 + [_c_ptr]),
    "facet_gather": ("facets", "knp_facet_gather",
                     [_c_int] + [_c_ptr] * 3 + [_c_int] * 4 + [_c_ptr]),
    "facet_scatter": ("facets", "knp_facet_scatter",
                      [_c_int] + [_c_ptr] * 3 + [_c_int] * 4 + [_c_ptr]),
    # ops/ell.py and ops/banded.py
    "ell_rmatvec": ("mg", "knp_ell_rmatvec",
                    [_c_int] + [_c_ptr] * 4 + [_c_int] * 2 + [_c_ptr]),
    "ell_matvec_batch": ("mg", "knp_ell_matvec_batch",
                         [_c_int] + [_c_ptr] * 4 + [_c_int] * 4 + [_c_ptr]),
    "ell_rmatvec_batch": ("mg", "knp_ell_rmatvec_batch",
                          [_c_int] + [_c_ptr] * 4 + [_c_int] * 4 + [_c_ptr]),
    "banded_matvec": ("mg", "knp_banded_matvec",
                      [_c_int] * 2 + [_c_ptr] * 4 + [_c_int] * 5 + [_c_ptr]),
    "banded_matvec_batch": ("mg", "knp_banded_matvec_batch",
                            [_c_int] * 2 + [_c_ptr] * 4 + [_c_int] * 6 + [_c_ptr]),
}
_FNS = {}

_FLOAT = (torch.float32, torch.float64)
# vectors per launch of the batched multigrid kernels (csrc/mg.cu keeps
# their accumulators in registers); a larger batch goes through in groups
BATCH_MAX = 8


def index_dtype(device) -> torch.dtype:
    """Index type of the cell/facet arrays the kernels take on ``device``."""
    return torch.int32 if torch.device(device).type == "cuda" else torch.int64


def _launch(kernel: str, ref: torch.Tensor, *args):
    """Call the C entry point of ``kernel`` on the current stream of
    ``ref``'s device; raise on a nonzero cudaGetLastError()."""
    fn = _FNS.get(kernel)
    if fn is None:
        lib_name, sym, argtypes = _SIGS[kernel]
        fn = getattr(_build.library(lib_name), sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[kernel] = fn
    stream = torch.cuda.current_stream(ref.device).cuda_stream
    code = 0 if ref.dtype == torch.float32 else 1
    err = fn(code, *args, stream)
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {err}")


def _check(t: torch.Tensor, name: str, like: torch.Tensor, shape=None,
           index: bool = False):
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, expected {like.device}")
    if index:
        ok = (torch.int32,) if like.is_cuda else (torch.int32, torch.int64)
        if t.dtype not in ok:
            raise TypeError(f"{name} must be {ok}, got {t.dtype}")
    elif t.dtype != like.dtype:
        raise TypeError(f"{name} is {t.dtype}, expected {like.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_value(x: torch.Tensor, name: str):
    if x.dtype not in _FLOAT:
        raise TypeError(f"{name} must be float32 or float64, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_mesh(k: int, dim: int):
    if (k, dim) not in ((4, 3), (3, 2)):
        raise ValueError(f"cells must be triangles or tetrahedra, got k={k}, dim={dim}")


# ---------------------------------------------------------------------------
# K1: EMI weighted stiffness
# ---------------------------------------------------------------------------
def emi_stiffness_plain(x, cells, grads, wv):
    return K.stiffness_apply(x.shape[0], x, cells.long(), grads, wv)


def emi_stiffness(x, cells, grads, wv):
    """K1.  y = sum_cells wv_c (g_i . grad x) over the P1 basis gradients
    g of each cell, with wv_c = vol_c * mean-vertex kappa (see
    :func:`ell_matvec`); unit wv gives the plain stiffness.

    Replaces ``knpemi_tpu/ops/pallas_assembly.py:_make_emi_kernel``
    (via ``emi_stiffness_blocked``).  Bound on the H100: bytes —
    x, cells, grads, wv read once, y written once (``csrc/cells.cu``).
    Design: one thread per cell, k exact gathers, k atomic adds.

    x (n,), cells (nc, k), grads (nc, k, dim), wv (nc,) -> y (n,)."""
    _check_value(x, "x")
    nc, k = cells.shape
    dim = grads.shape[-1]
    _check_mesh(k, dim)
    _check(cells, "cells", x, index=True)
    _check(grads, "grads", x, (nc, k, dim))
    _check(wv, "wv", x, (nc,))
    if not x.is_cuda:
        return emi_stiffness_plain(x, cells, grads, wv)
    y = torch.zeros_like(x)
    _launch("emi_stiffness", x, x.data_ptr(), cells.data_ptr(),
            grads.data_ptr(), wv.data_ptr(), y.data_ptr(), nc, k, dim)
    emi_stiffness.launches += 1
    return y


emi_stiffness.launches = 0


# ---------------------------------------------------------------------------
# K3: batched KNP operator
# ---------------------------------------------------------------------------
def knp_apply_batch_plain(X, cells, grads, vols, w, coef):
    c = cells.long()
    n = X.shape[1]
    return torch.stack([
        coef[b, 0] * K.mass_apply(n, x, c, vols)
        + coef[b, 1] * K.stiffness_apply(n, x, c, grads, vols)
        + coef[b, 2] * K.drift_apply(n, x, c, grads, vols, w)
        for b, x in enumerate(X)
    ])


def knp_apply_batch(X, cells, grads, vols, w, coef):
    """K3.  For every row b of X (one solved ion),
    y_b = dt_inv_b M x_b + D_b K x_b + zpsiD_b Drift(w) x_b with M the P1
    mass, K the P1 stiffness and Drift the P1 drift along the per-cell
    vector w = grad(phi).  ``coef`` rows are [dt_inv, D, z psi D]; the
    KNP right-hand side's mass term is the call with D = z = 0.

    Replaces ``knpemi_tpu/ops/pallas_assembly.py:_make_knp_kernel_batch``
    (via ``knp_apply_blocked_batch``).  Bound on the H100: bytes — X,
    cells, grads, vols, w, coef read once, Y written once
    (``csrc/cells.cu``).  Design: one thread per cell reads the cell's
    geometry and w once and loops over the B rows inside the thread.

    X (B, n), cells (nc, k), grads (nc, k, dim), vols (nc,), w (nc, dim),
    coef (B, 3) -> Y (B, n)."""
    _check_value(X, "X")
    B, n = X.shape
    nc, k = cells.shape
    dim = grads.shape[-1]
    _check_mesh(k, dim)
    _check(cells, "cells", X, index=True)
    _check(grads, "grads", X, (nc, k, dim))
    _check(vols, "vols", X, (nc,))
    _check(w, "w", X, (nc, dim))
    _check(coef, "coef", X, (B, 3))
    if not X.is_cuda:
        return knp_apply_batch_plain(X, cells, grads, vols, w, coef)
    Y = torch.zeros_like(X)
    _launch("knp_apply_batch", X, X.data_ptr(), cells.data_ptr(),
            grads.data_ptr(), vols.data_ptr(), w.data_ptr(),
            coef.data_ptr(), Y.data_ptr(), nc, n, B, k, dim)
    knp_apply_batch.launches += 1
    return Y


knp_apply_batch.launches = 0


# ---------------------------------------------------------------------------
# K4: ELL SpMV of the frozen dof -> cell coefficient maps
# ---------------------------------------------------------------------------
def ell_matvec_plain(cols, vals, x):
    return (vals * x[cols.long()]).sum(dim=1)


def ell_matvec(cols, vals, x):
    """K4.  y = A x for A in ELL form: y[r] = sum_k vals[r, k] x[cols[r, k]]
    (padded slots hold value 0).  The port's per-solve coefficient maps
    are such matrices: mean-vertex kappa per cell and grad(phi) per cell
    (see :func:`cell_mean_ell` / :func:`cell_gradient_ell`).

    Replaces ``knpemi_tpu/ops/pallas_ell.py:_make_gather_kernel`` (via
    ``ellw_matvec``), without its windows, bf16 passes or far-COO spill:
    the GPU gathers exactly.  Bound on the H100: bytes — cols, vals, x
    read once, y written once (``csrc/cells.cu``).  Design: one thread per
    row.

    cols (R, K) index, vals (R, K), x (m,) -> y (R,)."""
    _check_value(x, "x")
    R, Kw = cols.shape
    _check(cols, "cols", x, index=True)
    _check(vals, "vals", x, (R, Kw))
    if not x.is_cuda:
        return ell_matvec_plain(cols, vals, x)
    y = torch.empty(R, dtype=x.dtype, device=x.device)
    _launch("ell_matvec", x, cols.data_ptr(), vals.data_ptr(), x.data_ptr(),
            y.data_ptr(), R, Kw)
    ell_matvec.launches += 1
    return y


ell_matvec.launches = 0


def _ell_from_cells(weights, cells, n_dofs):
    """Host ELL (cols, vals) of the dof -> cell map with per-slot
    ``weights`` (nc, R, k): row (c, r) is sum_j weights[c, r, j] x[cells[c, j]].
    Built through a scipy CSR (duplicates summed, columns sorted, zeros
    dropped) — the matrix ``pallas_assembly.py::build_interp_ellw``
    freezes; short rows are padded with value 0 at column 0."""
    import numpy as np
    import scipy.sparse as sp

    nc, R, k = weights.shape
    rows = np.broadcast_to(np.arange(nc * R).reshape(nc, R, 1), weights.shape)
    cols = np.broadcast_to(cells[:, None, :], weights.shape)
    A = sp.coo_matrix(
        (weights.ravel().astype(np.float64), (rows.ravel(), cols.ravel())),
        shape=(nc * R, n_dofs),
    ).tocsr()
    A.eliminate_zeros()
    nnz = np.diff(A.indptr)
    Kw = max(int(nnz.max()) if len(nnz) else 1, 1)
    r = np.repeat(np.arange(A.shape[0]), nnz)
    pos = np.arange(A.nnz) - np.repeat(A.indptr[:-1], nnz)
    ec = np.zeros((A.shape[0], Kw), np.int32)
    ev = np.zeros((A.shape[0], Kw), np.float64)
    ec[r, pos] = A.indices
    ev[r, pos] = A.data
    return ec, ev


def cell_mean_ell(cells, n_dofs):
    """ELL of the map kappa (n,) -> mean-vertex kappa per cell (nc,)."""
    import numpy as np

    k = cells.shape[1]
    w = np.full((cells.shape[0], 1, k), 1.0 / k)
    return _ell_from_cells(w, cells, n_dofs)


def cell_gradient_ell(cells, grads, n_dofs):
    """ELL of the map phi (n,) -> grad(phi) per cell, rows (c, d) in
    (nc, dim) order."""
    import numpy as np

    w = np.swapaxes(np.asarray(grads, np.float64), 1, 2)  # (nc, dim, k)
    return _ell_from_cells(w, cells, n_dofs)


# ---------------------------------------------------------------------------
# K2: membrane surface mass
# ---------------------------------------------------------------------------
def facet_mass_plain(x, facet_dofs, wv):
    f = facet_dofs.long()
    xe = x[f]
    vals = wv[:, None] * (xe.sum(dim=1, keepdim=True) + xe)
    return K.scatter_add(x.shape[0], f, vals)


def facet_mass(x, facet_dofs, wv):
    """K2.  y = M_Gamma x in membrane numbering: per facet f,
    y_i += wv_f (sum_j x_j + x_i) with wv_f = area_f / (k(k+1)); the caller
    applies C_phi.

    Replaces ``knpemi_tpu/ops/pallas_assembly.py:_make_facet_mass_kernel``
    (via ``facet_mass_blocked``).  Bound on the H100: bytes — x,
    facet_dofs, wv read once, y written once (``csrc/facets.cu``).
    Design: one thread per facet, k gathers, k atomic adds.

    x (n_mem,), facet_dofs (nf, k), wv (nf,) -> y (n_mem,)."""
    _check_value(x, "x")
    nf, k = facet_dofs.shape
    if k not in (2, 3):
        raise ValueError(f"facets must be edges or triangles, got k={k}")
    _check(facet_dofs, "facet_dofs", x, index=True)
    _check(wv, "wv", x, (nf,))
    if not x.is_cuda:
        return facet_mass_plain(x, facet_dofs, wv)
    y = torch.zeros_like(x)
    _launch("facet_mass", x, x.data_ptr(), facet_dofs.data_ptr(),
            wv.data_ptr(), y.data_ptr(), nf, k)
    facet_mass.launches += 1
    return y


facet_mass.launches = 0


# ---------------------------------------------------------------------------
# K9 / K10: facet gather and scatter of F membrane fields
# ---------------------------------------------------------------------------
def facet_gather_plain(X, facet_dofs):
    return X[:, facet_dofs.long()]


def facet_gather(X, facet_dofs):
    """K9.  G[c, f, j] = X[c, facet_dofs[f, j]]: F membrane-space fields at
    every facet's vertex slots.

    Replaces ``knpemi_tpu/ops/pallas_assembly.py:_make_facet_gather_kernel``
    (via ``facet_gather_blocked``).  Bound on the H100: bytes — X and
    facet_dofs read once, G written once (``csrc/facets.cu``).  Design: one
    thread per output element, writes coalesced.

    X (F, n_mem), facet_dofs (nf, k) -> G (F, nf, k)."""
    _check_value(X, "X")
    F, n_mem = X.shape
    nf, k = facet_dofs.shape
    _check(facet_dofs, "facet_dofs", X, index=True)
    if not X.is_cuda:
        return facet_gather_plain(X, facet_dofs)
    G = torch.empty(F, nf, k, dtype=X.dtype, device=X.device)
    _launch("facet_gather", X, X.data_ptr(), facet_dofs.data_ptr(),
            G.data_ptr(), F, nf, k, n_mem)
    facet_gather.launches += 1
    return G


facet_gather.launches = 0


def facet_scatter_plain(V, facet_dofs, n_mem):
    return K.scatter_add_rows(n_mem, facet_dofs.long(), V)


def facet_scatter(V, facet_dofs, n_mem: int):
    """K10.  Y[c, facet_dofs[f, j]] += V[c, f, j]: the inverse of
    :func:`facet_gather` for F channels of per-slot values.

    Replaces ``knpemi_tpu/ops/pallas_assembly.py:_make_facet_scatter_kernel``
    (via ``facet_scatter_blocked``).  Bound on the H100: bytes — V and
    facet_dofs read once, Y written once (``csrc/facets.cu``).  Design: one
    thread per input element, one atomic add each.

    V (F, nf, k), facet_dofs (nf, k) -> Y (F, n_mem)."""
    _check_value(V, "V")
    F = V.shape[0]
    nf, k = facet_dofs.shape
    _check(facet_dofs, "facet_dofs", V, index=True)
    if tuple(V.shape) != (F, nf, k):
        raise ValueError(f"V has shape {tuple(V.shape)}, expected {(F, nf, k)}")
    if not V.is_cuda:
        return facet_scatter_plain(V, facet_dofs, n_mem)
    Y = torch.zeros(F, n_mem, dtype=V.dtype, device=V.device)
    _launch("facet_scatter", V, V.data_ptr(), facet_dofs.data_ptr(),
            Y.data_ptr(), F, nf, k, n_mem)
    facet_scatter.launches += 1
    return Y


facet_scatter.launches = 0


# (wrapper, plain version) of this module's kernels; ops.kernel_table() merges
# every module's table
KERNELS = {
    "K1 emi_stiffness": (emi_stiffness, emi_stiffness_plain),
    "K2 facet_mass": (facet_mass, facet_mass_plain),
    "K3 knp_apply_batch": (knp_apply_batch, knp_apply_batch_plain),
    "K4 ell_matvec": (ell_matvec, ell_matvec_plain),
    "K9 facet_gather": (facet_gather, facet_gather_plain),
    "K10 facet_scatter": (facet_scatter, facet_scatter_plain),
}
