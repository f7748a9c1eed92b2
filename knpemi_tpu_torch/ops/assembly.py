"""The facet kernels of the coupled step, with plain twins, and the
launch helpers every kernel module of the port shares.

Each wrapper below launches a hand-written CUDA kernel (``ops/csrc``,
built by :mod:`._build`) for CUDA tensors and uses its plain PyTorch
version for CPU tensors — the only reason it ever takes the plain path.
On a CUDA tensor it launches or raises; there is no fallback.  Every
wrapper counts its launches in a plain integer attribute
(``wrapper.launches``) and checks device, dtype, shape and contiguity.

Here: K9 and K10 (facet gather and scatter of the membrane fields).
K1, K2, K3 and K11 — the EMI, membrane surface mass, ion-batched KNP
and single-ion KNP operators — are applied as an assembled P1 operator
by :mod:`.p1op`; K4, which applies the multigrid operators and the
frozen dof -> cell coefficient maps, and the other multigrid kernels
are in :mod:`.ell` and :mod:`.banded`.

The JAX package's TPU kernels compute the same operators through one-hot
MXU products, bf16 split passes, 128-lane alignment, Morton windows and
an XLA tail of outlier cells (``knpemi_tpu/ops/pallas_assembly.py:1-36``,
``pallas_ell.py:1-42``) — all of it a way around slow random gathers on
the TPU.  On Hopper a gather is a load: K9 takes one thread per four
facet slots, and K10 one per membrane dof, which walks its row of the
membrane operator's incidence list and sums the slots there in the
list's order.  No kernel here uses atomics, so each gives the
same bits on every launch.  None does enough arithmetic per byte to be
compute-bound; the least time each can take is the bytes it must move
over the card's 3.35 TB/s.

Index tensors: int32 on CUDA (the kernels' type), int32 or int64 on the
CPU.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_c_int = ctypes.c_int
_c_ptr = ctypes.c_void_p

# C signatures of ops/csrc/*.cu: (library, entry point, argument types)
_SIGS = {
    "facet_gather": ("facets", "knp_facet_gather",
                     [_c_int] + [_c_ptr] * 3 + [_c_int] * 4 + [_c_ptr]),
    "facet_scatter": ("facets", "knp_facet_scatter",
                      [_c_int] + [_c_ptr] * 4 + [_c_int] * 4 + [_c_ptr]),
    # ops/p1op.py
    "p1_apply": ("cells", "knp_p1_apply",
                 [_c_int] + [_c_ptr] * 6 + [ctypes.c_double] * 2 + [_c_int, _c_ptr]),
    "p1_apply_batch": ("cells", "knp_p1_apply_batch",
                       [_c_int] + [_c_ptr] * 8 + [_c_int] * 2 + [_c_ptr]),
    "emi_fill": ("cells", "knp_emi_fill",
                 [_c_int] + [_c_ptr] * 8 + [_c_int] * 5 + [_c_ptr]),
    "drift_fill": ("cells", "knp_drift_fill",
                   [_c_int] + [_c_ptr] * 9 + [_c_int] * 5 + [_c_ptr]),
    # ops/ell.py and ops/banded.py
    "sliced_matvec": ("mg", "knp_sliced_matvec",
                      [_c_int] + [_c_ptr] * 5 + [_c_int, _c_ptr]),
    "sliced_matvec_batch": ("mg", "knp_sliced_matvec_batch",
                            [_c_int] + [_c_ptr] * 5 + [_c_int] * 3 + [_c_ptr]),
    "csr_gather_batch": ("mg", "knp_csr_gather_batch",
                         [_c_int] + [_c_ptr] * 5 + [_c_int] * 4 + [_c_ptr]),
    "csr_gather_add_batch": ("mg", "knp_csr_gather_add_batch",
                             [_c_int] + [_c_ptr] * 5 + [_c_int] * 4 + [_c_ptr]),
    "banded_matvec": ("mg", "knp_banded_matvec",
                      [_c_int] * 2 + [_c_ptr] * 6 + [_c_int] * 6 + [_c_ptr]),
    "banded_matvec_batch": ("mg", "knp_banded_matvec_batch",
                            [_c_int] * 2 + [_c_ptr] * 6 + [_c_int] * 7 + [_c_ptr]),
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


def _check_incidence(op, like: torch.Tensor):
    """The incidence list of a P1 operator (``ops/p1op.py``), which the
    fills and K10 walk: int32, on ``like``'s device."""
    if op.inc_ptr.dtype != torch.int32 or op.inc.dtype != torch.int32:
        raise TypeError("inc_ptr and inc must be int32")
    if op.inc.device != like.device:
        raise ValueError(f"the incidence list is on {op.inc.device}, the input on "
                         f"{like.device}")


def _check_mesh(k: int, dim: int):
    if (k, dim) not in ((4, 3), (3, 2)):
        raise ValueError(f"cells must be triangles or tetrahedra, got k={k}, dim={dim}")


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
    facet_dofs read once, G written once (``csrc/facets.cu``).  Design:
    each thread owns four consecutive facet slots, reads their dof ids
    with one 16-byte load (one at a time where ``facet_dofs`` is not
    16-byte aligned), gathers them for every channel and writes each
    channel's four values with one 16-byte store (four plain stores
    where the address is not aligned, and for the last slots); no
    integer division, the index map read once per launch.  A copy: the
    output bits are the input bits.

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


def facet_scatter_plain(V, op):
    c, i, rows = op._plain("incidence")  # the list's entries in its order
    F = V.shape[0]
    Y = torch.zeros(F, op.n, dtype=V.dtype, device=V.device)
    return Y.index_add_(1, rows, V.reshape(F, -1)[:, c * op.k + i])


def facet_scatter(V, op):
    """K10.  Y[c, facet_dofs[f, j]] += V[c, f, j]: the inverse of
    :func:`facet_gather` for F channels of per-slot values, on the
    membrane's P1 operator ``op`` (:func:`.p1op.membrane_operators`),
    whose rows are the membrane dofs and whose incidence list holds each
    row's (facet f, vertex j) slots, f ascending.

    Replaces ``knpemi_tpu/ops/pallas_assembly.py:_make_facet_scatter_kernel``
    (via ``facet_scatter_blocked``).  Bound on the H100: bytes — V and
    the incidence list read once, Y written once (``csrc/facets.cu``).
    Design: one thread per membrane dof, one warp per 32-row slice of the
    list (read coalesced); each entry decoded once to its slot f k + j
    and gathered for all F channels (V lives in L2), the sums kept in
    registers in the list's order and Y written once into
    ``torch.empty``: no atomics, no memset, the same bits every launch.

    V (F, nf, k), op -> Y (F, n_mem)."""
    _check_value(V, "V")
    nf, k = op.cells.shape
    F = V.shape[0]
    if tuple(V.shape) != (F, nf, k):
        raise ValueError(f"V has shape {tuple(V.shape)}, expected {(F, nf, k)}")
    _check_incidence(op, V)
    if not V.is_cuda:
        return facet_scatter_plain(V, op)
    Y = torch.empty(F, op.n, dtype=V.dtype, device=V.device)
    _launch("facet_scatter", V, V.data_ptr(), op.inc_ptr.data_ptr(), op.inc.data_ptr(),
            Y.data_ptr(), F, op.n, nf, k)
    facet_scatter.launches += 1
    return Y


facet_scatter.launches = 0


# (wrapper, plain version) of this module's kernels; ops.kernel_table() merges
# every module's table
KERNELS = {
    "K9 facet_gather": (facet_gather, facet_gather_plain),
    "K10 facet_scatter": (facet_scatter, facet_scatter_plain),
}
