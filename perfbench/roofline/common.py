"""The yardstick of the roofline shares: the card's peak, and the least
bytes of the operator applies and multigrid cycles that a Krylov solve
needs, counted from sizes alone.

Each operator counts at its nonzeros, a 4-byte column index and one
value of the run's dtype each, once per apply (a batch of B vectors
reads the operator once and each vector once); each vector an operation
reads or writes counts once.  Nothing here depends on kernel names or
on the layouts the program stores: the multigrid levels' nonzeros are
the Galerkin products P^T A P of the patterns.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import scipy.sparse as sp

# NVIDIA H100 SXM: HBM3 bandwidth of the data sheet (bytes/s), at 700 W
PEAK_BYTES_PER_S = 3.35e12
INDEX_BYTES = 4


def pattern(rows: np.ndarray, cols: np.ndarray, n: int) -> sp.csr_matrix:
    """The 0/1 pattern of the pairs (rows, cols) as an n x n CSR."""
    A = sp.coo_matrix((np.ones(rows.size, np.float32), (rows.ravel(), cols.ravel())),
                      shape=(n, n)).tocsr()
    A.data[:] = 1.0
    return A


def cell_pairs(cells: np.ndarray, offset: int = 0):
    c = np.asarray(cells, np.int64) + offset
    k = c.shape[1]
    return np.repeat(c[:, :, None], k, axis=2), np.repeat(c[:, None, :], k, axis=1)


def levels(A0: sp.csr_matrix, hier) -> Tuple[List[Tuple[int, int, int, int]], int]:
    """[(n, nnz(A), nnz(P), n_coarse)] per level of a host hierarchy (its
    ``perm`` and each level's ``P_csr``) built on the pattern A0, and the
    coarsest size."""
    A = A0
    if hier.perm is not None:
        A = A[hier.perm][:, hier.perm].tocsr()
    out = []
    for lv in hier.levels:
        P = lv.P_csr.copy()
        P.data = np.ones_like(P.data, dtype=np.float32)
        out.append((A.shape[0], int(A.nnz), int(P.nnz), P.shape[1]))
        A = (P.T @ (A @ P)).tocsr()
        A.data[:] = 1.0
    return out, A.shape[0]


def smoother_steps(hier) -> int:
    """Richardson steps a smoothing sweep of the hierarchy takes."""
    if not hier.levels or hier.levels[0].steps is None:
        return 1
    return int(np.size(hier.levels[0].steps))


def op(nnz: int, n_in: int, n_out: int, vb: int, B: int = 1, values: int = 1) -> float:
    """One apply of an operator with ``values`` value streams to B vectors."""
    return nnz * (INDEX_BYTES + values * vb) + B * (n_in + n_out) * vb


def vcycle(lv: List[Tuple[int, int, int, int]], n_coarse: int, vb: int, B: int, nu: int,
           steps: int, post: bool, gamma: int = 1) -> float:
    """One cycle: per level, the pre-smoothing (nu sweeps of ``steps``
    Richardson steps, the first from zero without an apply), the residual,
    the restriction, the coarse correction (``gamma`` times), the
    prolongation and its add, the post-smoothing; the coarsest level's
    eigenfactored solve reads its n_c x n_c factor twice."""
    if not lv:
        return 2.0 * n_coarse * n_coarse * vb + 2.0 * B * n_coarse * vb
    n, nnzA, nnzP, nc = lv[0]
    A = op(nnzA, n, n, vb, B)
    smooth = A + (n + 4 * B * n) * vb
    total = (n + 2 * B * n) * vb + (nu * steps - 1) * smooth   # pre-smoothing
    total += A + 3 * B * n * vb                                  # residual
    total += op(nnzP, n, nc, vb, B)                              # restriction
    total += gamma * vcycle(lv[1:], n_coarse, vb, B, nu, steps, post, gamma)
    total += op(nnzP, nc, n, vb, B) + 3 * B * n * vb             # prolongation, add
    if post:
        total += nu * steps * smooth                             # post-smoothing
    return total
