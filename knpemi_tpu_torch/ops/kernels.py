"""Plain P1 element operators in PyTorch: gather -> einsum -> index_add_.

Counterpart of ``knpemi_tpu/ops/kernels.py`` (the JAX package's XLA
assembly path).  These are the arithmetic the plain versions of the
Hopper kernels in :mod:`knpemi_tpu_torch.ops.assembly` reuse, and the
operators of the setup-time paths (Jacobi diagonals).  All forms are
P1-exact:

* stiffness with a P1 coefficient kappa: ``mean(kappa_vertices) * vol *
  (g_i . g_j)``,
* mass: ``vol * (1 + delta_ij) / ((d+1)(d+2))``,
* drift ``coef * u * (w . grad v)`` with cellwise-constant w:
  ``coef * (w . g_i) * vol / (d+1)``,
* interface facet mass: ``area * (1 + delta_ab) / ((d_f+1)(d_f+2))``.

Index tensors are int64 here (``index_add_`` and advanced indexing take
int64 without a copy).
"""

from __future__ import annotations

import torch


def scatter_add(n_dofs: int, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Accumulate (..., k) values into a length-n vector at (..., k) indices."""
    out = torch.zeros(n_dofs, dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, idx.reshape(-1), vals.reshape(-1))


def scatter_add_rows(n_dofs: int, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Row-batched :func:`scatter_add`: vals (F, ...) at idx (...) -> (F, n)."""
    F = vals.shape[0]
    out = torch.zeros(F, n_dofs, dtype=vals.dtype, device=vals.device)
    return out.index_add_(1, idx.reshape(-1), vals.reshape(F, -1))


def cell_gradients(x, cells, grads):
    """Cellwise-constant gradient of a P1 field: (n_cells, dim)."""
    return torch.einsum("ck,ckd->cd", x[cells], grads)


def stiffness_cell_values(x, cells, grads, vols, coef_vertex=None, coef_cell=1.0):
    """Per-cell test-function values of ``integral coef grad(x).grad(v)``."""
    gx = cell_gradients(x, cells, grads)
    w = vols * coef_cell
    if coef_vertex is not None:
        w = w * coef_vertex[cells].mean(dim=1)
    return torch.einsum("cd,ckd->ck", gx, grads) * w[:, None]


def stiffness_apply(n_dofs, x, cells, grads, vols, coef_vertex=None, coef_cell=1.0):
    vals = stiffness_cell_values(x, cells, grads, vols, coef_vertex, coef_cell)
    return scatter_add(n_dofs, cells, vals)


def stiffness_diag(n_dofs, cells, grads, vols, coef_vertex=None, coef_cell=1.0):
    w = vols * coef_cell
    if coef_vertex is not None:
        w = w * coef_vertex[cells].mean(dim=1)
    d = torch.einsum("ckd,ckd->ck", grads, grads) * w[:, None]
    return scatter_add(n_dofs, cells, d)


def mass_cell_values(x, cells, vols, scale=1.0):
    """Per-cell values of ``integral scale * x * v`` (P1 consistent mass)."""
    k = cells.shape[1]
    xe = x[cells]
    s = xe.sum(dim=1, keepdim=True)
    return (vols * scale)[:, None] * (s + xe) / (k * (k + 1))


def mass_apply(n_dofs, x, cells, vols, scale=1.0):
    return scatter_add(n_dofs, cells, mass_cell_values(x, cells, vols, scale))


def mass_diag(n_dofs, cells, vols, scale=1.0):
    k = cells.shape[1]
    d = (2.0 * vols * scale / (k * (k + 1)))[:, None].expand(cells.shape)
    return scatter_add(n_dofs, cells, d)


def drift_cell_values(x, cells, grads, vols, w_cell, coef=1.0):
    """Per-cell values of ``integral coef * x * (w . grad v)`` with a
    cellwise-constant vector field w (w = grad(phi) for the KNP drift)."""
    k = cells.shape[1]
    xbar = x[cells].sum(dim=1) / k
    wg = torch.einsum("cd,ckd->ck", w_cell, grads)
    return (coef * vols * xbar)[:, None] * wg


def drift_apply(n_dofs, x, cells, grads, vols, w_cell, coef=1.0):
    return scatter_add(n_dofs, cells, drift_cell_values(x, cells, grads, vols, w_cell, coef))


def drift_diag(n_dofs, cells, grads, vols, w_cell, coef=1.0):
    k = cells.shape[1]
    wg = torch.einsum("cd,ckd->ck", w_cell, grads)
    return scatter_add(n_dofs, cells, (coef * vols / k)[:, None] * wg)


def source_rhs_quad(n_dofs, f_at_q, cells, vols, bary, qw):
    """RHS of ``integral f * v`` with f given at cell quadrature points.

    f_at_q: (n_cells, n_q); bary: (n_q, k); qw: (n_q,)."""
    vals = torch.einsum("cq,q,qk->ck", f_at_q, qw, bary) * vols[:, None]
    return scatter_add(n_dofs, cells, vals)
