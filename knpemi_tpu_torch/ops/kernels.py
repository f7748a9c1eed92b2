"""Plain P1 element operators in PyTorch: gather -> einsum -> index_add_.

Counterpart of ``knpemi_tpu/ops/kernels.py`` (the JAX package's XLA
assembly path), function for function but its three Jacobi diagonals.
The solves apply their operators on the assembled P1 graph and sum
their diagonals there (:mod:`knpemi_tpu_torch.ops.p1op`); what runs
here element by element is the load vectors of quadrature data (the ECS
source, the manufactured-solution sources and boundary data of
``systems/emi.py`` and ``knp.py``); the other functions are the plain
element operators, which the tests hold against the JAX package's and
the assembled operators against (``drift_apply_quad``: the manufactured
solution's drift stream).  All forms are P1-exact:

* stiffness with a P1 coefficient kappa: ``mean(kappa_vertices) * vol *
  (g_i . g_j)``,
* mass: ``vol * (1 + delta_ij) / ((d+1)(d+2))``,
* drift ``coef * u * (w . grad v)`` with cellwise-constant w:
  ``coef * (w . g_i) * vol / (d+1)``; with w given at the cell
  quadrature points (the exact grad(phi) of a manufactured solution),
  by that quadrature,
* facet mass (a d_f-simplex): ``area * (1 + delta_ab) / ((d_f+1)(d_f+2))``.

Index tensors are int64 here (``index_add_`` and advanced indexing take
int64 without a copy).
"""

from __future__ import annotations

import torch


def scatter_add(n_dofs: int, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Accumulate (..., k) values into a length-n vector at (..., k) indices."""
    out = torch.zeros(n_dofs, dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, idx.reshape(-1), vals.reshape(-1))


def cell_gradients(x, cells, grads):
    """Cellwise-constant gradient of a P1 field: (n_cells, dim)."""
    return torch.einsum("ck,ckd->cd", x[cells], grads)


def stiffness_cell_values(x, cells, grads, vols, coef_vertex=None, coef_cell=1.0):
    """Per-cell test-function values of ``integral coef grad(x) . grad(v)``:
    (n_cells, k), to be scatter-added into the dof vector."""
    gx = cell_gradients(x, cells, grads)
    w = vols * coef_cell
    if coef_vertex is not None:
        w = w * coef_vertex[cells].mean(dim=1)
    return torch.einsum("cd,ckd->ck", gx, grads) * w[:, None]


def stiffness_apply(n_dofs, x, cells, grads, vols, coef_vertex=None, coef_cell=1.0):
    return scatter_add(n_dofs, cells,
                       stiffness_cell_values(x, cells, grads, vols, coef_vertex, coef_cell))


def mass_cell_values(x, cells, vols, scale=1.0):
    """Per-cell values of ``integral scale x v`` (P1 consistent mass)."""
    k = cells.shape[1]
    xe = x[cells]
    return (vols * scale)[:, None] * (xe.sum(dim=1, keepdim=True) + xe) / (k * (k + 1))


def mass_apply(n_dofs, x, cells, vols, scale=1.0):
    return scatter_add(n_dofs, cells, mass_cell_values(x, cells, vols, scale))


def drift_cell_values(x, cells, grads, vols, w_cell, coef=1.0):
    """Per-cell values of ``integral coef x (w . grad v)`` with a
    cellwise-constant vector field w."""
    k = cells.shape[1]
    xbar = x[cells].sum(dim=1) / k
    wg = torch.einsum("cd,ckd->ck", w_cell, grads)
    return (coef * vols * xbar)[:, None] * wg


def drift_apply(n_dofs, x, cells, grads, vols, w_cell, coef=1.0):
    return scatter_add(n_dofs, cells, drift_cell_values(x, cells, grads, vols, w_cell, coef))


def drift_cell_values_quad(x, cells, grads, vols, w_q, bary, qw, coef=1.0):
    """:func:`drift_cell_values` for a vector field w given at the cell
    quadrature points, w_q (n_cells, n_q, dim):
    y_i = coef vol sum_q qw_q x(q) (w_q . g_i)."""
    xq = torch.einsum("ck,qk->cq", x[cells], bary)
    wg = torch.einsum("cqd,ckd->cqk", w_q, grads)
    return coef * vols[:, None] * torch.einsum("cq,q,cqk->ck", xq, qw, wg)


def drift_apply_quad(n_dofs, x, cells, grads, vols, w_q, bary, qw, coef=1.0):
    return scatter_add(n_dofs, cells,
                       drift_cell_values_quad(x, cells, grads, vols, w_q, bary, qw, coef))


def grad_inner_rhs(n_dofs, c, cells, grads, vols, coef=1.0):
    """RHS of ``integral coef grad(c) . grad(v)`` for a known P1 field c."""
    return scatter_add(n_dofs, cells, stiffness_cell_values(c, cells, grads, vols, None, coef))


def mass_rhs(n_dofs, f, cells, vols, scale=1.0):
    """RHS of ``integral scale f v`` for a P1 field f."""
    return scatter_add(n_dofs, cells, mass_cell_values(f, cells, vols, scale))


def source_rhs_quad(n_dofs, f_at_q, cells, vols, bary, qw):
    """RHS of ``integral f * v`` with f given at cell quadrature points.

    f_at_q: (n_cells, n_q); bary: (n_q, k); qw: (n_q,)."""
    vals = torch.einsum("cq,q,qk->ck", f_at_q, qw, bary) * vols[:, None]
    return scatter_add(n_dofs, cells, vals)


def facet_mass_values(xf, areas, scale=1.0):
    """Facet P1 (trace) mass action: per-facet values of ``integral scale
    x v`` over each facet; xf (nf, k_f)."""
    k = xf.shape[1]
    return (areas * scale)[:, None] * (xf.sum(dim=1, keepdim=True) + xf) / (k * (k + 1))


def facet_mass_diag_values(areas, k, scale=1.0):
    return (2.0 * areas * scale / (k * (k + 1)))[:, None].expand(areas.shape[0], k)


def facet_rhs_quad(n_dofs, coeff_q, facet_dofs, areas, bary, qw):
    """Scatter ``integral coeff v`` over facets, the coefficient given at
    the facet quadrature points: coeff_q (nf, nq), bary (nq, k_f)."""
    vals = torch.einsum("fq,q,qk->fk", coeff_q, qw, bary) * areas[:, None]
    return scatter_add(n_dofs, facet_dofs, vals)


def trace_at_quad(x, facet_dofs, bary):
    """The P1 trace of x at the facet quadrature points: (nf, nq)."""
    return torch.einsum("fk,qk->fq", x[facet_dofs], bary)
