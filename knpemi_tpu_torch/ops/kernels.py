"""Plain P1 element operators in PyTorch: gather -> einsum -> index_add_.

Counterpart of the parts of ``knpemi_tpu/ops/kernels.py`` (the JAX
package's XLA assembly path) that the port still applies element by
element: the Jacobi diagonals and the source load vector (the operators
themselves are assembled on the P1 graph,
:mod:`knpemi_tpu_torch.ops.p1op`).  All forms are P1-exact:

* stiffness with a P1 coefficient kappa: ``mean(kappa_vertices) * vol *
  (g_i . g_j)``,
* mass: ``vol * (1 + delta_ij) / ((d+1)(d+2))``,
* drift ``coef * u * (w . grad v)`` with cellwise-constant w:
  ``coef * (w . g_i) * vol / (d+1)``.

Index tensors are int64 here (``index_add_`` and advanced indexing take
int64 without a copy).
"""

from __future__ import annotations

import torch


def scatter_add(n_dofs: int, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Accumulate (..., k) values into a length-n vector at (..., k) indices."""
    out = torch.zeros(n_dofs, dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, idx.reshape(-1), vals.reshape(-1))


def stiffness_diag(n_dofs, cells, grads, vols, coef_vertex=None, coef_cell=1.0):
    w = vols * coef_cell
    if coef_vertex is not None:
        w = w * coef_vertex[cells].mean(dim=1)
    d = torch.einsum("ckd,ckd->ck", grads, grads) * w[:, None]
    return scatter_add(n_dofs, cells, d)


def mass_diag(n_dofs, cells, vols, scale=1.0):
    k = cells.shape[1]
    d = (2.0 * vols * scale / (k * (k + 1)))[:, None].expand(cells.shape)
    return scatter_add(n_dofs, cells, d)


def drift_diag(n_dofs, cells, grads, vols, w_cell, coef=1.0):
    k = cells.shape[1]
    wg = torch.einsum("cd,ckd->ck", w_cell, grads)
    return scatter_add(n_dofs, cells, (coef * vols / k)[:, None] * wg)


def source_rhs_quad(n_dofs, f_at_q, cells, vols, bary, qw):
    """RHS of ``integral f * v`` with f given at cell quadrature points.

    f_at_q: (n_cells, n_q); bary: (n_q, k); qw: (n_q,)."""
    vals = torch.einsum("cq,q,qk->ck", f_at_q, qw, bary) * vols[:, None]
    return scatter_add(n_dofs, cells, vals)
