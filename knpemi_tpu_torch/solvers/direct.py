"""Host sparse assembly (scipy) used by the multigrid setup.

Counterpart of the COO/CSR helpers of ``knpemi_tpu/solvers/direct.py``:
the t=0 EMI operator and the KNP setup operators that the lagged SA-AMG
hierarchies are built from (sim/stepper.py).  The direct LU solves of
the JAX module are not part of this port.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def _coo_accumulate(rows, cols, vals, n):
    return sp.coo_matrix(
        (np.concatenate([v.ravel() for v in vals]),
         (np.concatenate([r.ravel() for r in rows]),
          np.concatenate([c.ravel() for c in cols]))),
        shape=(n, n),
    ).tocsr()


def _stiffness_coo(cells, grads, vols, coef_vertex=None, coef_cell=1.0):
    w = vols * coef_cell
    if coef_vertex is not None:
        w = w * coef_vertex[cells].mean(axis=1)
    Ke = np.einsum("ckd,cld->ckl", grads, grads) * w[:, None, None]
    k = cells.shape[1]
    rows = np.repeat(cells[:, :, None], k, axis=2)
    cols = np.repeat(cells[:, None, :], k, axis=1)
    return rows, cols, Ke


def _mass_coo(cells, vols, scale=1.0):
    k = cells.shape[1]
    denom = k * (k + 1)
    Me = (np.ones((k, k)) + np.eye(k))[None] * (vols * scale)[:, None, None] / denom
    rows = np.repeat(cells[:, :, None], k, axis=2)
    cols = np.repeat(cells[:, None, :], k, axis=1)
    return rows, cols, Me


def _facet_mass_coo(dofs_row, dofs_col, areas, scale=1.0):
    k = dofs_row.shape[1]
    denom = k * (k + 1)
    Me = (np.ones((k, k)) + np.eye(k))[None] * (areas * scale)[:, None, None] / denom
    rows = np.repeat(dofs_row[:, :, None], k, axis=2)
    cols = np.repeat(dofs_col[:, None, :], k, axis=1)
    return rows, cols, Me


def assemble_emi_csr(geom, params, kappa: dict) -> sp.csr_matrix:
    """Assemble the (unmasked) EMI block matrix on the host from numpy
    per-tag vertex conductances ``kappa``."""
    off = geom.emi_offsets()
    n = geom.emi_size
    rows, cols, vals = [], [], []
    for t in geom.sub_tags:
        s = geom.subdomains[t]
        r, c, v = _stiffness_coo(
            s.cells, s.grads, s.vols, coef_vertex=np.asarray(kappa[t])
        )
        rows.append(r + off[t])
        cols.append(c + off[t])
        vals.append(v)
    C_phi = params.C_phi
    for m, sp_ in geom.membranes.items():
        ct = sp_.cell_tag
        ii = sp_.facet_idofs + off[ct]
        ee = sp_.facet_edofs + off[0]
        for dr, dc, sgn in [(ii, ii, 1.0), (ii, ee, -1.0), (ee, ii, -1.0), (ee, ee, 1.0)]:
            r, c, v = _facet_mass_coo(dr, dc, sp_.areas, C_phi * sgn)
            rows.append(r)
            cols.append(c)
            vals.append(v)
    return _coo_accumulate(rows, cols, vals, n)
