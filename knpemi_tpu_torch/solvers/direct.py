"""Host sparse assembly (scipy) and the direct LU path.

Counterpart of ``knpemi_tpu/solvers/direct.py``: the COO element
helpers, the assembled EMI and KNP matrices (the t=0 operators the
lagged SA-AMG hierarchies are built from, sim/stepper.py, and the
matrices of the direct path), and the direct solves, scipy ``spsolve``
on the host in place of the reference's MUMPS LU: the EMI system with
the pure-Neumann pin and mean shift, or the masked matrix under a
Dirichlet condition, and one LU per (subdomain, ion) block of the KNP
system.  The systems' right-hand sides are formed on their device; the
solves return host numpy arrays in float64, which the solver front-ends
(``solvers/api.py``) move back to the system's device and dtype.  Not a
kernel: the verification path, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla


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


def _drift_coo(cells, grads, vols, w_cell, coef=1.0):
    k = cells.shape[1]
    wg = np.einsum("cd,ckd->ck", w_cell, grads)  # rows (test i)
    Ke = (coef * vols / k)[:, None, None] * wg[:, :, None] * np.ones((1, 1, k))
    rows = np.repeat(cells[:, :, None], k, axis=2)
    cols = np.repeat(cells[:, None, :], k, axis=1)
    return rows, cols, Ke


def _drift_quad_coo(cells, grads, vols, w_q, bary, qw, coef=1.0):
    # A_ij = coef * vol * sum_q qw_q bary[q,j] (w_q . g_i)
    wg = np.einsum("cqd,ckd->cqk", w_q, grads)  # (nc, nq, k) rows
    Ke = coef * vols[:, None, None] * np.einsum("q,cqi,qj->cij", qw, wg, bary)
    k = cells.shape[1]
    rows = np.repeat(cells[:, :, None], k, axis=2)
    cols = np.repeat(cells[:, None, :], k, axis=1)
    return rows, cols, Ke


def _facet_mass_coo(dofs_row, dofs_col, areas, scale=1.0):
    k = dofs_row.shape[1]
    denom = k * (k + 1)
    Me = (np.ones((k, k)) + np.eye(k))[None] * (areas * scale)[:, None, None] / denom
    rows = np.repeat(dofs_row[:, :, None], k, axis=2)
    cols = np.repeat(dofs_col[:, None, :], k, axis=1)
    return rows, cols, Me


def assemble_emi_csr(geom, params, kappa: dict, bc_mask=None) -> sp.csr_matrix:
    """Assemble the EMI block matrix on the host from numpy per-tag vertex
    conductances ``kappa``; with ``bc_mask`` (flat, 0 on Dirichlet dofs,
    the system's ``bc_mask``) the symmetric elimination D A D + (I - D),
    D = diag(mask), else unmasked."""
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
    A = _coo_accumulate(rows, cols, vals, n)
    if bc_mask is not None:
        Dm = sp.diags(np.asarray(bc_mask, np.float64))
        A = (Dm @ A @ Dm + sp.diags(1.0 - np.asarray(bc_mask, np.float64))).tocsr()
    return A


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy().astype(np.float64)


def assemble_knp_csr(system, tag: int, ion_idx: int, gradphi_cell=None) -> sp.csr_matrix:
    """One (subdomain, ion) block of the KNP system on the host: mass/dt +
    D K + the drift, along the exact grad(phi) at the quadrature points
    under a manufactured solution, else along ``gradphi_cell`` (nc, dim)."""
    s = system.geom.subdomains[tag]
    p = system.params
    ion = system.ions[ion_idx]
    D, z = ion.D[tag], ion.z
    parts = [_mass_coo(s.cells, s.vols, 1.0 / p.dt),
             _stiffness_coo(s.cells, s.grads, s.vols, coef_cell=D)]
    mms = system.mms
    if mms is not None:
        parts.append(_drift_quad_coo(
            s.cells, s.grads, s.vols, np.asarray(mms.gradphi_q[tag]),
            np.asarray(mms.cell_bary), np.asarray(mms.cell_qw), coef=z * p.psi * D))
    else:
        parts.append(_drift_coo(s.cells, s.grads, s.vols, np.asarray(gradphi_cell),
                                coef=z * p.psi * D))
    rows, cols, vals = zip(*parts)
    return _coo_accumulate(rows, cols, vals, s.n_dofs)


def solve_emi_direct(system, c, phi_M, I_ch=None) -> np.ndarray:
    """The EMI solve by LU on the host (the reference's MUMPS): the
    assembled matrix, masked under a Dirichlet condition (the system's
    right-hand side is already lifted); pure Neumann: b projected onto
    range(A), dof 0 pinned, the solution shifted to zero mean.  Returns
    the flat solution, float64 numpy."""
    kappa = {t: _host(v) for t, v in system.kappa(c).items()}
    A = assemble_emi_csr(system.geom, system.params, kappa,
                         _host(system.bc_mask) if system.has_bc else None)
    b = _host(system.rhs(c, phi_M, I_ch))
    if not system.has_bc:
        b = b - b.mean()
        A = A.tolil()
        A[0, :] = 0.0
        A[:, 0] = 0.0
        A[0, 0] = 1.0
        A = A.tocsr()
        b[0] = 0.0
    x = spla.spsolve(A.tocsc(), b)
    if not system.has_bc:
        x = x - x.mean()
    return x


def solve_knp_direct(system, c, phi, phi_M, I_ch=None, source_gate=1.0) -> dict:
    """The KNP solve by one LU per (subdomain, ion) block on the host.
    Returns {tag: (N_solved, n)} float64 numpy."""
    rhs = system.rhs(c, phi, phi_M, I_ch, source_gate)
    gradphi = None if system.mms is not None else system.gradphi_cells(phi)
    out = {}
    for t in system.tags:
        b = _host(rhs[t])
        X = np.zeros_like(b)
        gp = None if gradphi is None else _host(gradphi[t])
        for k in range(system.n_solved):
            X[k] = spla.spsolve(assemble_knp_csr(system, t, k, gp).tocsc(), b[k])
        out[t] = X
    return out
