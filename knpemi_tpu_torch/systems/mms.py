"""Method-of-manufactured-solutions machinery.

Counterpart of ``knpemi_tpu/systems/mms.py``: the reference's MMS
verification setup with every source term derived by automatic
differentiation (``torch.func.grad``, ``jacfwd`` and ``vmap`` in place
of JAX's) instead of symbolic calculus:

    J_k_r   = -D grad(c_k_r) - z_k D psi c_k_r grad(phi_r)
    f_k_r   = div(J_k_r)
    f_phi_r = F sum_k z_k div(J_k_r)
    Im_i    =  (F sum_k z_k J_k_i) . n_i      (n_i outward from the ICS)
    Im_e    = -(F sum_k z_k J_k_e) . n_i
    f_phi_m = phi_M - Im_i / C_phi
    f_I_M   = Im_i + Im_e
    f_phi_m_k_r = phi_M - (J_k_r . n_i) / C_k_r

The exact fields are torch callables of one point x, a float64 tensor of
shape (dim,), written with torch operations (a Python float constant
keeps float64).  Everything is evaluated once, on the CPU in float64, at
the cell and facet quadrature points, and stored as numpy arrays in
:class:`~.emi.EMIMMSData` / :class:`~.knp.KNPMMSData`; the systems move
them to their device.

The Dirichlet data: the reference interpolates sin(2 pi x) cos(2 pi y)
as the EMI boundary value although its phi_e = sin(2 pi x) sin(2 pi y)
vanishes on the unit square's boundary; as the JAX package, this uses
the trace of the exact phi_e (= 0), the quantity the convergence study
is meaningful for.

Driving the study (the port's ``python3 chip_smoke.py`` runs it on the
card)::

    geom = build_geometry(unit_square_mms_mesh(16))
    case = reference_mms_case(geom)
    ions, emi_data, knp_data = build_mms_data(geom, case)
    esys = emi_system(geom, ions, case.params, mms=emi_data, device="cpu")
    ksys = knp_system(geom, ions, case.params, mms=knp_data, device="cpu")
    c0 = set_initial_conditions(geom, ions, device="cpu")
    phi, _ = create_solver_emi(esys, rtol=1e-10, maxiter=4000).solve(c0, phi_M0)
    c, _ = create_solver_knp(ksys, rtol=1e-10, maxiter=4000).solve(c0, phi, phi_M0)
    l2_error(geom, 0, phi[0], case.phi[0])
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List

import numpy as np
import torch

from ..ops import quadrature as quad
from ..ops.geometry import DiscreteGeometry
from .emi import EMIMMSData
from .knp import KNPMMSData
from .types import Ion, PhysicalParams

# points a vmapped evaluation takes at once (bounds its intermediates)
_CHUNK = 1 << 16


@dataclasses.dataclass
class MMSCase:
    """Exact fields as differentiable torch callables of x (shape (dim,)).

    conc[(name, tag)] -> c(x); phi[tag] -> phi(x); ions: Ion list with z/D
    per tag (the eliminated ion last, its concentration given by
    electroneutrality)."""

    ions: List[Ion]
    conc: Dict[tuple, Callable]
    phi: Dict[int, Callable]
    params: PhysicalParams


def _case(geom: DiscreteGeometry, a_fn, b_fn, phi_i, phi_e) -> MMSCase:
    z_a, z_b, z_c = 1.0, -1.0, 1.0

    def c_fn(x):
        return -(z_a * a_fn(x) + z_b * b_fn(x)) / z_c

    tags = geom.sub_tags
    ions = [
        Ion("a", z_a, {t: 1.0 for t in tags}),
        Ion("b", z_b, {t: 1.0 for t in tags}),
        Ion("c", z_c, {t: 1.0 for t in tags}),
    ]
    conc = {}
    for t in tags:
        conc[("a", t)] = a_fn
        conc[("b", t)] = b_fn
        conc[("c", t)] = c_fn
    params = PhysicalParams(dt=1.0, F=1.0, R=1.0, temperature=1.0, C_M=1.0,
                            rho={t: 0.0 for t in tags})
    return MMSCase(ions=ions, conc=conc, phi={0: phi_e, 1: phi_i}, params=params)


def reference_mms_case(geom: DiscreteGeometry, shift: float = 2.0) -> MMSCase:
    """The reference's 2-D trig case: three ions a (z=+1), b (z=-1), c
    (z=+1, eliminated), unit coefficients.  ``shift`` is added to the a/b
    concentrations: the reference's shift 0 makes the manufactured
    conductivity kappa = 2 b(x) sign-indefinite, and its EMI errors then
    do not converge monotonically; with shift 2, kappa >= 2 > 0 and both
    subsystems converge at O(h^2).  c = b - a is unchanged by the shift."""
    two_pi = 2.0 * math.pi

    def a_fn(x):
        return shift + torch.sin(two_pi * x[1]) * torch.cos(two_pi * x[0])

    def b_fn(x):
        return shift + torch.cos(two_pi * x[1]) * torch.sin(two_pi * x[0])

    def phi_i(x):
        return torch.cos(two_pi * x[0]) * torch.cos(two_pi * x[1])

    def phi_e(x):
        return torch.sin(two_pi * x[0]) * torch.sin(two_pi * x[1])

    return _case(geom, a_fn, b_fn, phi_i, phi_e)


def reference_mms_case_3d(geom: DiscreteGeometry, shift: float = 2.0) -> MMSCase:
    """The 3-D extension of the reference's case (trig products over x, y,
    z; the same ions and unit coefficients)."""
    two_pi = 2.0 * math.pi

    def a_fn(x):
        return shift + (torch.sin(two_pi * x[1]) * torch.cos(two_pi * x[0])
                        * torch.cos(two_pi * x[2]))

    def b_fn(x):
        return shift + (torch.cos(two_pi * x[1]) * torch.sin(two_pi * x[0])
                        * torch.cos(two_pi * x[2]))

    def phi_i(x):
        return torch.cos(two_pi * x[0]) * torch.cos(two_pi * x[1]) * torch.cos(two_pi * x[2])

    def phi_e(x):
        return torch.sin(two_pi * x[0]) * torch.sin(two_pi * x[1]) * torch.sin(two_pi * x[2])

    return _case(geom, a_fn, b_fn, phi_i, phi_e)


# ---------------------------------------------------------------------------
# pointwise derived fields (automatic differentiation)
# ---------------------------------------------------------------------------
def _flux_fn(c_fn, phi_fn, D, z, psi):
    gc = torch.func.grad(c_fn)
    gp = torch.func.grad(phi_fn)

    def J(x):
        return -D * gc(x) - z * D * psi * c_fn(x) * gp(x)

    return J


def _div_fn(vec_fn):
    jac = torch.func.jacfwd(vec_fn)

    def div(x):
        return torch.diagonal(jac(x)).sum()

    return div


def _eval_at(fn, pts) -> np.ndarray:
    """A pointwise callable at every point of ``pts`` (..., dim), vmapped
    on the CPU in float64: (...) + the callable's value shape."""
    pts = np.asarray(pts, np.float64)
    flat = torch.as_tensor(pts.reshape(-1, pts.shape[-1]))
    vfn = torch.func.vmap(fn)
    vals = np.concatenate([vfn(flat[i: i + _CHUNK]).numpy()
                           for i in range(0, max(flat.shape[0], 1), _CHUNK)])
    return vals.reshape(pts.shape[:-1] + vals.shape[1:])


def _cell_qpoints(geom, tag, bary):
    sub = geom.subdomains[tag]
    return np.einsum("qk,ckd->cqd", bary, sub.coords[sub.cells])


def _facet_qpoints(points, facet_verts, bary):
    return np.einsum("qk,fkd->fqd", bary, points[facet_verts])


def build_mms_data(geom: DiscreteGeometry, case: MMSCase):
    """(ions with their exact initial conditions, EMIMMSData, KNPMMSData)
    of a case."""
    p = case.params
    psi, F, C_phi = p.psi, p.F, p.C_phi
    ions = case.ions
    n_solved = len(ions) - 1
    dim = geom.dim

    cell_bary, cell_qw = quad.cell_rule(dim)
    facet_bary, facet_qw = quad.facet_rule_high(dim)

    J = {
        (ion.name, t): _flux_fn(case.conc[(ion.name, t)], case.phi[t], ion.D[t], ion.z, psi)
        for ion in ions
        for t in geom.sub_tags
    }

    # ---- cell sources ----------------------------------------------------
    f_phi_q, f_k_q, gradphi_q = {}, {}, {}
    for t in geom.sub_tags:
        Xq = _cell_qpoints(geom, t, cell_bary)

        def f_phi(x, t=t):
            return F * sum(ion.z * _div_fn(J[(ion.name, t)])(x) for ion in ions)

        f_phi_q[t] = _eval_at(f_phi, Xq)
        f_k_q[t] = np.stack(
            [_eval_at(_div_fn(J[(ion.name, t)]), Xq) for ion in ions[:n_solved]])
        gradphi_q[t] = _eval_at(torch.func.grad(case.phi[t]), Xq)

    # ---- membrane data ---------------------------------------------------
    f_phi_m_q, f_I_M_q = {}, {}
    g_robin_e_q, g_robin_i_q, dphi_q = {}, {}, {}
    for mtag, mem in geom.membranes.items():
        ct = mem.cell_tag
        Xq = _facet_qpoints(geom.mesh.points, mem.facet_verts, facet_bary)
        nrm = mem.normals  # (nf, dim), outward from the ICS = n_i

        def phiM(x, ct=ct):
            return case.phi[ct](x) - case.phi[0](x)

        phiM_q = _eval_at(phiM, Xq)
        dphi_q[mtag] = phiM_q

        def total_flux(x, t):
            return F * sum(ion.z * J[(ion.name, t)](x) for ion in ions)

        Ji_q = _eval_at(lambda x, ct=ct: total_flux(x, ct), Xq)  # (nf, nq, dim)
        Je_q = _eval_at(lambda x: total_flux(x, 0), Xq)
        Im_i = np.einsum("fqd,fd->fq", Ji_q, nrm)
        Im_e = -np.einsum("fqd,fd->fq", Je_q, nrm)
        f_phi_m_q[mtag] = phiM_q - Im_i / C_phi
        f_I_M_q[mtag] = Im_i + Im_e

        ge, gi = [], []
        for ion in ions[:n_solved]:
            Jke = _eval_at(J[(ion.name, 0)], Xq)
            Jki = _eval_at(J[(ion.name, ct)], Xq)
            # the coupling constants C_k_r are 1
            ge.append(phiM_q - np.einsum("fqd,fd->fq", Jke, nrm))
            gi.append(phiM_q - np.einsum("fqd,fd->fq", Jki, nrm))
        g_robin_e_q[mtag] = np.stack(ge)
        g_robin_i_q[mtag] = np.stack(gi)

    # ---- exterior boundary -------------------------------------------------
    emi_neumann_q, knp_neumann_q = {}, {}
    for btag, bs in geom.boundaries.items():
        Xq = _facet_qpoints(geom.mesh.points, bs.facet_verts, facet_bary)
        nrm = bs.normals

        def emi_flux(x, st=bs.sub_tag):
            return sum(-F * ion.z * J[(ion.name, st)](x) for ion in ions)

        emi_neumann_q[btag] = np.einsum("fqd,fd->fq", _eval_at(emi_flux, Xq), nrm)
        rows = []
        for ion in ions[:n_solved]:
            Jk = _eval_at(J[(ion.name, bs.sub_tag)], Xq)
            rows.append(-np.einsum("fqd,fd->fq", Jk, nrm))
        knp_neumann_q[btag] = np.stack(rows)

    # ---- the EMI Dirichlet condition (ECS exterior, tag 5) -------------------
    dirichlet_dofs = dirichlet_vals = None
    if 5 in geom.boundaries:
        bs = geom.boundaries[5]
        assert bs.sub_tag == 0
        dirichlet_dofs = bs.dofs
        dirichlet_vals = _eval_at(case.phi[0], geom.subdomains[0].coords[bs.dofs])

    emi_data = EMIMMSData(
        f_phi_q=f_phi_q, cell_bary=cell_bary, cell_qw=cell_qw,
        f_phi_m_q=f_phi_m_q, f_I_M_q=f_I_M_q, facet_bary=facet_bary,
        facet_qw=facet_qw, neumann_q=emi_neumann_q,
        dirichlet_dofs=dirichlet_dofs, dirichlet_vals=dirichlet_vals,
    )
    knp_data = KNPMMSData(
        f_k_q=f_k_q, cell_bary=cell_bary, cell_qw=cell_qw, gradphi_q=gradphi_q,
        g_robin_e_q=g_robin_e_q, g_robin_i_q=g_robin_i_q, dphi_q=dphi_q,
        facet_bary=facet_bary, facet_qw=facet_qw, neumann_q=knp_neumann_q,
    )
    # initial conditions: the exact vertex interpolants
    for ion in ions:
        ion.c_init = {t: _eval_at(case.conc[(ion.name, t)], geom.subdomains[t].coords)
                      for t in geom.sub_tags}
    return ions, emi_data, knp_data


# ---------------------------------------------------------------------------
# error norms
# ---------------------------------------------------------------------------
def l2_error(geom: DiscreteGeometry, tag: int, u_h, exact_fn) -> float:
    """The L2 norm of u_h - exact over subdomain ``tag`` by the cell
    quadrature; ``u_h`` a P1 vertex field (tensor on any device, or
    array)."""
    sub = geom.subdomains[tag]
    bary, qw = quad.cell_rule(geom.dim)
    ue = _eval_at(exact_fn, _cell_qpoints(geom, tag, bary))  # (nc, nq)
    if torch.is_tensor(u_h):
        u_h = u_h.detach().cpu().numpy()
    uh = np.einsum("qk,ck->cq", bary, np.asarray(u_h, np.float64)[sub.cells])
    err2 = np.einsum("cq,q->c", (uh - ue) ** 2, qw) * sub.vols
    return float(np.sqrt(err2.sum()))
