"""The KNP (concentration) block system on the Hopper kernels.

Counterpart of ``knpemi_tpu/systems/knp.py`` on its blocked-assembly
path (``use_pallas``): for every subdomain and solved ion (the last ion
is eliminated) one implicit-Euler advection-diffusion equation

    (1/dt) int u v + int D_k grad(u).grad(v) + z_k psi int D_k u grad(phi).grad(v)
  = (1/dt) int c_prev v + gate(t) int f_k v + membrane Robin terms.

Both solves apply the operators on the subdomain's assembled P1
operator (:class:`ops.p1op.P1Operator`, shared with the EMI system),
with the drift part filled once per solve and subdomain by K11f
(:func:`ops.p1op.drift_fill`) from grad(phi) per cell (K4) for all
ions.  The left-hand side has no interface terms, so the solved ions of
one subdomain form a batch: K3 (:func:`ops.p1op.knp_apply_batch`)
applies all of them in one pass from three value streams, the unit mass
M assembled at setup, the EMI system's unit stiffness and the drift,
and applies the right-hand side's mass term from M alone.  The per-ion
solve applies one ion's operator with K11 (:func:`ops.p1op.knp_apply`):
its constant part P_b = (1/dt) M + D_b K assembled once per ion at setup
(:func:`ion_operator_values`), plus z_b psi D_b Dr.  The ECS
source f_k has a static spatial profile (only its scalar gate varies in
time), so its load vector is assembled once.
The membrane Robin right-hand side runs in membrane-dof space: K9 gathers
the stacked fields to the facet vertex slots, the quadrature algebra of
``_robin_facet_values`` (``knp.py:359``) runs in PyTorch, and K10
scatters the result back, row by row from the incidence list of the
membrane's P1 operator (shared with the EMI system).

Under a manufactured solution (``mms``, :class:`KNPMMSData`) the drift
runs along the exact grad(phi) given at the cell quadrature points,
fixed for the whole solve: its values are assembled once on the host
(float64, from the quadrature element matrices of
``solvers/direct.py::_drift_quad_coo``, then cast) into a value stream
of the same P1 operator, which K3 and K11 apply as they apply K11f's.
The right-hand side is then the mass term plus a static load vector of
the manufactured sources, Robin data and Neumann flux, summed on the
host; the splitting scheme is off.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops import assembly as A
from ..ops import ell as E
from ..ops import kernels as K
from ..ops import p1op as P
from ..ops import quadrature as quad
from ..ops.geometry import DiscreteGeometry
from ..solvers import direct
from .types import Ion, PhysicalParams, resolve_device


def ion_operator_values(op: P.P1Operator, cells, grads, vols, dt_inv: float,
                        Ds: Sequence[float], dtype) -> List[torch.Tensor]:
    """P_b = dt_inv M + D_b K on ``op`` for every diffusion coefficient in
    ``Ds`` (one per solved ion), in the row-sum form: the constant part of
    K11's operator, summed in float64 from the host COO helpers' element
    matrices of (``cells``, ``grads``, ``vols``) and cast to ``dtype``.
    Its row sums are those of dt_inv M alone (the stiffness's vanish)."""
    Mv = op.assemble_row_sums(direct._mass_coo(cells, vols, dt_inv)[2])
    Kv = op.assemble(direct._stiffness_coo(cells, grads, vols)[2])[0]
    return [torch.as_tensor(Mv + Dc * Kv, dtype=dtype, device=op.device) for Dc in Ds]


def mms_drift_values(op: P.P1Operator, cells, grads, vols, w_q, bary, qw,
                     dtype) -> torch.Tensor:
    """The drift along a vector field given at the cell quadrature points,
    w_q (nc, nq, dim), on ``op`` in the row-sum form: the unit-coefficient
    element matrices of ``solvers/direct.py::_drift_quad_coo`` summed on
    the host in float64 (the diagonal slots take the rows' sums), then
    cast to ``dtype``.  K3's and K11's drift stream for a manufactured
    solution, in place of K11f's fill."""
    De = direct._drift_quad_coo(cells, grads, vols, w_q, bary, qw)[2]
    return torch.as_tensor(op.assemble_row_sums(De), dtype=dtype, device=op.device)


@dataclasses.dataclass
class KNPMMSData:
    """Manufactured-solution data, numpy arrays (the JAX package's
    ``KNPMMSData``): the drift and the interface coupling take the EXACT
    phi, the coupling coefficients are the constants C_e, C_i, the Robin
    data are analytic."""

    # per tag: (N_solved, n_cells, nq) ion sources f_k
    f_k_q: Dict[int, np.ndarray]
    cell_bary: np.ndarray
    cell_qw: np.ndarray
    # per tag: (n_cells, nq, dim) exact grad(phi) for the drift term
    gradphi_q: Dict[int, np.ndarray]
    # per membrane tag: (N_solved, nf, nq) Robin data per side
    g_robin_e_q: Dict[int, np.ndarray]
    g_robin_i_q: Dict[int, np.ndarray]
    # per membrane tag: (nf, nq) exact phi_i - phi_e at the facet quadrature points
    dphi_q: Dict[int, np.ndarray]
    facet_bary: np.ndarray
    facet_qw: np.ndarray
    # per boundary tag: (N_solved, nf, nq) Neumann -J_k_e . n on the exterior
    neumann_q: Dict[int, np.ndarray]
    # coupling constants C_r
    C_e: float = 1.0
    C_i: float = 1.0


class KNPSystem:
    def __init__(self, geom: DiscreteGeometry, ions: List[Ion],
                 params: PhysicalParams, splitting_scheme: bool = True,
                 mms: Optional[KNPMMSData] = None, dtype=torch.float64,
                 device=None, *, p1ops=None, memops=None, kst=None,
                 per_ion: bool = False):
        """``p1ops``: {tag: P1Operator} of ``geom`` on ``device``
        (:func:`ops.p1op.p1_operators`) and ``memops`` {membrane tag:
        P1Operator} (:func:`ops.p1op.membrane_operators`), shared with the
        EMI system (None: built here);
        ``per_ion``: assemble each solved ion's operator values for the
        per-ion solve (K11), which the batched one (K3) never reads;
        ``kst``: {tag: the unit stiffness's values on that operator}, the
        EMI system's tensors (shared, not copied), K3's second stream
        (None: assembled here)."""
        device = resolve_device(device)
        p1ops = p1ops or P.p1_operators(geom, device)
        memops = memops or P.membrane_operators(geom, device)
        if kst is None:
            kst = {t: torch.as_tensor(p1ops[t].assemble(
                direct._stiffness_coo(s.cells, s.grads, s.vols)[2])[0],
                dtype=dtype, device=device) for t, s in geom.subdomains.items()}
        self.geom = geom
        self.ions = ions
        self.params = params
        # a manufactured solution has no ODEs: splitting off
        self.splitting_scheme = splitting_scheme and mms is None
        self.mms = mms
        self.dtype = dtype
        self.device = device
        self.tags = geom.sub_tags
        self.n_solved = len(ions) - 1
        self.dim = geom.dim
        as_f = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
        as_i = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64, device=device)

        Ns, dt, psi = self.n_solved, params.dt, params.psi
        self.z_solved = as_f([ion.z for ion in ions[:-1]])
        self.z_all = as_f([ion.z for ion in ions])
        self.D = {t: as_f([ion.D[t] for ion in ions[:-1]]) for t in self.tags}
        self.D_all = {t: as_f([ion.D[t] for ion in ions]) for t in self.tags}
        self.sub = {}
        for t, s in geom.subdomains.items():
            D_t = [ion.D[t] for ion in ions[:-1]]
            op = p1ops[t]
            self.sub[t] = dict(
                n_dofs=s.n_dofs, n_cells=s.n_cells, op=op, cells=op.cells,
                grads=as_f(s.grads), vols=as_f(s.vols),
                # K4's map phi -> grad(phi) per cell
                grad=E.cell_gradient_ell(s.cells, s.grads, s.n_dofs, dtype, device),
                # K3's value streams: the unit mass and the unit stiffness
                M=P.mass_values(op, s.cells, s.vols, dtype),
                kst=kst[t],
                # K3 rows [1/dt, D, z psi D]: the solve's operator, and the
                # right-hand side's mass term (D = z = 0)
                coef=as_f([[1.0 / dt, D, ion.z * psi * D]
                           for ion, D in zip(ions[:-1], D_t)]),
                coef_mass=as_f([[1.0 / dt, 0.0, 0.0]] * Ns),
            )
        self.mem = {}
        for m, sp in geom.membranes.items():
            self.mem[m] = dict(
                # op.cells: the facets' dofs, K9's index map
                n_mem=sp.n_dofs, cell_tag=sp.cell_tag, op=memops[m], areas=as_f(sp.areas),
                mem_to_ecs=as_i(sp.mem_to_ecs), mem_to_ics=as_i(sp.mem_to_ics),
            )
        # {tag: [P_b per solved ion]} on the subdomain's P1 operator
        self.ion_vals = {
            t: ion_operator_values(p1ops[t], s.cells, s.grads, s.vols, 1.0 / dt,
                                   [ion.D[t] for ion in ions[:-1]], dtype)
            for t, s in geom.subdomains.items()} if per_ion else {}
        fb, fw = quad.facet_rule(self.dim)
        self.fb, self.fw = as_f(fb), as_f(fw)
        self._src_vec = self._source_vectors(geom, ions)
        # a manufactured solution: {tag: the exact drift's values} and
        # {tag: (N_solved, n) the static load vector}
        self.mms_drift, self._mms_load = {}, {}
        if mms is not None:
            for t, s in geom.subdomains.items():
                self.mms_drift[t] = mms_drift_values(
                    p1ops[t], s.cells, s.grads, s.vols, np.asarray(mms.gradphi_q[t]),
                    np.asarray(mms.cell_bary), np.asarray(mms.cell_qw), dtype)
            self._mms_load = self._mms_vectors(geom, mms)

    def _mms_vectors(self, geom: DiscreteGeometry, mms: KNPMMSData):
        """{tag: (N_solved, n)}: the manufactured solution's static load
        vectors, the ion sources f_k, the membrane Robin terms C_e (dphi -
        g_e) on the ECS side and C_i (g_i - dphi) on the ICS side and the
        exterior Neumann flux, summed on the host in float64, then cast
        and moved."""
        host = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)
        idx = lambda a: torch.as_tensor(np.asarray(a, np.int64))
        Ns = self.n_solved
        r = {t: torch.zeros(Ns, s.n_dofs, dtype=torch.float64)
             for t, s in geom.subdomains.items()}
        cb, cw = host(mms.cell_bary), host(mms.cell_qw)
        for t, fq in mms.f_k_q.items():
            s = geom.subdomains[t]
            for k in range(Ns):
                r[t][k] += K.source_rhs_quad(s.n_dofs, host(fq[k]), idx(s.cells),
                                             host(s.vols), cb, cw)
        fb, fw = host(mms.facet_bary), host(mms.facet_qw)
        for m, sp in geom.membranes.items():
            ct, ar = sp.cell_tag, host(sp.areas)
            dphi = host(mms.dphi_q[m])
            ge, gi = host(mms.g_robin_e_q[m]), host(mms.g_robin_i_q[m])
            for k in range(Ns):
                r[0][k] += K.facet_rhs_quad(geom.subdomains[0].n_dofs,
                                            mms.C_e * (dphi - ge[k]),
                                            idx(sp.facet_edofs), ar, fb, fw)
                r[ct][k] += K.facet_rhs_quad(geom.subdomains[ct].n_dofs,
                                             mms.C_i * (gi[k] - dphi),
                                             idx(sp.facet_idofs), ar, fb, fw)
        for btag, nq in mms.neumann_q.items():
            bs = geom.boundaries[btag]
            jq = host(nq)
            for k in range(Ns):
                r[bs.sub_tag][k] += K.facet_rhs_quad(
                    geom.subdomains[bs.sub_tag].n_dofs, jq[k], idx(bs.facet_dofs),
                    host(bs.areas), fb, fw)
        return {t: v.to(self.device, self.dtype) for t, v in r.items()}

    def _source_vectors(self, geom: DiscreteGeometry, ions):
        """{tag: (N_solved, n) or None}: the load vector of every solved
        ion's source term, from its values at the cell quadrature points
        (``Ion.f_source_q``); an ion without one contributes a zero row.
        Summed on the host in float64, then cast and moved: a scatter on
        the card adds with atomics in a varying order, and two builds of
        one scenario gave different bits."""
        host = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)
        cb, cw = (host(a) for a in quad.cell_rule(self.dim))
        out = {}
        for t, sub in geom.subdomains.items():
            if not any(ion.f_source_q and t in ion.f_source_q for ion in ions[:-1]):
                out[t] = None
                continue
            cells = torch.as_tensor(np.asarray(sub.cells, np.int64))
            rows = [K.source_rhs_quad(sub.n_dofs, host(ion.f_source_q[t]), cells,
                                      host(sub.vols), cb, cw)
                    if ion.f_source_q and t in ion.f_source_q
                    else torch.zeros(sub.n_dofs, dtype=torch.float64)
                    for ion in ions[:-1]]
            out[t] = torch.stack(rows).to(self.device, self.dtype)
        return out

    # ------------------------------------------------------------------
    def gradphi_cells(self, phi: Dict[int, torch.Tensor]) -> Dict[int, torch.Tensor]:
        """Per-tag drift context: grad(phi) per cell, (n_cells, dim), by K4."""
        return {
            t: E.ellw_matvec(s["grad"], phi[t].contiguous())
            .reshape(s["n_cells"], self.dim)
            for t, s in self.sub.items()
        }

    def matvec_batch(self, tag: int, X: torch.Tensor, Dr: torch.Tensor):
        """All solved ion systems of one subdomain in one K3 pass, with
        ``Dr`` from :meth:`drift_values`: X (N_solved, n) -> (N_solved, n)."""
        s = self.sub[tag]
        return P.knp_apply_batch(X.contiguous(), s["op"], s["coef"], s["M"], s["kst"], Dr)

    def drift_values(self, tag: int, gradphi: torch.Tensor) -> torch.Tensor:
        """The drift along grad(phi) on the subdomain's P1 operator, by
        K11f: once per solve, shared by every solved ion (K3 and K11).
        Under a manufactured solution, the exact drift's values assembled
        at setup (``gradphi`` unused)."""
        if self.mms is not None:
            return self.mms_drift[tag]
        s = self.sub[tag]
        return P.drift_fill(s["op"], s["grads"], s["vols"], gradphi)

    def matvec_one(self, tag: int, k: int, x: torch.Tensor, Dr: torch.Tensor):
        """Solved ion ``k``'s system of one subdomain by K11: x (n,) ->
        (n,), with ``Dr`` from :meth:`drift_values`."""
        ion = self.ions[k]
        return P.knp_apply(x.contiguous(), self.sub[tag]["op"], self.ion_vals[tag][k],
                           Dr, ion.z * self.params.psi * ion.D[tag])

    def diag(self, tag: int, gradphi: torch.Tensor) -> torch.Tensor:
        """Batched Jacobi diagonal (N_solved, n) (plain, the same bits every
        call; the coupled step takes the hierarchy's lagged diagonal
        instead): per cell vertex (1/dt) 2 vol / (k (k + 1)) + D vol |g_i|^2
        + z psi D vol (grad(phi) . g_i) / k, summed by
        ``P1Operator.scatter_cells``."""
        s = self.sub[tag]
        k = s["op"].k
        dt, psi = self.params.dt, self.params.psi
        vols, grads = s["vols"][:, None], s["grads"]
        md = (2.0 / (dt * k * (k + 1))) * vols
        sd = (grads * grads).sum(dim=-1) * vols
        dd = torch.einsum("cd,ckd->ck", gradphi, grads) * (vols / k)
        D = self.D[tag][:, None, None]
        z = self.z_solved[:, None, None]
        return s["op"].scatter_cells(md + D * sd + z * psi * D * dd)

    # ------------------------------------------------------------------
    def _robin_facet_values(self, ct: int, Xloc: torch.Tensor, areas: torch.Tensor):
        """Per-slot assembled values of the membrane Robin terms from
        facet-local P1 values.  Xloc: (F, nf, k) stacked fields
        [c_e (N) | c_i (N) | dphi | phi_M | I_ch (N)]; returns (2 Ns, nf, k),
        the e-side then the i-side values, area- and quadrature-weighted."""
        p = self.params
        dt, Fc, C_M = p.dt, p.F, p.C_M
        N, Ns = len(self.ions), self.n_solved
        fb, fw = self.fb, self.fw
        Tq = torch.einsum("fmk,qk->fmq", Xloc, fb)
        c_e_q, c_i_q = Tq[:N], Tq[N:2 * N]
        dphi_q, phiM_q = Tq[2 * N], Tq[2 * N + 1]
        Ich_q = Tq[2 * N + 2:]

        def alpha(tag, cq):
            Dz2 = self.D_all[tag] * self.z_all ** 2
            w = Dz2[:, None, None] * cq
            den = w.sum(dim=0)
            den = torch.where(den == 0, torch.ones_like(den), den)
            return w[:Ns] / den[None]

        alpha_e = alpha(0, c_e_q)
        alpha_i = alpha(ct, c_i_q)
        z = self.z_solved[:, None, None]
        C_e = alpha_e * C_M / (Fc * z * dt)
        C_i = alpha_i * C_M / (Fc * z * dt)
        Ich_tot_q = Ich_q.sum(dim=0)
        Ich_k_q = Ich_q[:Ns]
        g_e = phiM_q[None] - dt / (C_M * alpha_e) * Ich_k_q
        g_i = phiM_q[None] - dt / (C_M * alpha_i) * Ich_k_q
        if self.splitting_scheme:
            g_e = g_e + (dt / C_M) * Ich_tot_q[None]
            g_i = g_i + (dt / C_M) * Ich_tot_q[None]
        integ = torch.cat(
            [C_e * (dphi_q[None] - g_e), C_i * (g_i - dphi_q[None])], dim=0
        )
        return torch.einsum("smq,q,qk->smk", integ, fw, fb) * areas[None, :, None]

    def _membrane_rhs(self, mb, c, phi, phi_M_m, I_ch_m):
        """Membrane Robin right-hand side in membrane-dof space: K9, the
        quadrature algebra, K10.  Returns (y_e, y_i), each (Ns, n_mem)."""
        ct = mb["cell_tag"]
        m2e, m2i = mb["mem_to_ecs"], mb["mem_to_ics"]
        X = torch.cat([
            c[0][:, m2e], c[ct][:, m2i],
            (phi[ct][m2i] - phi[0][m2e])[None], phi_M_m[None], I_ch_m,
        ], dim=0)  # (F, n_mem)
        G = A.facet_gather(X, mb["op"].cells)
        vals = self._robin_facet_values(ct, G, mb["areas"])
        Y = A.facet_scatter(vals.contiguous(), mb["op"])
        return Y[: self.n_solved], Y[self.n_solved:]

    def rhs(self, c, phi, phi_M, I_ch=None, source_gate=1.0) -> Dict[int, torch.Tensor]:
        """RHS per subdomain: {tag: (N_solved, n)} — the mass term
        (1/dt) M c_prev by K3's mass-only apply, the gated source term, plus
        the membrane terms; under a manufactured solution the mass term
        plus the static load vector.  ``source_gate`` is a number or a 0-d
        tensor."""
        Ns = self.n_solved
        if torch.is_tensor(source_gate):
            source_gate = source_gate.to(self.dtype)
        r = {}
        for t, s in self.sub.items():
            r[t] = P.knp_apply_batch(c[t][:Ns].contiguous(), s["op"], s["coef_mass"],
                                     s["M"])
            if self._src_vec[t] is not None:
                r[t] = r[t] + source_gate * self._src_vec[t]
            if self.mms is not None:
                r[t] = r[t] + self._mms_load[t]
        if self.mms is not None:
            return r
        for m, mb in self.mem.items():
            y_e, y_i = self._membrane_rhs(mb, c, phi, phi_M[m], I_ch[m])
            ct = mb["cell_tag"]
            r[0] = r[0].index_add(1, mb["mem_to_ecs"], y_e)
            r[ct] = r[ct].index_add(1, mb["mem_to_ics"], y_i)
        return r


def create_functions_knp(geom: DiscreteGeometry, ions: List[Ion], dtype=torch.float64,
                         device=None):
    """Concentration state {tag: zeros(N_ions, n_dofs)} on ``device``
    (None: CUDA); the eliminated ion is the last row."""
    device = resolve_device(device)
    return {t: torch.zeros(len(ions), s.n_dofs, dtype=dtype, device=device)
            for t, s in geom.subdomains.items()}


def knp_system(geom: DiscreteGeometry, ions: List[Ion], params: PhysicalParams,
               splitting_scheme: bool = True, mms: Optional[KNPMMSData] = None,
               dtype=torch.float64, device=None, p1ops=None, memops=None, kst=None,
               per_ion: bool = False) -> KNPSystem:
    return KNPSystem(geom, ions, params, splitting_scheme, mms, dtype, device,
                     p1ops=p1ops, memops=memops, kst=kst, per_ion=per_ion)
