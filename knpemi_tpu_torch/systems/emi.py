"""The EMI (potential) block system, matrix-free, on the Hopper kernels.

Counterpart of ``knpemi_tpu/systems/emi.py`` on its blocked-assembly
path (``use_pallas``): one block elliptic system for the potentials of
all subdomains, coupled through the membrane facet terms,

    sum_s int kappa_s grad(phi_s).grad(v_s) + sum_m C_phi int (phi_i - phi_e)(v_i - v_e)
  = sum_s sum_k -F z_k int D_k grad(c_k).grad(v_s) + sum_m C_phi int g (v_i - v_e)

with kappa_s = F psi sum_k z_k^2 D_k c_k a P1 field of the previous
concentrations.  Each subdomain's stiffness is an assembled P1 operator
(:class:`ops.p1op.P1Operator`, shared with the KNP system).  Per solve,
K4 (:func:`ops.ell.ellw_matvec`) forms the per-cell mean-vertex
kappa and K1f (:func:`ops.p1op.emi_fill`) fills the operator's values;
per matvec, K1 (:func:`ops.p1op.emi_stiffness`) applies them and K2
(:func:`ops.p1op.surface_mass`) the membrane surface mass C_phi M_Gamma
in membrane-dof space, on the membrane's P1 operator (shared with the
KNP system) with M_Gamma summed once at setup, with one gather and one
scatter through ``flat_idx`` (``emi.py:321-326``).  The right-hand
side's unit-weight stiffness is assembled once.  The system is pure
Neumann with the constant null vector, unless a manufactured solution
(``mms``, :class:`EMIMMSData`) attaches a Dirichlet condition: then
``matvec`` is the symmetric elimination around the unmasked apply
(identity on the boundary dofs, the coupling included in the masked
part) and there is no null vector.  Under ``mms`` the splitting scheme
is off and the right-hand side takes the manufactured sources, Robin
and current-jump data and Neumann flux, a load vector summed once on
the host in float64 (the data are static), and the Dirichlet lift.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops import ell as E
from ..ops import kernels as K
from ..ops import p1op as P
from ..ops.geometry import DiscreteGeometry
from ..solvers import direct
from .types import Ion, PhysicalParams, resolve_device


@dataclasses.dataclass
class EMIMMSData:
    """Extra manufactured-solution terms, numpy arrays (the JAX package's
    ``EMIMMSData``)."""

    # per subdomain tag: source f_phi at the cell quadrature points (nc, nq)
    f_phi_q: Dict[int, np.ndarray]
    cell_bary: np.ndarray  # (nq, d+1)
    cell_qw: np.ndarray  # (nq,)
    # per membrane tag: Robin data / current jump at the facet quadrature points
    f_phi_m_q: Dict[int, np.ndarray]
    f_I_M_q: Dict[int, np.ndarray]
    facet_bary: np.ndarray  # (nqf, d)
    facet_qw: np.ndarray
    # Neumann flux sum_k -F z_k (J_k_e . n) at boundary facet quadrature
    # points, per boundary tag
    neumann_q: Dict[int, np.ndarray]
    # Dirichlet condition on the ECS exterior boundary: (local ECS dofs, values)
    dirichlet_dofs: Optional[np.ndarray] = None
    dirichlet_vals: Optional[np.ndarray] = None


class EMISystem:
    def __init__(self, geom: DiscreteGeometry, ions: List[Ion],
                 params: PhysicalParams, splitting_scheme: bool = True,
                 mms: Optional[EMIMMSData] = None, dtype=torch.float64,
                 device=None, *, p1ops=None, memops=None):
        """``p1ops``: {tag: P1Operator} of ``geom`` on ``device``
        (:func:`ops.p1op.p1_operators`), ``memops`` {membrane tag:
        P1Operator} (:func:`ops.p1op.membrane_operators`), both shared
        with the KNP system (None: built here)."""
        device = resolve_device(device)
        p1ops = p1ops or P.p1_operators(geom, device)
        memops = memops or P.membrane_operators(geom, device)
        self.geom = geom
        self.ions = ions
        self.params = params
        # a manufactured solution has no ODEs: splitting off
        self.splitting_scheme = splitting_scheme and mms is None
        self.mms = mms
        self.dtype = dtype
        self.device = device
        self.tags = geom.sub_tags
        self.offsets = geom.emi_offsets()
        self.n = geom.emi_size
        as_f = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        self.sub = {}
        for t, s in geom.subdomains.items():
            op = p1ops[t]
            self.sub[t] = dict(
                n_dofs=s.n_dofs, op=op, grads=as_f(s.grads),
                vols=as_f(s.vols),
                # K4's map kappa -> mean-vertex kappa per cell
                kbar=E.cell_mean_ell(s.cells, s.n_dofs, dtype, device),
                # the right-hand side's unit-weight stiffness on the pattern
                kst=as_f(op.assemble(direct._stiffness_coo(s.cells, s.grads, s.vols)[2])[0]),
            )
        self.mem = {}
        for m, sp in geom.membranes.items():
            flat_idx = np.concatenate([
                self.offsets[0] + sp.mem_to_ecs,
                self.offsets[sp.cell_tag] + sp.mem_to_ics,
            ])
            self.mem[m] = dict(
                n_mem=sp.n_dofs, cell_tag=sp.cell_tag, op=memops[m],
                # K2's values: the surface mass M_Gamma on the membrane's operator
                M=P.mass_values(memops[m], sp.facet_dofs, sp.areas, dtype),
                flat_idx=torch.as_tensor(flat_idx, dtype=torch.int64, device=device),
            )
        # the Dirichlet mask (flat; a manufactured solution only)
        mask = np.ones(self.n)
        self._bc_vals_flat = None
        if mms is not None and mms.dirichlet_dofs is not None:
            off0 = self.offsets[0]
            mask[off0 + mms.dirichlet_dofs] = 0.0
            v = np.zeros(self.n)
            v[off0 + mms.dirichlet_dofs] = mms.dirichlet_vals
            self._bc_vals_flat = as_f(v)
        self.bc_mask = as_f(mask)
        self.has_bc = self._bc_vals_flat is not None
        # the normalized constant null vector (pure Neumann only)
        self.nullvec = None if self.has_bc else torch.full(
            (self.n,), 1.0 / np.sqrt(self.n), dtype=dtype, device=device)
        # the membrane mass's part of the Jacobi diagonal, flat: static,
        # summed at the first :meth:`diag` (only the solves without a
        # hierarchy read it)
        self._mem_diag_flat = None
        self._mms_load = None if mms is None else self._mms_vector(geom, mms)

    def _mms_vector(self, geom: DiscreteGeometry, mms: EMIMMSData) -> torch.Tensor:
        """The manufactured solution's static load vector, flat: the cell
        sources, the membrane Robin data C_phi f_phi_m (+ on the ICS side,
        - on the ECS side), the current jump f_I_M on the ECS side and the
        exterior Neumann flux, summed on the host in float64, then cast
        and moved."""
        host = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)
        idx = lambda a: torch.as_tensor(np.asarray(a, np.int64))
        C_phi = self.params.C_phi
        rs = {t: torch.zeros(s.n_dofs, dtype=torch.float64)
              for t, s in geom.subdomains.items()}
        cb, cw = host(mms.cell_bary), host(mms.cell_qw)
        for t, fq in mms.f_phi_q.items():
            s = geom.subdomains[t]
            rs[t] += K.source_rhs_quad(s.n_dofs, host(fq), idx(s.cells), host(s.vols), cb, cw)
        fb, fw = host(mms.facet_bary), host(mms.facet_qw)
        n0 = geom.subdomains[0].n_dofs
        for m, sp in geom.membranes.items():
            ct, ar = sp.cell_tag, host(sp.areas)
            fpm = C_phi * host(mms.f_phi_m_q[m])
            rs[ct] += K.facet_rhs_quad(geom.subdomains[ct].n_dofs, fpm,
                                       idx(sp.facet_idofs), ar, fb, fw)
            rs[0] -= K.facet_rhs_quad(n0, fpm, idx(sp.facet_edofs), ar, fb, fw)
            rs[0] -= K.facet_rhs_quad(n0, host(mms.f_I_M_q[m]), idx(sp.facet_edofs),
                                      ar, fb, fw)
        for btag, nq in mms.neumann_q.items():
            bs = geom.boundaries[btag]
            rs[bs.sub_tag] += K.facet_rhs_quad(
                geom.subdomains[bs.sub_tag].n_dofs, host(nq), idx(bs.facet_dofs),
                host(bs.areas), fb, fw)
        return self.flatten(rs).to(self.device, self.dtype)

    # ------------------------------------------------------------------
    def split(self, x: torch.Tensor) -> Dict[int, torch.Tensor]:
        return {
            t: x[self.offsets[t]: self.offsets[t] + self.sub[t]["n_dofs"]]
            for t in self.tags
        }

    def flatten(self, d: Dict[int, torch.Tensor]) -> torch.Tensor:
        return torch.cat([d[t] for t in self.tags])

    def kappa(self, c: Dict[int, torch.Tensor]) -> Dict[int, torch.Tensor]:
        """Tissue conductance per subdomain, P1 vertex field:
        kappa = F psi sum_k z_k^2 D_k c_k."""
        F, psi = self.params.F, self.params.psi
        out = {}
        for t in self.tags:
            acc = 0.0
            for k, ion in enumerate(self.ions):
                acc = acc + (ion.z ** 2) * ion.D[t] * c[t][k]
            out[t] = F * psi * acc
        return out

    def prepare(self, kappa: Dict[int, torch.Tensor]) -> dict:
        """Per-solve operator: the weighted stiffness's values on each
        subdomain's P1 operator, filled by K1f from wv = vol * mean-vertex
        kappa per cell (the mean by K4 on the frozen dof -> cell map)."""
        vals = {}
        for t in self.tags:
            s = self.sub[t]
            kbar = E.ellw_matvec(s["kbar"], kappa[t].contiguous())
            vals[t] = P.emi_fill(s["op"], s["grads"], s["vols"] * kbar)
        return {"kappa": kappa, "vals": vals}

    def matvec_free(self, x: torch.Tensor, ctx: dict) -> torch.Tensor:
        """A @ x without the Dirichlet mask: K1 per subdomain, then the
        membrane coupling C_phi M_Gamma (u_i - u_e) by K2 in membrane-dof
        space."""
        xs = self.split(x)
        y = self.flatten({
            t: P.emi_stiffness(xs[t], self.sub[t]["op"], ctx["vals"][t])
            for t in self.tags
        })
        C_phi = self.params.C_phi
        for mb in self.mem.values():
            n_m = mb["n_mem"]
            u2 = x[mb["flat_idx"]]  # [R_e x | R_i x]
            w = P.surface_mass(u2[n_m:] - u2[:n_m], mb["op"], mb["M"], C_phi)
            y = y.index_add(0, mb["flat_idx"], torch.cat([-w, w]))
        return y

    def matvec(self, x: torch.Tensor, ctx: dict) -> torch.Tensor:
        """The operator with symmetric Dirichlet elimination: the identity
        on the boundary dofs, the masked unmasked apply (coupling
        included) on the others, so that CG keeps a symmetric operator."""
        if not self.has_bc:
            return self.matvec_free(x, ctx)
        m = self.bc_mask
        return self.matvec_free(x * m, ctx) * m + x * (1.0 - m)

    def diag(self, kappa: Dict[int, torch.Tensor]) -> torch.Tensor:
        """The Jacobi diagonal (plain, the same bits every call): each
        subdomain's weighted stiffness diagonal, vol mean-vertex kappa
        |g_i|^2 per cell vertex summed by ``P1Operator.scatter_cells``, plus
        the membrane mass's, 1 on Dirichlet dofs."""
        ds = {}
        for t in self.tags:
            s = self.sub[t]
            op = s["op"]
            w = s["vols"] * kappa[t][op.cells.long()].mean(dim=1)
            ds[t] = op.scatter_cells((s["grads"] * s["grads"]).sum(dim=-1) * w[:, None])
        if self._mem_diag_flat is None:
            dmem = np.zeros(self.n)
            for sp in self.geom.membranes.values():
                kf = sp.facet_dofs.shape[1]
                dv = 2.0 * np.asarray(sp.areas) * self.params.C_phi / (kf * (kf + 1))
                np.add.at(dmem, self.offsets[sp.cell_tag] + sp.facet_idofs, dv[:, None])
                np.add.at(dmem, self.offsets[0] + sp.facet_edofs, dv[:, None])
            self._mem_diag_flat = torch.as_tensor(dmem, dtype=self.dtype, device=self.device)
        d = self.flatten(ds) + self._mem_diag_flat
        if self.has_bc:
            d = d * self.bc_mask + (1.0 - self.bc_mask)
        return d

    def rhs(self, c, phi_M, I_ch=None, ctx: Optional[dict] = None) -> torch.Tensor:
        """Right-hand side: the diffusive driving -sum_k F z_k D_k K c_k
        as ONE K1 action of the unit-weight stiffness on the centered
        combined field, plus the membrane Robin data C_phi M_Gamma g by
        K2; under a manufactured solution the static load vector in place
        of the Robin data, and with a Dirichlet condition the symmetric
        lift b_free - A_free x_bc, b_bc = x_bc, from ``ctx`` (this
        solve's :meth:`prepare`; None: prepared here)."""
        F, C_phi = self.params.F, self.params.C_phi
        rs = {}
        for t in self.tags:
            s = self.sub[t]
            u_star = torch.zeros(s["n_dofs"], dtype=self.dtype, device=self.device)
            for k, ion in enumerate(self.ions):
                u_star = u_star + (F * ion.z * ion.D[t]) * c[t][k]
            # electroneutrality keeps u* nearly uniform: center it so the
            # stiffness acts on the variation, not on f32 roundoff of the
            # large mean
            u_star = u_star - u_star.mean()
            rs[t] = P.emi_stiffness(u_star, s["op"], s["kst"], -1.0)
        b = self.flatten(rs)
        if self.mms is not None:
            b = b + self._mms_load
        else:
            for m, mb in self.mem.items():
                g = phi_M[m]
                if not self.splitting_scheme:
                    g = g - (1.0 / C_phi) * I_ch[m].sum(dim=0)
                w = P.surface_mass(g.contiguous(), mb["op"], mb["M"], C_phi)
                b = b.index_add(0, mb["flat_idx"], torch.cat([-w, w]))
        if self.has_bc:
            ctx = ctx if ctx is not None else self.prepare(self.kappa(c))
            b = self.bc_mask * (b - self.matvec_free(self._bc_vals_flat, ctx))
            b = b + self._bc_vals_flat
        return b


def create_functions_emi(geom: DiscreteGeometry, dtype=torch.float64, device=None):
    """Potential arrays {tag: zeros(n_dofs)} and membrane potential arrays
    {membrane tag: zeros(n_mem)} on ``device`` (None: CUDA)."""
    device = resolve_device(device)
    phi = {t: torch.zeros(s.n_dofs, dtype=dtype, device=device)
           for t, s in geom.subdomains.items()}
    phi_M = {m: torch.zeros(sp.n_dofs, dtype=dtype, device=device)
             for m, sp in geom.membranes.items()}
    return phi, phi_M


def emi_system(geom: DiscreteGeometry, ions: List[Ion], params: PhysicalParams,
               splitting_scheme: bool = True, mms: Optional[EMIMMSData] = None,
               dtype=torch.float64, device=None, p1ops=None, memops=None) -> EMISystem:
    return EMISystem(geom, ions, params, splitting_scheme, mms, dtype, device,
                     p1ops=p1ops, memops=memops)
