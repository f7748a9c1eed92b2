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
Neumann with the constant null vector.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..ops import ell as E
from ..ops import p1op as P
from ..ops.geometry import DiscreteGeometry
from ..solvers import direct
from .types import Ion, PhysicalParams, resolve_device


class EMISystem:
    def __init__(self, geom: DiscreteGeometry, ions: List[Ion],
                 params: PhysicalParams, splitting_scheme: bool = True,
                 dtype=torch.float64, device=None, *, p1ops, memops):
        """``p1ops``: {tag: P1Operator} of ``geom`` on ``device``
        (:func:`ops.p1op.p1_operators`), ``memops`` {membrane tag:
        P1Operator} (:func:`ops.p1op.membrane_operators`), both shared
        with the KNP system."""
        device = resolve_device(device)
        self.geom = geom
        self.ions = ions
        self.params = params
        self.splitting_scheme = splitting_scheme
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
        self.nullvec = torch.full((self.n,), 1.0 / np.sqrt(self.n),
                                  dtype=dtype, device=device)

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

    def matvec(self, x: torch.Tensor, ctx: dict) -> torch.Tensor:
        """A @ x: K1 per subdomain, then the membrane coupling
        C_phi M_Gamma (u_i - u_e) by K2 in membrane-dof space."""
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

    def rhs(self, c, phi_M, I_ch=None) -> torch.Tensor:
        """Right-hand side: the diffusive driving -sum_k F z_k D_k K c_k
        as ONE K1 action of the unit-weight stiffness on the centered
        combined field, plus the membrane Robin data C_phi M_Gamma g by
        K2."""
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
        for m, mb in self.mem.items():
            g = phi_M[m]
            if not self.splitting_scheme:
                g = g - (1.0 / C_phi) * I_ch[m].sum(dim=0)
            w = P.surface_mass(g.contiguous(), mb["op"], mb["M"], C_phi)
            b = b.index_add(0, mb["flat_idx"], torch.cat([-w, w]))
        return b
