"""PDE <-> PDE and PDE <-> ODE coupling: traces, eliminated ion, phi_M.

Counterpart of ``knpemi_tpu/systems/coupling.py``: for broken P1 spaces
the two-sided membrane trace is an exact vertex gather through the maps
``mem_to_ecs`` / ``mem_to_ics``; the eliminated ion follows from bulk
electroneutrality, c_elim = -(1/z_N)(sum_k z_k c_k + z_rho rho); and
phi_M = tr_i(phi_i) - tr_e(phi_e) (``interpolate_to_membrane``,
``membrane_potential_from_phi``; the step itself gathers through
:func:`membrane_maps`' device tensors).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..ops.geometry import DiscreteGeometry, MembraneSpace
from .types import Ion, PhysicalParams, resolve_device


def set_initial_conditions(geom: DiscreteGeometry, ions: List[Ion],
                           dtype=torch.float64, device=None) -> Dict[int, torch.Tensor]:
    """Concentration state {tag: (N_ions, n_dofs)} from each ion's per-tag
    initial condition (constant or per-dof array); ``device=None`` means
    CUDA."""
    device = resolve_device(device)
    c = {}
    for tag, sub in geom.subdomains.items():
        rows = [
            np.broadcast_to(np.asarray(ion.c_init[tag], np.float64), (sub.n_dofs,))
            for ion in ions
        ]
        c[tag] = torch.as_tensor(np.stack(rows), dtype=dtype, device=device)
    return c


def membrane_maps(geom: DiscreteGeometry, device) -> Dict[int, Tuple[torch.Tensor, torch.Tensor]]:
    """{membrane tag: (mem_to_ecs, mem_to_ics)} as int64 device tensors."""
    return {
        m: (torch.as_tensor(mem.mem_to_ecs, dtype=torch.int64, device=device),
            torch.as_tensor(mem.mem_to_ics, dtype=torch.int64, device=device))
        for m, mem in geom.membranes.items()
    }


def interpolate_to_membrane(u_e, u_i, membrane: MembraneSpace | dict):
    """Two-sided membrane traces (tr_e, tr_i) of subdomain fields on the
    membrane dof numbering: a gather through ``mem_to_ecs`` /
    ``mem_to_ics`` over the last axis (tensors on their own device, or
    numpy arrays)."""
    get = membrane.get if isinstance(membrane, dict) else lambda k: getattr(membrane, k)
    m2e, m2i = get("mem_to_ecs"), get("mem_to_ics")
    if torch.is_tensor(u_e):
        m2e = torch.as_tensor(m2e, dtype=torch.int64, device=u_e.device)
        m2i = torch.as_tensor(m2i, dtype=torch.int64, device=u_i.device)
    return u_e[..., m2e], u_i[..., m2i]


def membrane_potential_from_phi(phi_e, phi_i, membrane):
    """phi_M = tr_i(phi_i) - tr_e(phi_e) on ``membrane``."""
    tr_e, tr_i = interpolate_to_membrane(phi_e, phi_i, membrane)
    return tr_i - tr_e


def eliminated_concentration(c_solved, zs, z_elim: float, rho_z: float, rho):
    """c_elim = -(1/z_N)(sum_k z_k c_k + z_rho * rho); c_solved (N-1, n)."""
    z = torch.as_tensor(np.asarray(zs), dtype=c_solved.dtype, device=c_solved.device)
    s = torch.einsum("k,kn->n", z, c_solved)
    return -(s + rho_z * rho) / z_elim


def update_pde_variables(geom: DiscreteGeometry, ions: List[Ion],
                         params: PhysicalParams, c_new, phi, maps):
    """End-of-step refresh: given the solved concentrations (N_ions-1 rows
    per tag) and potentials, return (c with the eliminated row appended,
    phi_M per membrane tag).  ``maps`` is :func:`membrane_maps`."""
    zs = [ion.z for ion in ions[:-1]]
    c_out = {}
    for tag in geom.subdomains:
        rho = params.rho.get(tag, 0.0)
        c_el = eliminated_concentration(c_new[tag], zs, ions[-1].z, params.rho_z, rho)
        c_out[tag] = torch.cat([c_new[tag], c_el[None, :]], dim=0)
    phi_M = {}
    for m, mem in geom.membranes.items():
        m2e, m2i = maps[m]
        phi_M[m] = phi[mem.cell_tag][m2i] - phi[0][m2e]
    return c_out, phi_M
