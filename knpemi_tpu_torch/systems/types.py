"""Core data model: ions, physical parameters, simulation state.

Counterpart of ``knpemi_tpu/systems/types.py``:

* ``Ion`` — name, valence z, per-subdomain diffusion D, initial
  concentrations; **the last ion in a list is eliminated** via bulk
  electroneutrality and never solved for.
* ``PhysicalParams`` — dt, F, psi = F/(R*T), C_phi = C_M/dt, C_M, R,
  temperature, immobile background charge rho (with valence rho_z).
* ``SubdomainDef`` — a declarative subdomain description: tag, name,
  membrane tags and ODE models per membrane.
* ``SimState`` — the complete per-step state as a dataclass of tensors:
  concentrations (all ions, eliminated included), bulk potentials,
  membrane potentials, membrane ODE states/parameters, time and the
  last step's solver diagnostics.
* ``resolve_device`` — the device rule of every entry point: ``None``
  means CUDA, and raises without it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class Ion:
    """One ion species. D/c_init are keyed by subdomain tag."""

    name: str
    z: float
    D: Dict[int, float]
    c_init: Dict[int, Any] = dataclasses.field(default_factory=dict)
    # optional source term: {tag: (n_cells, n_q)} values at the cell
    # quadrature points; its time gate is the simulation's ``source_gate``
    f_source_q: Optional[Dict[int, np.ndarray]] = None


@dataclasses.dataclass
class SubdomainDef:
    """Declarative subdomain description."""

    tag: int
    name: str
    membrane_tags: List[int] = dataclasses.field(default_factory=list)
    ode_models: Dict[int, Any] = dataclasses.field(default_factory=dict)


def resolve_device(device) -> torch.device:
    """``None`` means CUDA; without CUDA that raises rather than running on
    the CPU unasked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available")
    return device


@dataclasses.dataclass
class PhysicalParams:
    dt: float
    F: float = 96485.0
    R: float = 8.314
    temperature: float = 300.0
    C_M: float = 0.02
    n_steps_ODE: int = 25
    rho_z: float = -1.0
    rho: Dict[int, float] = dataclasses.field(default_factory=dict)

    @property
    def psi(self) -> float:
        return self.F / (self.R * self.temperature)

    @property
    def C_phi(self) -> float:
        return self.C_M / self.dt


@dataclasses.dataclass
class SimState:
    """Complete simulation state (dict values keyed by tag).

    c: {subdomain tag: (N_ions, n_dofs)} — concentrations, the last row is
        the eliminated ion.
    phi: {subdomain tag: (n_dofs,)} — bulk potentials of the last EMI solve.
    phi_M: {membrane tag: (n_mem_dofs,)} — membrane potential.
    ode_states: {membrane tag: (n_mem_dofs, n_states)}.
    ode_params: {membrane tag: (n_mem_dofs, n_params)}.
    t: 0-d float64 simulation time; step: 0-d int32 step counter.
    emi_iters / knp_iters / emi_ok / knp_ok / emi_res / knp_res: Krylov
        diagnostics of the last step (0-d tensors).
    """

    c: Dict[int, torch.Tensor]
    phi: Dict[int, torch.Tensor]
    phi_M: Dict[int, torch.Tensor]
    ode_states: Dict[int, torch.Tensor]
    ode_params: Dict[int, torch.Tensor]
    t: torch.Tensor
    step: torch.Tensor
    emi_iters: torch.Tensor
    knp_iters: torch.Tensor
    emi_ok: torch.Tensor
    knp_ok: torch.Tensor
    emi_res: torch.Tensor
    knp_res: torch.Tensor
