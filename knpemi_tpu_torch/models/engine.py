"""Membrane ODE engine: fixed-substep RK4 over every membrane dof at once.

Counterpart of ``knpemi_tpu/models/engine.py``: ``rk4_step`` (:41),
``MembraneModel.step`` (:100) and ``update_ode_variables`` (:182).  The
JAX package vmaps a per-point RK4 under ``lax.scan``; here the same
elementwise arithmetic runs on (n, S) tensors in a Python loop over the
substeps.  State lives outside the model object.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops.geometry import DiscreteGeometry, MembraneSpace
from .registry import ODEModel


def rk4_step(rhs, t, y, p, dt):
    k1 = rhs(t, y, p)
    k2 = rhs(t + dt / 2, y + dt / 2 * k1, p)
    k3 = rhs(t + dt / 2, y + dt / 2 * k2, p)
    k4 = rhs(t + dt, y + dt * k3, p)
    return y + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)


class MembraneModel:
    """Static metadata + stepping functions for one membrane tag."""

    def __init__(self, ode: ODEModel, membrane: MembraneSpace, n_steps_ODE: int = 25):
        self.ode = ode
        self.membrane = membrane
        self.tag = membrane.tag
        self.n_steps_ODE = int(n_steps_ODE)
        self.n_dofs = membrane.n_dofs
        self.dof_coords = membrane.coords
        self._sidx = {n: i for i, n in enumerate(ode.state_names)}
        self._pidx = {n: i for i, n in enumerate(ode.param_names)}
        self.states0 = self.init_states()
        self.params0 = self.init_params()

    def state_index(self, name: str) -> int:
        return self._sidx[name]

    def param_index(self, name: str) -> int:
        return self._pidx[name]

    # name-indexed setters and getters; a setter returns a new array (a
    # clone), as the JAX package's ``.at[].set`` does
    def set_state(self, states, name, values):
        out = states.clone()
        out[:, self._sidx[name]] = values
        return out

    def get_state(self, states, name):
        return states[:, self._sidx[name]]

    def set_param(self, params, name, values):
        out = params.clone()
        out[:, self._pidx[name]] = values
        return out

    def get_param(self, params, name):
        return params[:, self._pidx[name]]

    def set_membrane_potential(self, states, phi_M):
        return self.set_state(states, "V", phi_M)

    def get_membrane_potential(self, states):
        return self.get_state(states, "V")

    def init_states(self) -> np.ndarray:
        return np.tile(self.ode.init_states(), (self.n_dofs, 1))

    def init_params(self) -> np.ndarray:
        return np.tile(self.ode.init_params(), (self.n_dofs, 1))

    def step(self, states, params, t0, dt):
        """Advance all membrane dofs by dt with n_steps_ODE RK4 substeps;
        the substep clock runs in the state dtype, as in the JAX package."""
        n_sub = self.n_steps_ODE
        t = torch.as_tensor(t0, device=states.device).to(states.dtype)
        h = torch.tensor(dt / n_sub, dtype=states.dtype, device=states.device)
        y = states
        for _ in range(n_sub):
            y = rk4_step(self.ode.rhs, t, y, params, h)
            t = t + h
        return y

    def currents(self, states, params, t) -> Dict[str, torch.Tensor]:
        """Ion-specific channel currents at the current state: {ion: (n,)}."""
        t = torch.as_tensor(t, device=states.device).to(states.dtype)
        vals = self.ode.currents(t, states, params)
        return dict(zip(self.ode.current_names, vals))


def setup_membrane_model(
    stim_params: dict,
    physical_params,
    ode_models: Dict[int, ODEModel],
    geom: DiscreteGeometry,
    ions,
    n_steps_ODE: Optional[int] = None,
) -> List[MembraneModel]:
    """MembraneModels with PDE-consistent constants in the per-dof
    parameter arrays: Cm, psi and z_<ion> from the physical parameters,
    and the stimulus written at the dofs ``stim_params['stimulus_locator']``
    selects (initial arrays attached as ``.states0`` / ``.params0``)."""
    if n_steps_ODE is None:
        n_steps_ODE = getattr(physical_params, "n_steps_ODE", 25)
    stimulus = stim_params.get("stimulus") or {}
    locator = stim_params.get("stimulus_locator")
    mem_models = []
    for mtag, ode in ode_models.items():
        mm = MembraneModel(ode, geom.membranes[mtag], n_steps_ODE)
        params = mm.params0
        pset = dict(Cm=physical_params.C_M, psi=physical_params.psi)
        for ion in ions:
            pset[f"z_{ion.name}"] = ion.z
        for name, v in pset.items():
            if name in mm._pidx:
                params[:, mm.param_index(name)] = v
        if stimulus:
            if locator is None:
                mask = np.ones(mm.n_dofs, dtype=bool)
            else:
                mask = np.array([bool(locator(x)) for x in mm.dof_coords])
            for name, v in stimulus.items():
                params[mask, mm.param_index(name)] = v
        mem_models.append(mm)
    return mem_models


def update_ode_variables(mm: MembraneModel, params, states, c, phi_M, ions,
                         first_step, m2e, m2i):
    """Refresh the ODE inputs from the PDE state: two-sided concentration
    traces of every ion -> parameters ``<ion>_e`` / ``<ion>_i``; membrane
    potential -> state V, except on the very first step, where the ODE
    model's initial V is kept.  ``first_step`` is a 0-d bool tensor;
    ``m2e`` / ``m2i`` are the membrane -> ECS / ICS dof maps on the
    device.  Returns (params, states) as new tensors."""
    ct = mm.membrane.cell_tag
    params = params.clone()
    for k, ion in enumerate(ions):
        if f"{ion.name}_e" in mm._pidx:
            params[:, mm.param_index(f"{ion.name}_e")] = c[0][k][m2e]
            params[:, mm.param_index(f"{ion.name}_i")] = c[ct][k][m2i]
    v_idx = mm.state_index("V")
    states = states.clone()
    states[:, v_idx] = torch.where(first_step, states[:, v_idx], phi_M)
    return params, states
