"""Glial (astrocyte) membrane model: inward-rectifying K (Kir) + leaks + pump.

Counterpart of ``knpemi_tpu/models/glial.py``: a single-state (V) model
in the millivolt/millisecond unit system of the astrocyte scenario
(temperature 307e3 mK, R 8.315e3, F 96500e3, C_M 1.0):

* Kir conductance with the sqrt(K_e / K_e_init) Boltzmann form,
* Na leak + Na/K exchanger pump
  i_pump = I_max (K_e/(K_e+m_K)) (Na_i^1.5/(Na_i^1.5+m_Na^1.5)),
* Cl leak.

The Nernst prefactor is 1/psi with psi pushed in from the PDE parameters
(1/psi ~ 26.45 mV).  Evaluated for every membrane dof at once: y (n, 1),
p (n, 20).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .registry import ODEModel, register_model

STATE_NAMES = ("V",)
PARAM_NAMES = (
    "g_leak_Cl", "g_leak_Na", "g_leak_K", "Cm", "stim_amplitude", "m_K",
    "m_Na", "I_max", "K_e_init", "K_i_init", "K_e", "K_i", "Na_e", "Na_i",
    "Cl_e", "Cl_i", "z_Na", "z_K", "z_Cl", "psi",
)

# resting V (mV)
DEFAULT_STATES = np.array([-85.84503411546689])
# conductances in mS/cm^2, I_max in uA/cm^2, concentrations in mol/m^3;
# Cm, psi and the traces are set from the PDE side
DEFAULT_PARAMS = np.array([
    0.05, 0.1, 1.696, 0.0, 0.0, 1.5, 10.0, 10.75975,
    3.092970607490389, 99.3100014897692,
    0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 1.0, -1.0, 0.0,
])

_P = {n: i for i, n in enumerate(PARAM_NAMES)}


def _ionic_currents(t, y, p):
    V = y[:, 0]
    par = {name: p[:, i] for name, i in _P.items()}
    psi = par["psi"]
    K_e, K_i = par["K_e"], par["K_i"]
    Na_i = par["Na_i"]
    # E_Na carries z_K, as in the JAX model (both valences are +1)
    E_Na = torch.log(par["Na_e"] / Na_i) / (psi * par["z_K"])
    E_K = torch.log(K_e / K_i) / (psi * par["z_K"])
    E_Cl = torch.log(par["Cl_e"] / par["Cl_i"]) / (psi * par["z_Cl"])

    i_pump = (
        par["I_max"]
        * (K_e / (K_e + par["m_K"]))
        * (Na_i**1.5 / (Na_i**1.5 + par["m_Na"] ** 1.5))
    )

    # Kir rectification, mV constants
    K_e_init = par["K_e_init"]
    E_K_init = torch.log(K_e_init / par["K_i_init"]) / psi
    dphi = V - E_K
    A = 1.0 + math.exp(18.5 / 42.4)
    B = 1.0 + torch.exp(-(118.6 + E_K_init) / 44.1)
    C = 1.0 + torch.exp((dphi + 18.5) / 42.4)
    D = 1.0 + torch.exp(-(118.6 + V) / 44.1)
    g_Kir = torch.sqrt(K_e / K_e_init) * (A * B) / (C * D)

    i_Kir = par["g_leak_K"] * g_Kir * (V - E_K)
    i_Na = par["g_leak_Na"] * (V - E_Na) + 3.0 * i_pump
    i_K = i_Kir - 2.0 * i_pump
    i_Cl = par["g_leak_Cl"] * (V - E_Cl)
    return i_Na, i_K, i_Cl


def rhs(t, y, p):
    i_Na, i_K, i_Cl = _ionic_currents(t, y, p)
    dV = -(i_K + i_Na + i_Cl) / p[:, _P["Cm"]]
    return torch.stack([dV], dim=1)


def currents(t, y, p):
    return _ionic_currents(t, y, p)


MODEL = register_model(
    ODEModel(
        name="glial",
        state_names=STATE_NAMES,
        param_names=PARAM_NAMES,
        default_states=DEFAULT_STATES,
        default_params=DEFAULT_PARAMS,
        rhs=rhs,
        currents=currents,
        current_names=("Na", "K", "Cl"),
    )
)
