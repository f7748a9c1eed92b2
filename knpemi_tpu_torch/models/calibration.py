"""The calibration model: a closed ECS + neuron + glial compartment system.

Counterpart of ``knpemi_tpu/models/calibration.py``: a 14-state ODE (HH
gates m, h, n, the membrane potentials V_n and V_g, and nine compartment
concentrations) in which the channel and pump currents of both
membranes feed back into the concentrations through the compartments'
volume and surface factors.  Units mV / ms / cm / mM.  Evaluated for
every point at once: y (n, 14), p (n, 13).

``drivers/run_calibration.py`` steps it to the dynamic steady state whose
values the PDE scenarios take as initial conditions
(``sim/scenarios.py``'s astrocyte constants).
"""

from __future__ import annotations

import numpy as np
import torch

from .rates import exprel_inv
from .registry import ODEModel, register_model

STATE_NAMES = (
    "m", "h", "n", "V_n", "V_g",
    "K_e", "K_n", "K_g",
    "Na_e", "Na_n", "Na_g",
    "Cl_e", "Cl_n", "Cl_g",
)
PARAM_NAMES = (
    "g_Na_bar", "g_K_bar",
    "g_leak_Na_n", "g_leak_K_n",
    "g_leak_Na_g", "g_leak_K_g",
    "Cm", "stim_amplitude",
    "m_K", "m_Na", "I_max_n", "I_max_g", "g_leak_Cl_g",
)

DEFAULT_STATES = np.array(
    [
        0.01365600905697864,  # m
        0.8804834256821714,  # h
        0.17041625484928405,  # n
        -75.93151471235473,  # V_n (mV)
        -85.85765274084892,  # V_g
        3.092970607490389,  # K_e
        124.13988964240784,  # K_n
        99.3100014897692,  # K_g
        144.60625137617149,  # Na_e
        12.850454639128186,  # Na_n
        15.775818906083778,  # Na_g
        133.62525154406637,  # Cl_e
        5.0,  # Cl_n
        5.203660274163705,  # Cl_g
    ]
)
DEFAULT_PARAMS = np.array(
    [120.0, 36.0, 0.1, 0.4, 0.1, 1.696, 1.0, 0.0, 1.5, 10.0, 58.0,
     10.75975, 0.05]
)

_S = {n: i for i, n in enumerate(STATE_NAMES)}
_P = {n: i for i, n in enumerate(PARAM_NAMES)}

# physical constants and compartment geometry
RTF = 8.315e3 * 307e3 / 96500e3  # R T / F in mV
F = 96500e3
ICS_VOL = 3.42e-11 / 2.0  # cm^3
ECS_VOL = 7.08e-11
SURFACE = 2.29e-6  # cm^2
K_E_INIT = 3.092970607490389
K_G_INIT = 99.3100014897692


def _currents_all(t, y, p):
    s = {name: y[:, i] for name, i in _S.items()}
    par = {name: p[:, i] for name, i in _P.items()}
    Vg = s["V_g"]
    K_e, Na_e, Cl_e = s["K_e"], s["Na_e"], s["Cl_e"]

    E_Na_n = RTF * torch.log(Na_e / s["Na_n"])
    E_K_n = RTF * torch.log(K_e / s["K_n"])
    E_Na_g = RTF * torch.log(Na_e / s["Na_g"])
    E_K_g = RTF * torch.log(K_e / s["K_g"])
    E_Cl_g = -RTF * torch.log(Cl_e / s["Cl_g"])
    E_K_init = RTF * np.log(K_E_INIT / K_G_INIT)

    i_stim = par["stim_amplitude"] * torch.exp(-torch.remainder(t, 20.0) / 2.0)
    i_pump_n = par["I_max_n"] / (
        (1 + par["m_K"] / K_e) ** 2 * (1 + par["m_Na"] / s["Na_n"]) ** 3
    )
    Na_g15 = s["Na_g"] ** 1.5
    i_pump_g = (
        par["I_max_g"]
        * (K_e / (K_e + par["m_K"]))
        * (Na_g15 / (Na_g15 + par["m_Na"] ** 1.5))
    )

    dphi = Vg - E_K_g
    A = 1 + np.exp(18.4 / 42.4)
    B = 1 + np.exp(-(118.6 + E_K_init) / 44.1)
    C = 1 + torch.exp((dphi + 18.5) / 42.5)
    D = 1 + torch.exp(-(118.6 + Vg) / 44.1)
    g_Kir = torch.sqrt(K_e / K_E_INIT) * (A * B) / (C * D)
    i_Kir = par["g_leak_K_g"] * g_Kir * (Vg - E_K_g)

    m, h, n, Vn = s["m"], s["h"], s["n"], s["V_n"]
    i_Na_n = (
        par["g_leak_Na_n"] + par["g_Na_bar"] * h * m**3 + i_stim
    ) * (Vn - E_Na_n) + 3 * i_pump_n
    i_K_n = (par["g_leak_K_n"] + par["g_K_bar"] * n**4) * (Vn - E_K_n) - 2 * i_pump_n
    i_Na_g = par["g_leak_Na_g"] * (Vg - E_Na_g) + 3 * i_pump_g
    i_K_g = i_Kir - 2 * i_pump_g
    i_Cl_g = par["g_leak_Cl_g"] * (Vg - E_Cl_g)
    i_Cl_n = torch.zeros_like(i_Na_n)
    return i_Na_n, i_K_n, i_Cl_n, i_Na_g, i_K_g, i_Cl_g


def rhs(t, y, p):
    m, h, n, Vn = y[:, _S["m"]], y[:, _S["h"]], y[:, _S["n"]], y[:, _S["V_n"]]
    # the stable x / (1 - exp(-x/10)) form (models/rates.py)
    alpha_m = 0.1 * 10.0 * exprel_inv(-(Vn + 40.0) / 10.0)
    beta_m = 4.0 * torch.exp(-(Vn + 65.0) / 18.0)
    alpha_h = 0.07 * torch.exp(-(Vn + 65.0) / 20.0)
    beta_h = 1.0 / (1.0 + torch.exp(-(Vn + 35.0) / 10.0))
    alpha_n = 0.01 * 10.0 * exprel_inv(-(Vn + 55.0) / 10.0)
    beta_n = 0.125 * torch.exp(-(Vn + 65.0) / 80.0)

    i_Na_n, i_K_n, i_Cl_n, i_Na_g, i_K_g, i_Cl_g = _currents_all(t, y, p)
    Cm = p[:, _P["Cm"]]
    se = SURFACE / (F * ECS_VOL)
    si = SURFACE / (F * ICS_VOL)
    return torch.stack(
        [
            (1 - m) * alpha_m - m * beta_m,
            (1 - h) * alpha_h - h * beta_h,
            (1 - n) * alpha_n - n * beta_n,
            -(i_K_n + i_Na_n + i_Cl_n) / Cm,
            -(i_K_g + i_Na_g + i_Cl_g) / Cm,
            (i_K_n + i_K_g) * se,  # K_e
            -i_K_n * si,  # K_n
            -i_K_g * si,  # K_g
            (i_Na_n + i_Na_g) * se,  # Na_e
            -i_Na_n * si,  # Na_n
            -i_Na_g * si,  # Na_g
            -(i_Cl_n + i_Cl_g) * se,  # Cl_e
            i_Cl_n * si,  # Cl_n
            i_Cl_g * si,  # Cl_g
        ],
        dim=1,
    )


def currents(t, y, p):
    i_Na_n, i_K_n, i_Cl_n, *_ = _currents_all(t, y, p)
    return i_Na_n, i_K_n, i_Cl_n


MODEL = register_model(
    ODEModel(
        name="calibration",
        state_names=STATE_NAMES,
        param_names=PARAM_NAMES,
        default_states=DEFAULT_STATES,
        default_params=DEFAULT_PARAMS,
        rhs=rhs,
        currents=currents,
        current_names=("Na", "K", "Cl"),
    )
)
