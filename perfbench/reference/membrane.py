"""The membrane models, written out plainly: Hodgkin-Huxley in SI units
(``hh``: V in volts, t in seconds) and in mV / ms (``hh_mv``), and the
glial Kir model (``glial``, mV / ms), each with a Na/K pump and leaks and
Nernst potentials from the concentration traces; and the fixed-substep
RK4 that advances them.

A model is a dict: ``states`` (names and resting values), ``params``
(names and default values; the traces, Cm, psi and the valences are set
from the PDE side), ``rhs(t, y, p)`` and ``currents(t, y, p)`` -> (Na,
K, Cl), on (n, S) and (n, P) tensors.
"""

from __future__ import annotations

import math

import torch

HH_PARAMS = ("g_Na_bar", "g_K_bar", "g_leak_Na", "g_leak_K", "m_K", "m_Na", "I_max",
             "Cm", "stim_amplitude", "K_e", "K_i", "Na_e", "Na_i", "Cl_e", "Cl_i",
             "z_Na", "z_K", "z_Cl", "psi")
HH_DEFAULTS = [1200.0, 360.0, 1.0, 4.0, 2.0, 7.7, 0.449, 0.0, 0.0,
               0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 1.0, -1.0, 0.0]
HH_MV_DEFAULTS = [120.0, 36.0, 0.1, 0.4, 1.5, 10.0, 58.0, 0.0, 0.0,
                  0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 1.0, -1.0, 0.0]
GLIAL_PARAMS = ("g_leak_Cl", "g_leak_Na", "g_leak_K", "Cm", "stim_amplitude", "m_K",
                "m_Na", "I_max", "K_e_init", "K_i_init", "K_e", "K_i", "Na_e", "Na_i",
                "Cl_e", "Cl_i", "z_Na", "z_K", "z_Cl", "psi")
GLIAL_DEFAULTS = [0.05, 0.1, 1.696, 0.0, 0.0, 1.5, 10.0, 10.75975,
                  3.092970607490389, 99.3100014897692,
                  0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 1.0, -1.0, 0.0]


def _xexp(z):
    """z / (exp(z) - 1), with its limit 1 at z = 0."""
    small = torch.abs(z) < 1e-4
    zs = torch.where(small, torch.ones_like(z), z)
    return torch.where(small, 1.0 - z / 2.0 + z * z / 12.0, zs / torch.expm1(zs))


def _named(p, names):
    return {n: p[:, i] for i, n in enumerate(names)}


def _hh_currents(t, y, p, mv: bool):
    m, h, n, V = y.unbind(1)
    q = _named(p, HH_PARAMS)
    E_Na = torch.log(q["Na_e"] / q["Na_i"]) / (q["psi"] * q["z_Na"])
    E_K = torch.log(q["K_e"] / q["K_i"]) / (q["psi"] * q["z_K"])
    # synaptic conductance: exp(-mod(t, 30 ms) / 2 ms) before 125 ms
    ms = 1.0 if mv else 1e-3
    g_syn = q["stim_amplitude"] * torch.exp(-torch.remainder(t, 30 * ms) / (2 * ms)) \
        * (t < 125 * ms)
    pump = q["I_max"] / ((1 + q["m_K"] / q["K_e"]) ** 2 * (1 + q["m_Na"] / q["Na_i"]) ** 3)
    i_Na = (q["g_leak_Na"] + q["g_Na_bar"] * h * m ** 3 + g_syn) * (V - E_Na) + 3 * pump
    i_K = (q["g_leak_K"] + q["g_K_bar"] * n ** 4) * (V - E_K) - 2 * pump
    return i_Na, i_K, torch.zeros_like(i_Na)


def _hh_rates(V, mv: bool):
    """(alpha, beta) of m, h, n; classic per-ms rates at V in mV."""
    u = V if mv else 1e3 * V
    s = 1.0 if mv else 1e3
    return ((s * _xexp(-(u + 40) / 10), s * 4 * torch.exp(-(u + 65) / 18)),
            (s * 0.07 * torch.exp(-(u + 65) / 20), s / (1 + torch.exp(-(u + 35) / 10))),
            (s * 0.1 * _xexp(-(u + 55) / 10), s * 0.125 * torch.exp(-(u + 65) / 80)))


def _hh_rhs(mv: bool):
    def rhs(t, y, p):
        m, h, n, V = y.unbind(1)
        (am, bm), (ah, bh), (an, bn) = _hh_rates(V, mv)
        i_Na, i_K, i_Cl = _hh_currents(t, y, p, mv)
        return torch.stack([(1 - m) * am - m * bm, (1 - h) * ah - h * bh,
                            (1 - n) * an - n * bn,
                            -(i_K + i_Na + i_Cl) / p[:, HH_PARAMS.index("Cm")]], dim=1)
    return rhs


def _glial_currents(t, y, p):
    V = y[:, 0]
    q = _named(p, GLIAL_PARAMS)
    psi, K_e, Na_i = q["psi"], q["K_e"], q["Na_i"]
    # E_Na with z_K: both valences are +1
    E_Na = torch.log(q["Na_e"] / Na_i) / (psi * q["z_K"])
    E_K = torch.log(K_e / q["K_i"]) / (psi * q["z_K"])
    E_Cl = torch.log(q["Cl_e"] / q["Cl_i"]) / (psi * q["z_Cl"])
    pump = q["I_max"] * (K_e / (K_e + q["m_K"])) * (Na_i ** 1.5 / (Na_i ** 1.5 + q["m_Na"] ** 1.5))
    E_K0 = torch.log(q["K_e_init"] / q["K_i_init"]) / psi
    g_kir = torch.sqrt(K_e / q["K_e_init"]) \
        * ((1 + math.exp(18.5 / 42.4)) * (1 + torch.exp(-(118.6 + E_K0) / 44.1))) \
        / ((1 + torch.exp((V - E_K + 18.5) / 42.4)) * (1 + torch.exp(-(118.6 + V) / 44.1)))
    i_K = q["g_leak_K"] * g_kir * (V - E_K) - 2 * pump
    i_Na = q["g_leak_Na"] * (V - E_Na) + 3 * pump
    return i_Na, i_K, q["g_leak_Cl"] * (V - E_Cl)


def _glial_rhs(t, y, p):
    i_Na, i_K, i_Cl = _glial_currents(t, y, p)
    return (-(i_K + i_Na + i_Cl) / p[:, GLIAL_PARAMS.index("Cm")])[:, None]


MODELS = {
    "hh": dict(states=("m", "h", "n", "V"), params=HH_PARAMS, defaults=HH_DEFAULTS,
               rhs=_hh_rhs(False), currents=lambda t, y, p: _hh_currents(t, y, p, False)),
    "hh_mv": dict(states=("m", "h", "n", "V"), params=HH_PARAMS, defaults=HH_MV_DEFAULTS,
                  rhs=_hh_rhs(True), currents=lambda t, y, p: _hh_currents(t, y, p, True)),
    "glial": dict(states=("V",), params=GLIAL_PARAMS, defaults=GLIAL_DEFAULTS,
                  rhs=_glial_rhs, currents=_glial_currents),
}


def advance(model: dict, y, p, t0, dt: float, n_sub: int):
    """``n_sub`` classic RK4 substeps of dt / n_sub from time t0 (the
    substep clock in y's dtype)."""
    h = torch.tensor(dt / n_sub, dtype=y.dtype, device=y.device)
    t = torch.as_tensor(t0, device=y.device).to(y.dtype)
    f = model["rhs"]
    for _ in range(n_sub):
        k1 = f(t, y, p)
        k2 = f(t + h / 2, y + h / 2 * k1, p)
        k3 = f(t + h / 2, y + h / 2 * k2, p)
        k4 = f(t + h, y + h * k3, p)
        y = y + h / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
        t = t + h
    return y
