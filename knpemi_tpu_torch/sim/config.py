"""Scenario configuration: defaults, YAML loading, the pulsed ECS source.

Counterpart of ``knpemi_tpu/sim/config.py``.  Keys (those of the
astrocyte scenario's ``config_files/*.yml``):

  mesh_file: path to an XDMF mesh (not read by this package yet)
  resolution / mesh_n: size of the synthetic tissue mesh
  fname: output directory name
  Tstop, dt: simulation window
  f_value, period, delay, pulse_width, end_time: pulsed ECS source
  x_L..z_U: source box
  lambda_e, lambda_i: tortuosities
  save_frequency: steps between outputs
  solver: fields of ``SolverOptions``
  dtype: float32|float64
  g_syn_bar: membrane ODE synaptic stimulus
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import quadrature
from ..ops.geometry import DiscreteGeometry

DEFAULTS = dict(
    dt=0.1,
    Tstop=10.0,
    f_value=0.0,
    period=10.0,
    delay=1.0,
    pulse_width=1.0,
    end_time=100.0,
    lambda_e=1.6,
    lambda_i=3.4,
    save_frequency=5,
    g_syn_bar=0.0,
    dtype=None,
    solver=dict(),
)


def load_config(path) -> dict:
    """``DEFAULTS`` overlaid with the YAML file at ``path``."""
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f)
    out = dict(DEFAULTS)
    out.update(cfg or {})
    return out


def source_box_indicator_q(geom: DiscreteGeometry, tag: int, lo, hi,
                           value: float = 1.0) -> np.ndarray:
    """Indicator of the open box (lo, hi) at the cell quadrature points of
    subdomain ``tag``, times ``value``: (n_cells, n_q)."""
    sub = geom.subdomains[tag]
    bary, _ = quadrature.cell_rule(geom.dim)
    Xq = np.einsum("qk,ckd->cqd", bary, sub.coords[sub.cells])
    inside = ((Xq > np.asarray(lo)) & (Xq < np.asarray(hi))).all(axis=-1)
    return value * inside.astype(np.float64)


class PulsedGate:
    """t -> {0, 1} gate of the pulsed ECS source, on tensors: on iff
    delay <= t <= end_time and (t - delay) mod period < pulse_width.  ``t``
    is the state's 0-d time tensor (or any tensor of times); the result
    stays on its device, so the step reads nothing back to the host.  A
    class, not a closure, so that a simulation's set-up pickles (the
    multi-device modes send it to their ranks)."""

    def __init__(self, delay: float, period: float, width: float, end: float):
        self.delay, self.period, self.width, self.end = delay, period, width, end

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        on = ((t >= self.delay) & (t <= self.end)
              & (torch.remainder(t - self.delay, self.period) < self.width))
        return torch.where(on, torch.ones_like(t), torch.zeros_like(t))


def pulsed_source_gate(config) -> PulsedGate:
    """The :class:`PulsedGate` of ``config``'s delay, period, pulse_width
    and end_time."""
    return PulsedGate(float(config["delay"]), float(config["period"]),
                      float(config["pulse_width"]), float(config["end_time"]))
