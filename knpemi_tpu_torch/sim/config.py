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


def pulsed_source_gate(config):
    """t -> {0, 1} gate of the pulsed ECS source, on tensors: on iff
    delay <= t <= end_time and (t - delay) mod period < pulse_width.  ``t``
    is the state's 0-d time tensor (or any tensor of times); the result
    stays on its device, so the step reads nothing back to the host."""
    delay = float(config["delay"])
    period = float(config["period"])
    width = float(config["pulse_width"])
    end = float(config["end_time"])

    def gate(t: torch.Tensor) -> torch.Tensor:
        on = (t >= delay) & (t <= end) & (torch.remainder(t - delay, period) < width)
        return torch.where(on, torch.ones_like(t), torch.zeros_like(t))

    return gate
