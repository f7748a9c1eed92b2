"""Restorable simulation checkpoints, in the JAX package's npz layout.

The complete :class:`~knpemi_tpu_torch.systems.types.SimState` —
concentrations, potentials, membrane potential, ODE states and
parameters, time, step counter and the last solve's diagnostics — goes
into one compressed ``.npz``: ``<field>__<tag>`` for the per-tag fields,
``scalar__<field>`` for the others, ``meta__<key>`` for the caller's
metadata.  It is the layout of ``knpemi_tpu/io/checkpoint.py``, so a
checkpoint written by either package loads in the other, and
``Simulation.run`` continues from a loaded state with the same bits as
from the state it was saved from.
"""

from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace
from typing import Tuple

import numpy as np
import torch

from ..interop import state_from_numpy
from ..systems.types import SimState, resolve_device

_DICT_FIELDS = ("c", "phi", "phi_M", "ode_states", "ode_params")
_SCALAR_FIELDS = (
    "t", "step", "emi_iters", "knp_iters",
    "emi_ok", "knp_ok", "emi_res", "knp_res",
)


def _host(v):
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def save_checkpoint(path, state: SimState, **metadata):
    """Write ``state`` (on the card or a host copy) and ``metadata`` to
    ``path`` (numpy adds ``.npz`` where the name lacks it)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {}
    for f in _DICT_FIELDS:
        for tag, arr in getattr(state, f).items():
            payload[f"{f}__{tag}"] = _host(arr)
    for f in _SCALAR_FIELDS:
        payload[f"scalar__{f}"] = _host(getattr(state, f))
    for k, v in metadata.items():
        payload[f"meta__{k}"] = np.asarray(v)
    np.savez_compressed(path, **payload)


def load_checkpoint(path, device=None, dtype=None) -> Tuple[SimState, dict]:
    """``(state, metadata)`` of a checkpoint, the state on ``device``
    (None: CUDA, raising without it) in ``dtype`` (None: the file's
    floating type), through ``interop.state_from_numpy``; the metadata
    as numpy arrays."""
    device = resolve_device(device)
    fields = {f: {} for f in _DICT_FIELDS}
    scalars, meta = {}, {}
    with np.load(path) as data:
        for key in data.files:
            kind, _, rest = key.partition("__")
            if kind in _DICT_FIELDS:
                fields[kind][int(rest)] = data[key]
            elif kind == "scalar":
                scalars[rest] = data[key]
            elif kind == "meta":
                meta[rest] = data[key]
    if dtype is None:
        kind = next(a.dtype for a in fields["c"].values())
        dtype = torch.float32 if kind == np.float32 else torch.float64
    state = state_from_numpy(SimpleNamespace(**fields, **scalars), device, dtype)
    return state, meta
