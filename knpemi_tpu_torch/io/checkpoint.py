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

``save_checkpoint_dcp`` / ``load_checkpoint_dcp`` write and read the same
keys as a ``torch.distributed.checkpoint`` directory, the counterpart of
the JAX package's orbax pair: without a process group one process writes
it; in an initialised one every rank takes part in the save, as
``torch.distributed.checkpoint.save`` does.
"""

from __future__ import annotations

import warnings
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


def _split(items, device, dtype):
    """(state, metadata) from (key, numpy array) pairs of the layout above."""
    device = resolve_device(device)
    fields = {f: {} for f in _DICT_FIELDS}
    scalars, meta = {}, {}
    for key, value in items:
        kind, _, rest = key.partition("__")
        if kind in _DICT_FIELDS:
            fields[kind][int(rest)] = value
        elif kind == "scalar":
            scalars[rest] = value
        elif kind == "meta":
            meta[rest] = value
    if dtype is None:
        kind = next(a.dtype for a in fields["c"].values())
        dtype = torch.float32 if kind == np.float32 else torch.float64
    state = state_from_numpy(SimpleNamespace(**fields, **scalars), device, dtype)
    return state, meta


def _dcp_call(fn, payload, path):
    """``fn`` (DCP's save or load) of ``payload`` at ``path``: in one
    process where no process group is initialised, without DCP's warning
    that it assumes so."""
    import torch.distributed as dist

    no_dist = not (dist.is_available() and dist.is_initialized())
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is disabled")
        fn(payload, checkpoint_id=str(path), no_dist=no_dist)


def save_checkpoint_dcp(path, state: SimState, **metadata):
    """Write ``state`` and ``metadata`` to the directory ``path`` through
    ``torch.distributed.checkpoint`` (host copies, the keys of
    :func:`save_checkpoint`; a metadata value numpy cannot hold as a
    number array is stored as an object)."""
    import torch.distributed.checkpoint as dcp

    payload = {}
    for f in _DICT_FIELDS:
        for tag, arr in getattr(state, f).items():
            payload[f"{f}__{tag}"] = torch.from_numpy(np.array(_host(arr)))
    for f in _SCALAR_FIELDS:
        payload[f"scalar__{f}"] = torch.from_numpy(np.array(_host(getattr(state, f))))
    for k, v in metadata.items():
        a = np.asarray(v)
        payload[f"meta__{k}"] = torch.from_numpy(a.copy()) if a.dtype.kind in "biuf" else v
    Path(path).mkdir(parents=True, exist_ok=True)
    _dcp_call(dcp.save, payload, path)


def load_checkpoint_dcp(path, device=None, dtype=None) -> Tuple[SimState, dict]:
    """``(state, metadata)`` of a :func:`save_checkpoint_dcp` directory, as
    :func:`load_checkpoint` gives them (number metadata as numpy arrays)."""
    import torch.distributed.checkpoint as dcp

    md = dcp.FileSystemReader(str(path)).read_metadata().state_dict_metadata
    payload = {k: torch.empty(v.size, dtype=v.properties.dtype)
               if isinstance(v, dcp.TensorStorageMetadata) else None for k, v in md.items()}
    _dcp_call(dcp.load, payload, path)
    return _split(((k, v.numpy() if torch.is_tensor(v) else v) for k, v in payload.items()),
                  device, dtype)


def load_checkpoint(path, device=None, dtype=None) -> Tuple[SimState, dict]:
    """``(state, metadata)`` of a checkpoint, the state on ``device``
    (None: CUDA, raising without it) in ``dtype`` (None: the file's
    floating type), through ``interop.state_from_numpy``; the metadata
    as numpy arrays."""
    with np.load(path) as data:
        items = [(key, data[key]) for key in data.files]
    return _split(items, device, dtype)
