"""Carry a simulation state between the JAX package and this port.

``state_from_numpy`` takes a JAX ``SimState`` after ``jax.device_get``
(any object with the same fields holding numpy arrays or scalars) and
returns the port's :class:`~knpemi_tpu_torch.systems.types.SimState`;
``state_to_numpy`` goes back to plain numpy.  Neither imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .systems.types import SimState

_FIELD_DICTS = ("c", "phi", "phi_M", "ode_states", "ode_params")


def state_from_numpy(tree, device, dtype) -> SimState:
    conv = lambda a, d: torch.tensor(np.asarray(a), dtype=d, device=device)
    fields = {f: {k: conv(v, dtype) for k, v in getattr(tree, f).items()}
              for f in _FIELD_DICTS}
    return SimState(
        **fields,
        t=conv(tree.t, torch.float64),
        step=conv(tree.step, torch.int32),
        emi_iters=conv(tree.emi_iters, torch.int32),
        knp_iters=conv(tree.knp_iters, torch.int32),
        emi_ok=conv(tree.emi_ok, torch.bool),
        knp_ok=conv(tree.knp_ok, torch.bool),
        emi_res=conv(tree.emi_res, dtype),
        knp_res=conv(tree.knp_res, dtype),
    )


def state_to_numpy(state: SimState) -> dict:
    """{field: numpy array, or {tag: numpy array} for the per-tag fields}."""
    out = {}
    for f in SimState.__dataclass_fields__:
        v = getattr(state, f)
        if isinstance(v, dict):
            out[f] = {k: t.detach().cpu().numpy() for k, t in v.items()}
        else:
            out[f] = v.detach().cpu().numpy()
    return out
