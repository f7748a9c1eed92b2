"""Channel-model registry and the ODEModel container.

Counterpart of ``knpemi_tpu/models/registry.py``: a declarative
dataclass around pure tensor functions.  ``rhs`` and ``currents`` act on
all membrane dofs at once: y is (n, S), p is (n, P).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence

import numpy as np


@dataclasses.dataclass
class ODEModel:
    name: str
    state_names: Sequence[str]
    param_names: Sequence[str]
    default_states: np.ndarray
    default_params: np.ndarray
    rhs: Callable  # (t, y (n, S), p (n, P)) -> dy (n, S)
    currents: Callable  # (t, y, p) -> tuple of per-ion currents (n,)
    current_names: Sequence[str]  # ion names, e.g. ("Na", "K", "Cl")

    def init_states(self) -> np.ndarray:
        return self.default_states.copy()

    def init_params(self) -> np.ndarray:
        return self.default_params.copy()


_REGISTRY: Dict[str, ODEModel] = {}


def register_model(model: ODEModel) -> ODEModel:
    _REGISTRY[model.name] = model
    return model


def get_model(name: str) -> ODEModel:
    from . import hh  # noqa: F401  (populates the registry)

    return _REGISTRY[name]
