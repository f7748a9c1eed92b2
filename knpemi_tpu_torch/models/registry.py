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

    def init_states(self, **overrides) -> np.ndarray:
        y = self.default_states.copy()
        for k, v in overrides.items():
            y[list(self.state_names).index(k)] = v
        return y

    def init_params(self, **overrides) -> np.ndarray:
        p = self.default_params.copy()
        for k, v in overrides.items():
            p[list(self.param_names).index(k)] = v
        return p

    def state_indices(self, *names):
        """Index of one state name, or the list of indices of several."""
        idx = [list(self.state_names).index(n) for n in names]
        return idx if len(idx) > 1 else idx[0]

    def parameter_indices(self, *names):
        idx = [list(self.param_names).index(n) for n in names]
        return idx if len(idx) > 1 else idx[0]


_REGISTRY: Dict[str, ODEModel] = {}


def register_model(model: ODEModel) -> ODEModel:
    _REGISTRY[model.name] = model
    return model


def get_model(name: str) -> ODEModel:
    from . import calibration, glial, hh, test_ode  # noqa: F401  (populate the registry)

    return _REGISTRY[name]


def available_models():
    from . import calibration, glial, hh, test_ode  # noqa: F401

    return sorted(_REGISTRY)
