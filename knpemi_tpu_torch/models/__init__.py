from .engine import (
    MembraneModel,
    setup_membrane_model,
    update_ode_variables,
    rk4_step,
)
from .registry import available_models, get_model, register_model

__all__ = [
    "MembraneModel",
    "setup_membrane_model",
    "update_ode_variables",
    "rk4_step",
    "get_model",
    "register_model",
    "available_models",
]
