from .stepper import Simulation, SolverOptions
from .scenarios import (
    ASTROCYTE_BASELINE, build_astrocyte, build_idealized, build_two_cell, dofs_per_step,
)

__all__ = ["Simulation", "SolverOptions", "build_idealized", "build_astrocyte",
           "build_two_cell", "ASTROCYTE_BASELINE", "dofs_per_step"]
