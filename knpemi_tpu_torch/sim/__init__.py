from .stepper import Simulation, SolverOptions
from .scenarios import build_idealized, dofs_per_step

__all__ = ["Simulation", "SolverOptions", "build_idealized", "dofs_per_step"]
