"""Krylov solvers, multigrid and the EMI / KNP solver factories."""

from .cg import cg
from .gmres import gmres
from .api import create_solver_emi, create_solver_knp

__all__ = ["cg", "gmres", "create_solver_emi", "create_solver_knp"]
