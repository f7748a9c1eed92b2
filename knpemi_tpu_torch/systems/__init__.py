"""The PDE systems of the port: data model, EMI and KNP systems, coupling."""

from .types import Ion, PhysicalParams, SubdomainDef, SimState
from .emi import emi_system, create_functions_emi, EMISystem
from .knp import knp_system, create_functions_knp, KNPSystem
from .coupling import (
    set_initial_conditions,
    interpolate_to_membrane,
    update_pde_variables,
    eliminated_concentration,
    membrane_potential_from_phi,
)

__all__ = [
    "Ion",
    "PhysicalParams",
    "SubdomainDef",
    "SimState",
    "emi_system",
    "knp_system",
    "EMISystem",
    "KNPSystem",
    "create_functions_emi",
    "create_functions_knp",
    "set_initial_conditions",
    "interpolate_to_membrane",
    "update_pde_variables",
    "eliminated_concentration",
    "membrane_potential_from_phi",
]
