"""knpemi_tpu_torch — the PyTorch/CUDA port of knpemi_tpu for one NVIDIA H100.

The JAX package ``knpemi_tpu`` stays the reference; this package mirrors
its layout (``mesh/``, ``ops/``, ``systems/``, ``solvers/``, ``models/``,
``sim/``) and imports neither JAX nor ``knpemi_tpu``.  The host-side
setup (mesh, geometry, multigrid build) is a copy of the JAX package's
numpy code and yields the same arrays; the device side is PyTorch, with
the JAX package's Pallas kernels replaced by hand-written CUDA kernels
for Hopper (``ops/assembly.py``, ``ops/csrc``).

Entry points run on CUDA unless the caller passes ``device="cpu"``;
without CUDA and without that request they raise.
"""

__version__ = "0.1.0"

from .systems import (  # noqa: E402
    Ion, PhysicalParams, SimState, SubdomainDef, create_functions_emi,
    create_functions_knp, emi_system, interpolate_to_membrane, knp_system,
    set_initial_conditions, update_pde_variables,
)
from .mesh.core import Mesh  # noqa: E402
from .ops.geometry import build_geometry, DiscreteGeometry  # noqa: E402
from .solvers import create_solver_emi, create_solver_knp  # noqa: E402
from .models.engine import (  # noqa: E402
    MembraneModel, setup_membrane_model, update_ode_variables,
)
from .sim import (  # noqa: E402
    ASTROCYTE_BASELINE, Simulation, SolverOptions, build_astrocyte, build_idealized,
)

__all__ = [
    "Ion",
    "PhysicalParams",
    "SubdomainDef",
    "SimState",
    "Mesh",
    "DiscreteGeometry",
    "build_geometry",
    "emi_system",
    "knp_system",
    "create_functions_emi",
    "create_functions_knp",
    "create_solver_emi",
    "create_solver_knp",
    "set_initial_conditions",
    "interpolate_to_membrane",
    "update_pde_variables",
    "MembraneModel",
    "setup_membrane_model",
    "update_ode_variables",
    "Simulation",
    "SolverOptions",
    "build_idealized",
    "build_astrocyte",
    "ASTROCYTE_BASELINE",
]
