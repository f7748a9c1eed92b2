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

from .systems.types import Ion, PhysicalParams, SimState  # noqa: E402
from .mesh.core import Mesh  # noqa: E402
from .ops.geometry import build_geometry, DiscreteGeometry  # noqa: E402
from .systems.coupling import set_initial_conditions, update_pde_variables  # noqa: E402
from .models.engine import (  # noqa: E402
    MembraneModel, setup_membrane_model, update_ode_variables,
)
from .sim import (  # noqa: E402
    ASTROCYTE_BASELINE, Simulation, SolverOptions, build_astrocyte, build_idealized,
)

__all__ = [
    "Ion",
    "PhysicalParams",
    "SimState",
    "Mesh",
    "DiscreteGeometry",
    "build_geometry",
    "set_initial_conditions",
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
