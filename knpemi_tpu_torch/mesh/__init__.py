from .core import Mesh, facet_vertices_of_cells
from .generators import (
    unit_square_mms_mesh,
    rectangle_2d_mesh,
    box_3d_mesh,
    idealized_2d_mesh,
    idealized_3d_mesh,
)

__all__ = [
    "Mesh",
    "facet_vertices_of_cells",
    "unit_square_mms_mesh",
    "rectangle_2d_mesh",
    "box_3d_mesh",
    "idealized_2d_mesh",
    "idealized_3d_mesh",
]
