from .core import Mesh, facet_vertices_of_cells, quad_facet_tags_to_tris, split_hex_cells
from .generators import (
    unit_square_mms_mesh,
    unit_cube_mms_mesh,
    rectangle_2d_mesh,
    box_3d_mesh,
    idealized_2d_mesh,
    idealized_3d_mesh,
)
from .tissue import (
    astrocyte_tissue_mesh,
    two_cell_tissue_mesh,
    remark_emimesh,
    split_membrane_x_slabs,
    find_roi_points,
)

__all__ = [
    "Mesh",
    "facet_vertices_of_cells",
    "split_hex_cells",
    "quad_facet_tags_to_tris",
    "unit_square_mms_mesh",
    "unit_cube_mms_mesh",
    "rectangle_2d_mesh",
    "box_3d_mesh",
    "idealized_2d_mesh",
    "idealized_3d_mesh",
    "astrocyte_tissue_mesh",
    "two_cell_tissue_mesh",
    "remark_emimesh",
    "split_membrane_x_slabs",
    "find_roi_points",
]
