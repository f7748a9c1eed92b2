"""Synthetic tissue meshes and emimesh re-tagging.

Counterpart of ``knpemi_tpu/mesh/tissue.py`` (numpy only, the same
arrays).  The astrocyte and benchmark examples of the reference run on
emimesh tissue reconstructions that are not part of the repository;
this module provides

* :func:`two_cell_tissue_mesh` — ECS + one glial cell whose membrane is
  split into x-slabs tagged 5/6/7,
* :func:`astrocyte_tissue_mesh` — ECS(0) + neuron(1) + glial(2) with
  membrane tags 1/2, the structure of the astrocyte flagship,
* :func:`remark_emimesh` — the tag-convention converter for emimesh
  output (ECS 1 -> 0, membrane x-slab split, exterior boundary 5,
  nm -> cm coordinate scaling),
* :func:`find_roi_points` — probe points inside a box.

All synthetic meshes are in the astrocyte example's cm units
(1 um = 1e-4 cm).
"""

from __future__ import annotations

import numpy as np

from .core import Mesh, EXTERIOR_BOUNDARY_TAG
from .generators import _structured_tets, _tag_cells_in_boxes

UM = 1e-4  # 1 micrometer in cm


def _build(nx, ny, nz, p0, p1, boxes):
    points, cells = _structured_tets(nx, ny, nz, p0, p1)
    tags = _tag_cells_in_boxes(points, cells, boxes)
    return Mesh(points=points, cells=cells, cell_tags=tags)


def split_membrane_x_slabs(mesh: Mesh, cell_tag: int, cuts, tags):
    """Tag the interface facets of `cell_tag` by x-slab: facets with
    midpoint x < cuts[0] get tags[0], ... (remark_mesh.py:144-150)."""
    m = mesh.interface_facet_mask(0, cell_tag)
    fids = np.flatnonzero(m)
    mids = mesh.facet_midpoints(fids)
    slab = np.digitize(mids[:, 0], np.asarray(cuts))
    mesh.facet_tags[fids] = np.asarray(tags)[slab]
    return mesh


def two_cell_tissue_mesh(resolution: int = 0, L: float = 5.0) -> Mesh:
    """ECS box (L um)^3 with one embedded glial cell (tag 1) whose membrane
    carries tags 5/6/7 split at x = 2 um and x = 3 um.  The cell sits at
    y,z in [1, 2] um so the reference examples' ECS source box
    (x,y in [2.1, 2.9], z in [2.1, 2.5] um) lies in the ECS next to it."""
    n = 20 * 2**resolution
    cell = ((0.5 * UM, 1.0 * UM, 1.0 * UM), (4.5 * UM, 2.0 * UM, 2.0 * UM), 1)
    mesh = _build(
        n, n, n, (0, 0, 0), (L * UM, L * UM, L * UM), [cell]
    )
    mesh.facet_tags = np.zeros(mesh.n_facets, np.int32)
    split_membrane_x_slabs(
        mesh, 1, [2.0 * UM, 3.0 * UM], [5, 6, 7]
    )
    mesh.facet_tags[mesh.exterior_facet_mask()] = EXTERIOR_BOUNDARY_TAG
    return mesh


def astrocyte_tissue_mesh(
    resolution: int = 0, L: float = 5.0, n: int | None = None
) -> Mesh:
    """ECS(0) + neuron(1) + glial(2) boxes inside an (L um)^3 ECS cube;
    membranes tagged by the owning cell tag; source-box region of the
    reference configs (x,y in [2.1, 2.9] um, z in [2.1, 2.5] um) lies in
    the ECS between the two cells.  ``n`` overrides the per-axis cell
    count directly (the flagship-scale bench uses n=64: 840k dofs/step)."""
    if n is None:
        n = 20 * 2**resolution
    neuron = ((0.5 * UM, 1.0 * UM, 1.0 * UM), (4.5 * UM, 2.0 * UM, 2.0 * UM), 1)
    glial = ((0.5 * UM, 3.0 * UM, 3.0 * UM), (4.5 * UM, 4.0 * UM, 4.0 * UM), 2)
    mesh = _build(
        n, n, n, (0, 0, 0), (L * UM, L * UM, L * UM), [neuron, glial]
    )
    mesh.facet_tags = mesh.default_facet_tags()
    return mesh


def remark_emimesh(
    mesh: Mesh,
    ecs_tag_in: int = 1,
    scale: float = 1e-7,
    membrane_slab_cuts=None,
    membrane_slab_tags=None,
    tag_map=None,
) -> Mesh:
    """Convert emimesh output conventions to the knpemi conventions
    (reference remark_mesh.py:69-176):

    * cell tags: emimesh ECS `ecs_tag_in` -> 0, cells keep tags 1,2,...;
      `tag_map` optionally remaps arbitrary emimesh cell tags first (the
      reference astrocyte remark maps glial 100 -> 2 and defaults every
      other non-ECS tag to 1, remark_mesh.py:91-100 of
      local_astrocyte_depolarization),
    * coordinates scaled by `scale` (nm -> cm is 1e-7),
    * interface facets retagged from adjacent cell tags,
    * exterior facets tagged 5,
    * optional membrane x-slab split (benchmark remark_mesh.py:144-150).
    """
    cell_tags = mesh.cell_tags.copy()
    if tag_map:
        for old, new in tag_map.items():
            cell_tags[mesh.cell_tags == old] = new
        if ecs_tag_in not in tag_map:
            cell_tags[mesh.cell_tags == ecs_tag_in] = 0
        ecs_tag_in = 0
    cell_tags[cell_tags == ecs_tag_in] = 0
    out = Mesh(
        points=mesh.points * scale,
        cells=mesh.cells.copy(),
        cell_tags=cell_tags,
    )
    out.facet_tags = out.default_facet_tags()
    if membrane_slab_cuts is not None:
        cell = int(np.max(out.cell_tags))
        split_membrane_x_slabs(
            out, cell, np.asarray(membrane_slab_cuts) * scale,
            membrane_slab_tags,
        )
    return out


def find_roi_points(coords: np.ndarray, roi_lo, roi_hi, offsets=(0, -5, 5)):
    """Probe points inside an ROI box, picked around the median index of
    the in-box points — the discovery step the reference's astrocyte
    ``remark_mesh.py::print_coordinates`` runs to choose the evaluation
    coordinates hard-coded into its ``make_figures.py``/``compare_*``
    scripts (local_astrocyte_depolarization/remark_mesh.py:15-59).

    coords: (n, dim) candidate coordinates (membrane dofs, subdomain dofs,
    ...); returns (len(offsets), dim) coordinates, median first.
    """
    lo = np.asarray(roi_lo)
    hi = np.asarray(roi_hi)
    inside = np.flatnonzero(
        np.all((coords >= lo) & (coords <= hi), axis=1)
    )
    if len(inside) == 0:
        raise ValueError("no points inside the ROI box")
    middle = int(round((len(inside) - 1) / 2))
    picks = [
        inside[min(max(middle + o, 0), len(inside) - 1)] for o in offsets
    ]
    return coords[picks]
