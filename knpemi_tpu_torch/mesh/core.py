"""Array-based mesh container (host side, numpy).

Replaces the dolfinx C++ mesh/topology/meshtags stack used by the
reference (reference: run_2D.py:114-134 ``read_mesh``, scifem
``extract_submesh`` / ``find_interface``): here a mesh is just flat
integer/float arrays plus derived connectivity, all computed once on the
host with vectorized numpy.  Everything the device-side solver needs is
precomputed into static index arrays (SURVEY.md section 7, design delta 3).

Tag conventions (identical to the reference, README.md:67-72):

* cell tags: ECS is ``0``; cells (ICS) are ``1, 2, 3, ...``
* facet tags: interior non-membrane facets ``0``; membrane facets carry
  per-membrane-model tags (usually the cell tag); exterior boundary ``5``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

EXTERIOR_BOUNDARY_TAG = 5
INTERIOR_FACET_TAG = 0

# Local facet k of a simplex cell is the facet opposite local vertex k,
# i.e. the sorted remaining vertices.  (Same convention as basix for the
# purposes of facet enumeration; we only ever use *sorted vertex tuples*
# as facet identity so the ordering choice is internal.)
_TRI_FACETS = np.array([[1, 2], [0, 2], [0, 1]], dtype=np.int32)
_TET_FACETS = np.array(
    [[1, 2, 3], [0, 2, 3], [0, 1, 3], [0, 1, 2]], dtype=np.int32
)


def facet_vertices_of_cells(cells: np.ndarray) -> np.ndarray:
    """Return (n_cells, n_facets_per_cell, d) vertex ids of each local facet."""
    nv = cells.shape[1]
    if nv == 3:
        return cells[:, _TRI_FACETS]  # (nc, 3, 2)
    if nv == 4:
        return cells[:, _TET_FACETS]  # (nc, 4, 3)
    raise ValueError(f"unsupported cell with {nv} vertices")


@dataclasses.dataclass
class Mesh:
    """Simplex mesh with cell and facet tags.

    Attributes
    ----------
    points : (n_points, dim) float64
    cells : (n_cells, dim+1) int32 vertex indices
    cell_tags : (n_cells,) int32 subdomain tags
    facets : (n_facets, dim) int32 sorted vertex indices (unique facets)
    facet_tags : (n_facets,) int32
    facet_cells : (n_facets, 2) int32 adjacent cells, second entry -1 on
        the exterior boundary.  For interior facets the two cells are
        ordered so that ``cell_tags[facet_cells[:,0]] <=
        cell_tags[facet_cells[:,1]]`` (low tag first; the reference
        orients interface normals from lower to higher tag,
        README.md:70-72).
    """

    points: np.ndarray
    cells: np.ndarray
    cell_tags: np.ndarray
    facets: np.ndarray = None
    facet_tags: np.ndarray = None
    facet_cells: np.ndarray = None

    def __post_init__(self):
        self.points = np.asarray(self.points, dtype=np.float64)
        self.cells = np.asarray(self.cells, dtype=np.int32)
        self.cell_tags = np.asarray(self.cell_tags, dtype=np.int32)
        if self.facets is None:
            self._build_facets()

    # ----- basic properties -------------------------------------------------
    @property
    def dim(self) -> int:
        return self.points.shape[1]

    @property
    def n_points(self) -> int:
        return self.points.shape[0]

    @property
    def n_cells(self) -> int:
        return self.cells.shape[0]

    @property
    def n_facets(self) -> int:
        return self.facets.shape[0]

    # ----- connectivity -----------------------------------------------------
    def _build_facets(self):
        """Derive unique facets, facet->cell connectivity.

        Vectorized replacement for dolfinx ``create_entities`` /
        ``create_connectivity`` (reference run_2D.py:124-127).
        """
        cf = facet_vertices_of_cells(self.cells)  # (nc, nf_per_cell, d)
        nc, nfc, d = cf.shape
        flat = np.sort(cf.reshape(-1, d), axis=1)  # canonical vertex order
        # Unique facets, in lexicographic order: one int64 key a facet
        # where its vertex ids fit (a 1-D sort, ~15x the row sort's speed)
        P = int(self.n_points)
        if P ** d < 2 ** 63:
            key = flat[:, 0].astype(np.int64)
            for j in range(1, d):
                key = key * P + flat[:, j]
            _, first, inverse = np.unique(key, return_index=True, return_inverse=True)
            facets = flat[first]
        else:
            facets, inverse = np.unique(flat, axis=0, return_inverse=True)
        inverse = inverse.reshape(nc, nfc)
        nf = facets.shape[0]

        # facet -> (cell, cell) map: scatter cell ids into two slots.
        facet_cells = np.full((nf, 2), -1, dtype=np.int64)
        cell_ids = np.repeat(np.arange(nc, dtype=np.int64), nfc)
        order = np.argsort(inverse.reshape(-1), kind="stable")
        sorted_f = inverse.reshape(-1)[order]
        sorted_c = cell_ids[order]
        # first occurrence of each facet id in sorted stream
        first = np.searchsorted(sorted_f, np.arange(nf))
        counts = np.bincount(sorted_f, minlength=nf)
        if counts.max() > 2:
            raise ValueError("facet shared by more than two cells")
        facet_cells[:, 0] = sorted_c[first]
        has2 = counts == 2
        facet_cells[has2, 1] = sorted_c[first[has2] + 1]

        # order interior pairs low-tag-first
        t0 = self.cell_tags[facet_cells[:, 0]]
        t1 = np.where(has2, self.cell_tags[np.maximum(facet_cells[:, 1], 0)], t0)
        swap = has2 & (t1 < t0)
        facet_cells[swap] = facet_cells[swap][:, ::-1]

        self.facets = facets.astype(np.int32)
        self.facet_cells = facet_cells.astype(np.int32)
        if self.facet_tags is None:
            self.facet_tags = np.zeros(nf, dtype=np.int32)

    # ----- tagging helpers ----------------------------------------------------
    def exterior_facet_mask(self) -> np.ndarray:
        return self.facet_cells[:, 1] < 0

    def interface_facet_mask(self, tag_a: int, tag_b: int) -> np.ndarray:
        """Facets whose two adjacent cells carry tags (a, b) — the analog of
        scifem.find_interface (reference make_mesh_2D.py:93)."""
        interior = ~self.exterior_facet_mask()
        t0 = self.cell_tags[self.facet_cells[:, 0]]
        t1 = self.cell_tags[np.maximum(self.facet_cells[:, 1], 0)]
        lo, hi = min(tag_a, tag_b), max(tag_a, tag_b)
        return interior & (t0 == lo) & (t1 == hi)

    def default_facet_tags(
        self, membrane_tag_of_cell_tag: Optional[dict] = None
    ) -> np.ndarray:
        """Build facet tags with the reference convention: interface facets of
        cell tag ``s`` get tag ``membrane_tag_of_cell_tag.get(s, s)``, exterior
        facets get 5, everything else 0 (make_mesh_2D.py:88-108)."""
        tags = np.zeros(self.n_facets, dtype=np.int32)
        cell_tag_values = np.unique(self.cell_tags)
        for s in cell_tag_values:
            if s == 0:
                continue
            m = self.interface_facet_mask(0, int(s))
            mt = s if membrane_tag_of_cell_tag is None else membrane_tag_of_cell_tag.get(int(s), int(s))
            tags[m] = mt
        tags[self.exterior_facet_mask()] = EXTERIOR_BOUNDARY_TAG
        return tags

    def facet_midpoints(self, facet_ids: np.ndarray) -> np.ndarray:
        return self.points[self.facets[facet_ids]].mean(axis=1)

    def cell_midpoints(self) -> np.ndarray:
        return self.points[self.cells].mean(axis=1)

    def cell_volumes(self) -> np.ndarray:
        x = self.points[self.cells]  # (nc, d+1, dim)
        e = x[:, 1:, :] - x[:, :1, :]  # (nc, d, dim)
        if self.dim == 2:
            det = e[:, 0, 0] * e[:, 1, 1] - e[:, 0, 1] * e[:, 1, 0]
            return np.abs(det) / 2.0
        det = np.linalg.det(e)
        return np.abs(det) / 6.0

    def validate(self):
        assert self.cells.max() < self.n_points
        assert (self.cell_volumes() > 0).all(), "degenerate cells"
        assert self.facet_tags.shape == (self.n_facets,)
        return True


# VTK "Hexahedron" ring order -> tensor bit order (index = x + 2y + 4z):
# bottom ring v0..v3 = (x0y0) (x1y0) (x1y1) (x0y1), top ring v4..v7.
_VTK_HEX_TO_TENSOR = np.array([0, 1, 3, 2, 4, 5, 7, 6])
# Kuhn triangulation: one tet per axis-order permutation, each walking
# 000 -> +axis -> +axis -> 111 in tensor bit indices.
_KUHN_TETS = []
for _p in ((1, 2, 4), (1, 4, 2), (2, 1, 4), (2, 4, 1), (4, 1, 2), (4, 2, 1)):
    _KUHN_TETS.append((0, _p[0], _p[0] + _p[1], 7))
_KUHN_TETS = np.array(_KUHN_TETS)


def split_hex_cells(hex_cells: np.ndarray):
    """Split VTK-ordered hexahedra into 6 Kuhn tets each.

    Every hex uses the same local split, which is face-consistent on
    translationally structured grids (the reference's idealized 3-D
    meshes, make_mesh_3D.py:99-102, are dolfinx box meshes): on a shared
    face both neighbors cut along the (y0z0)-(y1z1)-type diagonal.
    Returns (tet_cells (6*nh, 4), parent_hex (6*nh,)).
    """
    hexes = np.asarray(hex_cells)
    tens = hexes[:, _VTK_HEX_TO_TENSOR]  # (nh, 8) tensor-ordered
    tets = tens[:, _KUHN_TETS]  # (nh, 6, 4)
    nh = len(hexes)
    parent = np.repeat(np.arange(nh), 6)
    return tets.reshape(nh * 6, 4).astype(hexes.dtype), parent


def quad_facet_tags_to_tris(mesh: "Mesh", quads: np.ndarray,
                            quad_vals: np.ndarray) -> np.ndarray:
    """Transfer facet tags from quadrilateral facets (of the original hex
    mesh) onto the split tet mesh's triangular facets: a triangle gets a
    quad's tag iff its vertex set is contained in the quad's (each quad
    matches exactly the 2 triangles of its split).  Fully vectorized."""
    tags = np.zeros(mesh.n_facets, np.int32)
    table = np.ascontiguousarray(np.sort(mesh.facets, axis=1), np.int64)
    tv = table.view([("", np.int64)] * 3).ravel()
    order = np.argsort(tv)

    qs = np.sort(np.asarray(quads, np.int64), axis=1)  # (nq, 4)
    # the 4 vertex triples of each quad (drop one vertex each)
    cand = np.stack(
        [np.delete(qs, d, axis=1) for d in range(4)], axis=1
    ).reshape(-1, 3)  # (nq*4, 3)
    vals4 = np.repeat(np.asarray(quad_vals, np.int32), 4)
    cv = np.ascontiguousarray(cand).view([("", np.int64)] * 3).ravel()
    pos = np.searchsorted(tv[order], cv)
    pos = np.minimum(pos, len(tv) - 1)
    idx = order[pos]
    hit = tv[idx] == cv
    tags[idx[hit]] = vals4[hit]
    return tags
