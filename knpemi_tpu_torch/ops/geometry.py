"""Discrete geometry: broken P1 spaces, membrane trace maps, facet data.

This is the host-side (numpy) setup stage that replaces the reference's
dolfinx submesh + scifem machinery:

* per-subdomain P1 spaces on cell-tag submeshes
  (scifem.extract_submesh, reference run_2D.py:154-158),
* membrane (interface) P1 spaces on facet-tag submeshes,
* interface integration data — for every membrane facet, the ECS-side and
  ICS-side dofs (scifem.compute_interface_data, emiWeakForm.py:40;
  utils.py:18-87 ``extract_facet_integration_data``),
* trace gather maps membrane-dof -> ECS/ICS-dof
  (scifem.interpolate_to_surface_submesh, utils.py:150-207 — for P1 the
  two-sided trace is an exact vertex gather),
* precomputed P1 basis gradients and measures for the element kernels.

Everything here runs once per mesh; the outputs are static index/geometry
arrays consumed by the device kernels in :mod:`knpemi_tpu_torch.ops.assembly`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ..mesh.core import Mesh


@dataclasses.dataclass
class SubdomainSpace:
    """P1 space on the submesh of cells with a given tag (broken global
    field: each subdomain owns an independent copy of interface vertices,
    reproducing the reference's per-submesh CG spaces, emiWeakForm.py:66)."""

    tag: int
    vertices: np.ndarray  # (n_dofs,) parent vertex ids
    parent_to_local: np.ndarray  # (n_points,) int32, -1 where absent
    parent_cells: np.ndarray  # (n_cells_s,) parent cell ids
    cells: np.ndarray  # (n_cells_s, d+1) local dof ids
    coords: np.ndarray  # (n_dofs, dim)
    grads: np.ndarray  # (n_cells_s, d+1, dim) P1 basis gradients
    vols: np.ndarray  # (n_cells_s,)

    @property
    def n_dofs(self) -> int:
        return len(self.vertices)

    @property
    def n_cells(self) -> int:
        return len(self.parent_cells)


@dataclasses.dataclass
class MembraneSpace:
    """P1 space on the membrane facets with a given facet tag, plus the
    two-sided interface integration data."""

    tag: int  # facet (membrane-model) tag
    cell_tag: int  # adjacent ICS subdomain tag
    parent_facets: np.ndarray  # (n_f,) facet ids in parent mesh
    facet_verts: np.ndarray  # (n_f, d) parent vertex ids
    vertices: np.ndarray  # (n_dofs,) parent vertex ids (membrane dofs)
    facet_dofs: np.ndarray  # (n_f, d) membrane-local dof ids
    facet_edofs: np.ndarray  # (n_f, d) ECS-local dof ids
    facet_idofs: np.ndarray  # (n_f, d) ICS-local dof ids
    areas: np.ndarray  # (n_f,)
    normals: np.ndarray  # (n_f, dim), oriented outward from the ICS side
    mem_to_ecs: np.ndarray  # (n_dofs,) ECS dof of each membrane dof
    mem_to_ics: np.ndarray  # (n_dofs,)
    coords: np.ndarray  # (n_dofs, dim)

    @property
    def n_dofs(self) -> int:
        return len(self.vertices)

    @property
    def n_facets(self) -> int:
        return len(self.parent_facets)


@dataclasses.dataclass
class BoundarySpace:
    """Exterior boundary facets with a given tag, restricted to one
    subdomain (the ECS in every reference scenario)."""

    tag: int
    sub_tag: int
    parent_facets: np.ndarray
    facet_verts: np.ndarray  # (n_f, d) parent vertex ids
    facet_dofs: np.ndarray  # (n_f, d) subdomain-local dof ids
    areas: np.ndarray
    normals: np.ndarray  # outward from the domain
    dofs: np.ndarray  # unique subdomain-local dof ids on this boundary

    @property
    def n_facets(self) -> int:
        return len(self.parent_facets)


@dataclasses.dataclass
class DiscreteGeometry:
    mesh: Mesh
    subdomains: Dict[int, SubdomainSpace]
    membranes: Dict[int, MembraneSpace]
    boundaries: Dict[int, BoundarySpace]
    # cell subdomain tag -> list of membrane tags, in declaration order
    membranes_of_cell: Dict[int, List[int]]

    @property
    def dim(self) -> int:
        return self.mesh.dim

    @property
    def sub_tags(self) -> List[int]:
        return sorted(self.subdomains.keys())

    @property
    def cell_tags_list(self) -> List[int]:
        """ICS subdomain tags (every tag but the ECS 0)."""
        return [t for t in self.sub_tags if t != 0]

    def emi_offsets(self) -> Dict[int, int]:
        off = {}
        cur = 0
        for t in self.sub_tags:
            off[t] = cur
            cur += self.subdomains[t].n_dofs
        return off

    @property
    def emi_size(self) -> int:
        return sum(s.n_dofs for s in self.subdomains.values())

    def stats(self) -> dict:
        return {
            "dim": self.dim,
            "n_points": self.mesh.n_points,
            "n_cells": self.mesh.n_cells,
            "n_facets": self.mesh.n_facets,
            "subdomains": {
                t: {"n_dofs": s.n_dofs, "n_cells": s.n_cells}
                for t, s in self.subdomains.items()
            },
            "membranes": {
                t: {"n_dofs": m.n_dofs, "n_facets": m.n_facets}
                for t, m in self.membranes.items()
            },
        }


def _rcm_order(cells_local: np.ndarray, n: int) -> np.ndarray:
    """Reverse Cuthill-McKee permutation of the vertex adjacency graph.

    RCM minimizes the operator bandwidth (max |i-j| over edges), so the
    dofs a cell touches lie close together in memory.  Consecutive RCM
    dofs are BFS level-set neighbors — graph-local, so contiguous-range
    SA aggregation (solvers/mg.py) stays valid.  This ordering is the
    JAX package's default, reproduced index for index."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    k = cells_local.shape[1]
    rows, cols = [], []
    for i in range(k):
        for j in range(k):
            if i != j:
                rows.append(cells_local[:, i])
                cols.append(cells_local[:, j])
    G = sp.csr_matrix(
        (
            np.ones(k * (k - 1) * len(cells_local), np.int8),
            (np.concatenate(rows), np.concatenate(cols)),
        ),
        shape=(n, n),
    )
    return np.asarray(reverse_cuthill_mckee(G, symmetric_mode=True))


def _p1_cell_geometry(points: np.ndarray, cells: np.ndarray):
    """P1 basis gradients and volumes per cell.

    For a simplex with vertices x_0..x_d the basis gradients are constant:
    with E = [x_1-x_0, ..., x_d-x_0]^T, grad(lambda_i) for i>=1 are the rows
    of inv(E), and grad(lambda_0) = -sum_i grad(lambda_i).
    """
    x = points[cells]  # (nc, d+1, dim)
    dim = points.shape[1]
    E = x[:, 1:, :] - x[:, :1, :]  # (nc, d, dim)
    det = np.linalg.det(E)
    vols = np.abs(det) / (2.0 if dim == 2 else 6.0)
    # In local coords x = x_0 + E^T xi with lambda_i = xi_{i-1} (i >= 1):
    # xi = inv(E^T)(x - x_0), so grad_x lambda_i is ROW (i-1) of inv(E^T).
    grads_rest = np.linalg.inv(np.swapaxes(E, 1, 2))  # (nc, d, dim), rows = grads
    g0 = -grads_rest.sum(axis=1, keepdims=True)
    grads = np.concatenate([g0, grads_rest], axis=1)  # (nc, d+1, dim)
    return grads, vols


def _facet_measure_normal(points, facet_verts, inside_points):
    """Facet measures and normals oriented away from `inside_points`
    (one reference point per facet, e.g. the adjacent cell centroid)."""
    x = points[facet_verts]  # (nf, d, dim)
    dim = points.shape[1]
    if dim == 2:
        e = x[:, 1, :] - x[:, 0, :]
        lengths = np.linalg.norm(e, axis=1)
        normals = np.stack([e[:, 1], -e[:, 0]], axis=1) / lengths[:, None]
        measure = lengths
    else:
        e1 = x[:, 1, :] - x[:, 0, :]
        e2 = x[:, 2, :] - x[:, 0, :]
        cr = np.cross(e1, e2)
        nrm = np.linalg.norm(cr, axis=1)
        normals = cr / nrm[:, None]
        measure = nrm / 2.0
    mid = x.mean(axis=1)
    flip = ((mid - inside_points) * normals).sum(axis=1) < 0
    normals[flip] *= -1.0
    return measure, normals


def build_geometry(
    mesh: Mesh,
    membrane_cell_tag: Optional[Dict[int, int]] = None,
    exterior_tags: Optional[List[int]] = None,
) -> DiscreteGeometry:
    """Build all discrete spaces and interface data from a tagged mesh.

    Parameters
    ----------
    mesh : tagged parent mesh.
    membrane_cell_tag : map facet tag -> owning ICS cell tag for each
        membrane.  Default: every interior facet tag value m > 0 whose
        facets separate ECS (0) from some cell is a membrane; the owning
        cell tag is inferred from the adjacent cells.
    exterior_tags : facet tag values on the exterior boundary to expose as
        :class:`BoundarySpace` (default: all tags present on exterior
        facets).
    """
    pts = mesh.points
    dim = mesh.dim

    # ---- subdomain spaces ---------------------------------------------------
    subdomains: Dict[int, SubdomainSpace] = {}
    for tag in np.unique(mesh.cell_tags):
        tag = int(tag)
        cell_ids = np.flatnonzero(mesh.cell_tags == tag)
        cells_p = mesh.cells[cell_ids]
        verts = np.unique(cells_p)
        # dof ordering: reverse Cuthill-McKee over the vertex graph, so
        # consecutive dofs are graph-compact (contiguous SA aggregates in
        # solvers/mg.py, narrow operator bandwidth)
        tmp = np.full(mesh.n_points, -1, dtype=np.int32)
        tmp[verts] = np.arange(len(verts), dtype=np.int32)
        verts = verts[_rcm_order(tmp[cells_p], len(verts))]
        p2l = np.full(mesh.n_points, -1, dtype=np.int32)
        p2l[verts] = np.arange(len(verts), dtype=np.int32)
        cells_l = p2l[cells_p]
        # sort cells by their smallest dof (memory locality of the cell
        # kernels' gathers and scatters)
        corder = np.argsort(cells_l.min(axis=1), kind="stable")
        cell_ids = cell_ids[corder]
        cells_p = cells_p[corder]
        cells_l = cells_l[corder]
        grads, vols = _p1_cell_geometry(pts, cells_p)
        subdomains[tag] = SubdomainSpace(
            tag=tag,
            vertices=verts.astype(np.int32),
            parent_to_local=p2l,
            parent_cells=cell_ids.astype(np.int32),
            cells=cells_l.astype(np.int32),
            coords=pts[verts],
            grads=grads,
            vols=vols,
        )

    # ---- membranes ----------------------------------------------------------
    ext_mask = mesh.exterior_facet_mask()
    interior_tags = np.unique(mesh.facet_tags[~ext_mask])
    if membrane_cell_tag is None:
        membrane_cell_tag = {}
        for m in interior_tags:
            if m == 0:
                continue
            fids = np.flatnonzero((mesh.facet_tags == m) & ~ext_mask)
            ta = mesh.cell_tags[mesh.facet_cells[fids, 0]]
            tb = mesh.cell_tags[mesh.facet_cells[fids, 1]]
            hi = np.maximum(ta, tb)
            lo = np.minimum(ta, tb)
            assert (lo == 0).all(), (
                f"membrane facets with tag {m} must separate the ECS (0) "
                f"from one cell; found cell tags {np.unique(lo)}"
            )
            (ct_vals,) = (np.unique(hi),)
            assert len(ct_vals) == 1, (
                f"membrane tag {m} touches several cells {ct_vals}; pass "
                "membrane_cell_tag explicitly"
            )
            membrane_cell_tag[int(m)] = int(ct_vals[0])

    membranes: Dict[int, MembraneSpace] = {}
    membranes_of_cell: Dict[int, List[int]] = {t: [] for t in subdomains if t != 0}
    for mtag, ctag in membrane_cell_tag.items():
        fids = np.flatnonzero((mesh.facet_tags == mtag) & ~ext_mask)
        assert len(fids) > 0, f"no facets tagged {mtag}"
        fverts = mesh.facets[fids]  # (nf, d)
        c0 = mesh.facet_cells[fids, 0]
        c1 = mesh.facet_cells[fids, 1]
        t0 = mesh.cell_tags[c0]
        # facet_cells ordered low tag first -> c0 is ECS cell, c1 is ICS cell
        assert (t0 == 0).all() and (mesh.cell_tags[c1] == ctag).all()
        verts = np.unique(fverts)
        m2l = np.full(mesh.n_points, -1, dtype=np.int32)
        m2l[verts] = np.arange(len(verts), dtype=np.int32)
        facet_dofs = m2l[fverts]
        e_p2l = subdomains[0].parent_to_local
        i_p2l = subdomains[ctag].parent_to_local
        facet_edofs = e_p2l[fverts]
        facet_idofs = i_p2l[fverts]
        assert (facet_edofs >= 0).all() and (facet_idofs >= 0).all()
        ics_centroids = pts[mesh.cells[c1]].mean(axis=1)
        areas, normals = _facet_measure_normal(pts, fverts, ics_centroids)
        membranes[int(mtag)] = MembraneSpace(
            tag=int(mtag),
            cell_tag=int(ctag),
            parent_facets=fids.astype(np.int32),
            facet_verts=fverts.astype(np.int32),
            vertices=verts.astype(np.int32),
            facet_dofs=facet_dofs.astype(np.int32),
            facet_edofs=facet_edofs.astype(np.int32),
            facet_idofs=facet_idofs.astype(np.int32),
            areas=areas,
            normals=normals,
            mem_to_ecs=e_p2l[verts].astype(np.int32),
            mem_to_ics=i_p2l[verts].astype(np.int32),
            coords=pts[verts],
        )
        membranes_of_cell.setdefault(int(ctag), []).append(int(mtag))

    # ---- exterior boundaries -------------------------------------------------
    boundaries: Dict[int, BoundarySpace] = {}
    if exterior_tags is None:
        exterior_tags = [int(t) for t in np.unique(mesh.facet_tags[ext_mask])]
    for btag in exterior_tags:
        fids = np.flatnonzero((mesh.facet_tags == btag) & ext_mask)
        if len(fids) == 0:
            continue
        fverts = mesh.facets[fids]
        c0 = mesh.facet_cells[fids, 0]
        stag = np.unique(mesh.cell_tags[c0])
        assert len(stag) == 1, "boundary facets must belong to one subdomain"
        stag = int(stag[0])
        p2l = subdomains[stag].parent_to_local
        fdofs = p2l[fverts]
        assert (fdofs >= 0).all()
        centroids = pts[mesh.cells[c0]].mean(axis=1)
        areas, normals = _facet_measure_normal(pts, fverts, centroids)
        boundaries[int(btag)] = BoundarySpace(
            tag=int(btag),
            sub_tag=stag,
            parent_facets=fids.astype(np.int32),
            facet_verts=fverts.astype(np.int32),
            facet_dofs=fdofs.astype(np.int32),
            areas=areas,
            normals=normals,
            dofs=np.unique(fdofs).astype(np.int32),
        )

    return DiscreteGeometry(
        mesh=mesh,
        subdomains=subdomains,
        membranes=membranes,
        boundaries=boundaries,
        membranes_of_cell=membranes_of_cell,
    )
