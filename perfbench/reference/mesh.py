"""The meshes of the benchmark's configurations, and their P1 spaces.

Plain numpy, independent of the program: a structured box cut into six
Kuhn tetrahedra per cube, cells tagged by the boxes that contain all of
their vertices, and from that the broken P1 space of every subdomain and
the membrane between the ECS (tag 0) and each cell tag.  Dofs are
numbered by ascending parent vertex id, so that both sides of a
comparison can be put into the parent numbering.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

# the Kuhn subdivision of the unit cube: one tetrahedron per axis order
KUHN_PERMS = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0))
# the faces of a tetrahedron: the vertices left when one is dropped
TET_FACES = np.array([[1, 2, 3], [0, 2, 3], [0, 1, 3], [0, 1, 2]])


def structured_tets(n, p0, p1):
    """Points ((nx+1)(ny+1)(nz+1), 3) and tetrahedra (6 nx ny nz, 4) of the
    box [p0, p1] cut into n = (nx, ny, nz) cubes."""
    nx, ny, nz = n
    axes = [np.linspace(p0[d], p1[d], n[d] + 1) for d in range(3)]
    X, Y, Z = np.meshgrid(*axes, indexing="ij")
    points = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)
    vid = lambda c: (c[:, 0] * (ny + 1) + c[:, 1]) * (nz + 1) + c[:, 2]
    i, j, k = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")
    base = np.stack([i.ravel(), j.ravel(), k.ravel()], axis=1)
    e = np.eye(3, dtype=np.int64)
    tets = []
    for perm in KUHN_PERMS:
        c1 = base + e[perm[0]]
        c2 = c1 + e[perm[1]]
        c3 = c2 + e[perm[2]]
        tets.append(np.stack([vid(base), vid(c1), vid(c2), vid(c3)], axis=1))
    return points, np.concatenate(tets).astype(np.int64)


def tag_cells(points, cells, boxes, tol=1e-12):
    """Cell tag = the tag of the last box holding all four vertices, else 0."""
    tags = np.zeros(len(cells), dtype=np.int64)
    x = points[cells]
    for lo, hi, tag in boxes:
        inside = ((x >= np.asarray(lo) - tol) & (x <= np.asarray(hi) + tol)).all(axis=(1, 2))
        tags[inside] = tag
    return tags


@dataclasses.dataclass
class Subdomain:
    tag: int
    vertices: np.ndarray  # (n,) parent vertex ids, ascending
    cells: np.ndarray  # (nc, 4) local dofs
    grads: np.ndarray  # (nc, 4, 3) P1 basis gradients
    vols: np.ndarray  # (nc,)
    coords: np.ndarray  # (n, 3)

    @property
    def n(self) -> int:
        return len(self.vertices)


@dataclasses.dataclass
class Membrane:
    tag: int
    cell_tag: int
    vertices: np.ndarray  # (n,) parent vertex ids, ascending
    facets: np.ndarray  # (nf, 3) membrane-local dofs
    areas: np.ndarray  # (nf,)
    to_ecs: np.ndarray  # (n,) ECS dof of each membrane dof
    to_ics: np.ndarray  # (n,) ICS dof of each membrane dof
    coords: np.ndarray  # (n, 3)

    @property
    def n(self) -> int:
        return len(self.vertices)


@dataclasses.dataclass
class Geometry:
    subdomains: Dict[int, Subdomain]
    membranes: Dict[int, Membrane]

    @property
    def tags(self) -> List[int]:
        return sorted(self.subdomains)


def _cell_geometry(x):
    """P1 basis gradients and volumes of tetrahedra with vertices x (nc, 4, 3)."""
    E = x[:, 1:] - x[:, :1]
    vols = np.abs(np.linalg.det(E)) / 6.0
    rest = np.linalg.inv(np.swapaxes(E, 1, 2))
    return np.concatenate([-rest.sum(axis=1, keepdims=True), rest], axis=1), vols


def geometry(points, cells, tags) -> Geometry:
    """Subdomain spaces of every cell tag and the membrane of each ICS tag
    (membrane tag = cell tag) with the ECS."""
    subs = {}
    for t in np.unique(tags).tolist():
        cp = cells[tags == t]
        verts = np.unique(cp)
        grads, vols = _cell_geometry(points[cp])
        subs[t] = Subdomain(t, verts, np.searchsorted(verts, cp), grads, vols, points[verts])
    # faces shared by a cell of the ECS and a cell of tag s: the membrane of s
    faces = np.sort(cells[:, TET_FACES].reshape(-1, 3), axis=1)
    owner = np.repeat(tags, 4)
    P = len(points)
    key = (faces[:, 0] * P + faces[:, 1]) * P + faces[:, 2]
    order = np.argsort(key, kind="stable")
    ks, os_ = key[order], owner[order]
    pair = np.flatnonzero(ks[1:] == ks[:-1])  # interior faces: positions i, i+1
    ta, tb = os_[pair], os_[pair + 1]
    lo, hi = np.minimum(ta, tb), np.maximum(ta, tb)
    mems = {}
    for s in subs:
        if s == 0:
            continue
        sel = pair[(lo == 0) & (hi == s)]
        fverts = faces[order[sel]]
        verts = np.unique(fverts)
        x = points[fverts]
        areas = 0.5 * np.linalg.norm(np.cross(x[:, 1] - x[:, 0], x[:, 2] - x[:, 0]), axis=1)
        mems[s] = Membrane(
            tag=s, cell_tag=s, vertices=verts, facets=np.searchsorted(verts, fverts),
            areas=areas, to_ecs=np.searchsorted(subs[0].vertices, verts),
            to_ics=np.searchsorted(subs[s].vertices, verts), coords=points[verts])
    return Geometry(subs, mems)


def build(mesh: dict) -> Geometry:
    """The geometry of a configuration's ``mesh`` entry: a box of
    ``cells`` cubes from ``lo`` to ``hi`` with tagged ``boxes`` [lo, hi, tag]."""
    points, cells = structured_tets(mesh["cells"], mesh["lo"], mesh["hi"])
    tags = tag_cells(points, cells, [(b[0], b[1], b[2]) for b in mesh["boxes"]])
    return geometry(points, cells, tags)
