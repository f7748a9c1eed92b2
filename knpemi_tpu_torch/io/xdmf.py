"""XDMF + HDF5 mesh and field I/O (host side, h5py + stdlib XML).

A numpy/h5py copy of ``knpemi_tpu/io/xdmf.py``: the same files, array
for array, so a mesh or a series written by either package reads back
equal in the other.  ``write_mesh`` / ``read_mesh`` (triangles and
tetrahedra; hexahedra split into Kuhn tetrahedra with their quad facet
tags carried over; a mesh grid's own integer cell attribute adopted when
the named tag grid is absent) replace dolfinx's XDMFFile, the XML tree
through ElementTree, the heavy data in an HDF5 sidecar.
``TimeSeriesWriter`` writes one series of nodal fields on a submesh,
buffered in RAM and flushed every ``flush_every`` frames, each frame's
time in the h5 itself, so that a crashed run's series can be reopened
and truncated to a checkpoint (``resume_at``).  ParaView opens the
output directly.  h5py is imported inside the functions that need it.
"""

from __future__ import annotations

import os
import warnings
import xml.etree.ElementTree as ET
from pathlib import Path
from typing import Dict

import numpy as np

from ..mesh.core import Mesh, quad_facet_tags_to_tris, split_hex_cells

_TOPO_NAME = {3: "Triangle", 4: "Tetrahedron", 2: "PolyLine"}
_TOPO_DIM = {"triangle": 3, "tetrahedron": 4, "polyline": 2, "mixed": None}


def _h5_path(xdmf_path):
    return str(Path(xdmf_path).with_suffix(".h5"))


def write_mesh(path: str, mesh: Mesh, cell_tag_name="cell_marker",
               facet_tag_name="facet_marker"):
    """Write mesh + cell tags + facet tags (XDMF 3 / HDF5)."""
    path = str(path)
    h5path = _h5_path(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    import h5py

    nv = mesh.cells.shape[1]
    with h5py.File(h5path, "w") as h5:
        h5["/Mesh/geometry"] = mesh.points
        h5["/Mesh/topology"] = mesh.cells.astype(np.int64)
        h5["/Mesh/cell_values"] = mesh.cell_tags.astype(np.int32)
        h5["/Mesh/facet_topology"] = mesh.facets.astype(np.int64)
        h5["/Mesh/facet_values"] = mesh.facet_tags.astype(np.int32)

    h5rel = os.path.basename(h5path)
    root = ET.Element("Xdmf", Version="3.0")
    dom = ET.SubElement(root, "Domain")

    def data_item(parent, shape, text, dtype="Float", prec="8"):
        di = ET.SubElement(
            parent, "DataItem",
            Dimensions=" ".join(map(str, shape)),
            Format="HDF", NumberType=dtype, Precision=prec,
        )
        di.text = text
        return di

    grid = ET.SubElement(dom, "Grid", Name="mesh", GridType="Uniform")
    topo = ET.SubElement(
        grid, "Topology",
        TopologyType=_TOPO_NAME[nv],
        NumberOfElements=str(mesh.n_cells),
        NodesPerElement=str(nv),
    )
    data_item(topo, mesh.cells.shape, f"{h5rel}:/Mesh/topology", "Int", "8")
    geo = ET.SubElement(
        grid, "Geometry", GeometryType="XY" if mesh.dim == 2 else "XYZ"
    )
    data_item(geo, mesh.points.shape, f"{h5rel}:/Mesh/geometry")

    ctgrid = ET.SubElement(dom, "Grid", Name=cell_tag_name, GridType="Uniform")
    topo2 = ET.SubElement(
        ctgrid, "Topology", TopologyType=_TOPO_NAME[nv],
        NumberOfElements=str(mesh.n_cells), NodesPerElement=str(nv),
    )
    data_item(topo2, mesh.cells.shape, f"{h5rel}:/Mesh/topology", "Int", "8")
    geo2 = ET.SubElement(
        ctgrid, "Geometry", GeometryType="XY" if mesh.dim == 2 else "XYZ"
    )
    data_item(geo2, mesh.points.shape, f"{h5rel}:/Mesh/geometry")
    attr = ET.SubElement(
        ctgrid, "Attribute", Name=cell_tag_name, AttributeType="Scalar",
        Center="Cell",
    )
    data_item(attr, (mesh.n_cells,), f"{h5rel}:/Mesh/cell_values", "Int", "4")

    ftgrid = ET.SubElement(dom, "Grid", Name=facet_tag_name, GridType="Uniform")
    ftopo = ET.SubElement(
        ftgrid, "Topology", TopologyType=_TOPO_NAME[mesh.facets.shape[1]],
        NumberOfElements=str(mesh.n_facets),
        NodesPerElement=str(mesh.facets.shape[1]),
    )
    data_item(ftopo, mesh.facets.shape, f"{h5rel}:/Mesh/facet_topology", "Int", "8")
    fgeo = ET.SubElement(
        ftgrid, "Geometry", GeometryType="XY" if mesh.dim == 2 else "XYZ"
    )
    data_item(fgeo, mesh.points.shape, f"{h5rel}:/Mesh/geometry")
    fattr = ET.SubElement(
        ftgrid, "Attribute", Name=facet_tag_name, AttributeType="Scalar",
        Center="Cell",
    )
    data_item(fattr, (mesh.n_facets,), f"{h5rel}:/Mesh/facet_values", "Int", "4")

    ET.ElementTree(root).write(path, xml_declaration=True)


def read_mesh(path: str, cell_tag_name="cell_marker",
              facet_tag_name="facet_marker") -> Mesh:
    """Read an XDMF mesh with cell/facet tags (both this module's output
    and dolfinx-written files)."""
    import h5py

    path = str(path)
    tree = ET.parse(path)
    dom = tree.getroot().find("Domain")
    base = os.path.dirname(os.path.abspath(path))

    def load_item(di):
        txt = di.text.strip()
        fname, dset = txt.split(":", 1)
        with h5py.File(os.path.join(base, fname), "r") as h5:
            return np.asarray(h5[dset])

    points = cells = cell_vals = None
    cell_entities = {}
    grids = dom.findall("Grid")
    # dolfinx layout: first Grid = mesh; tag grids named cell_marker etc.
    for grid in grids:
        name = grid.get("Name", "")
        topo = grid.find("Topology")
        geo = grid.find("Geometry")
        attr = grid.find("Attribute")
        topo_type = (topo.get("TopologyType") or "").lower()
        ents = load_item(topo.find("DataItem")).astype(np.int64)
        if geo is not None and points is None:
            points = load_item(geo.find("DataItem")).astype(np.float64)
            gt = geo.get("GeometryType", "XYZ").upper()
            if gt == "XY":
                points = points[:, :2]
            elif points.shape[1] == 3 and np.allclose(points[:, 2], 0):
                pass
        vals = load_item(attr.find("DataItem")) if attr is not None else None
        cell_entities[name or topo_type] = (topo_type, ents, vals)

    # identify mesh (highest-dim entity set) and tags
    def tdim(tt):
        return {"triangle": 2, "tetrahedron": 3, "polyline": 1,
                "polyvertex": 0, "hexahedron": 3, "quadrilateral": 2,
                }.get(tt, -1)

    items = sorted(cell_entities.items(), key=lambda kv: -tdim(kv[1][0]))
    _, (tt0, cells, cvals0) = items[0][0], items[0][1]
    cdim = tdim(tt0)
    cell_tags = np.zeros(len(cells), np.int32)
    facet_ents = facet_vals = None
    for name, (tt, ents, vals) in cell_entities.items():
        if vals is None:
            continue
        if tdim(tt) == cdim and (name == cell_tag_name or cvals0 is None):
            # tag grid over cells — match entity rows to cell rows
            if len(ents) == len(cells) and np.array_equal(
                np.sort(ents, 1), np.sort(cells, 1)
            ):
                cell_tags = vals.astype(np.int32)
            else:
                # entity list may be permuted: map sorted tuples
                order = _match_rows(np.sort(cells, 1), np.sort(ents, 1))
                cell_tags = np.zeros(len(cells), np.int32)
                cell_tags[order] = vals
        elif tdim(tt) == cdim - 1:
            facet_ents, facet_vals = np.sort(ents, 1), vals

    if cell_tags.max(initial=0) == 0 and cvals0 is not None:
        # the mesh grid carries its own cell attribute under a name
        # other than cell_tag_name (e.g. emimesh writes "mesh"): better
        # the present tags than silently-zero ones — but only adopt
        # integer-typed data (a float quality/partition field is NOT a
        # tag array), and say which attribute was adopted
        if np.issubdtype(np.asarray(cvals0).dtype, np.integer):
            warnings.warn(
                f"no '{cell_tag_name}' attribute; adopting the mesh "
                f"grid's integer cell attribute as subdomain tags",
                RuntimeWarning, stacklevel=2)
            cell_tags = np.asarray(cvals0, np.int32)

    if tt0 == "hexahedron":
        # reference idealized 3-D meshes are dolfinx box hexes
        # (make_mesh_3D.py:99-102): split to face-consistent Kuhn tets
        # so the P1-tet pipeline ingests them unmodified
        tet_cells, parent = split_hex_cells(cells)
        mesh = Mesh(points=points, cells=tet_cells.astype(np.int32),
                    cell_tags=cell_tags[parent])
        if facet_ents is not None:
            mesh.facet_tags = quad_facet_tags_to_tris(
                mesh, facet_ents, facet_vals
            )
        return mesh

    mesh = Mesh(points=points, cells=cells.astype(np.int32),
                cell_tags=cell_tags)
    if facet_ents is not None:
        # map tagged facet entities onto the mesh's facet enumeration
        idx = _match_rows(facet_ents, mesh.facets.astype(np.int64))
        tags = np.zeros(mesh.n_facets, np.int32)
        tags[idx] = facet_vals
        mesh.facet_tags = tags
    return mesh


def _match_rows(rows, table):
    """For each row of `rows` (sorted tuples), its index in `table` (sorted
    tuples); vectorized via lexicographic void views."""
    def view(a):
        a = np.ascontiguousarray(a, dtype=np.int64)
        return a.view([("", a.dtype)] * a.shape[1]).ravel()

    tv = view(table)
    rv = view(rows)
    order = np.argsort(tv)
    pos = np.searchsorted(tv[order], rv)
    idx = order[pos]
    if not (tv[idx] == rv).all():
        raise ValueError("entities not found in mesh facet table")
    return idx


class TimeSeriesWriter:
    """Per-step field output on a submesh (the analog of the reference's
    per-subdomain XDMFFile + write_function, run_2D.py:40-77)."""

    def __init__(self, path: str, points: np.ndarray, cells: np.ndarray,
                 flush_every: int = 64, resume_at: int | None = None):
        """``resume_at=k`` reopens an existing series in append mode and
        truncates it to its first ``k`` snapshots (snapshots at index >= k
        are discarded — they postdate the checkpoint a crashed run is being
        resumed from).  The reference has no resume at all (SURVEY.md §5);
        this supports driver-level ``--resume`` on multi-hour campaigns."""
        import h5py

        self.path = str(path)
        self.h5path = _h5_path(self.path)
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        self.points = np.asarray(points)
        self.cells = np.asarray(cells)
        self.steps = []  # (time, {name: dset})
        if resume_at is not None and os.path.exists(self.h5path):
            self.h5 = h5py.File(self.h5path, "a")
            self._truncate_to(int(resume_at))
        else:
            self.h5 = h5py.File(self.h5path, "w")
            self.h5["/Mesh/geometry"] = self.points
            self.h5["/Mesh/topology"] = self.cells.astype(np.int64)
        # RAM-buffered writes: per-call h5 dataset creation costs ~ms of
        # HDF5 metadata work per field (measured ~23 ms/step on the
        # flagship's 21 fields); buffer and flush in batches instead
        self._pending = []  # (index, time, {name: array})
        self._flush_every = int(flush_every)

    def _truncate_to(self, keep: int):
        """Rebuild ``self.steps`` from the first ``keep`` flushed snapshots
        of an existing h5 file and delete everything after them."""
        times = self.h5.get("Time")
        have = 0
        if times is not None:  # contiguous flushed prefix
            while str(have) in times:
                have += 1
        keep = min(keep, have)
        names = list(self.h5["Function"].keys()) if "Function" in self.h5 else []
        for i in range(keep):
            entry = {
                name: f"/Function/{name}/{i}" for name in names
                if str(i) in self.h5[f"/Function/{name}"]
            }
            self.steps.append((float(self.h5[f"/Time/{i}"][()]), entry))
        # drop any post-checkpoint snapshots
        for i in range(keep, max(have, keep)):
            del self.h5[f"/Time/{i}"]
        for name in names:
            grp = self.h5[f"/Function/{name}"]
            for idx in [k for k in grp.keys() if int(k) >= keep]:
                del grp[idx]

    def write(self, t: float, fields: Dict[str, np.ndarray]):
        i = len(self.steps)
        entry = {name: f"/Function/{name}/{i}" for name in fields}
        self._pending.append(
            (i, {name: np.asarray(arr).copy() for name, arr in fields.items()})
        )
        self.steps.append((float(t), entry))
        if len(self._pending) >= self._flush_every:
            self._flush()

    def _flush(self):
        for i, fields in self._pending:
            for name, arr in fields.items():
                self.h5[f"/Function/{name}/{i}"] = arr
            # per-snapshot time in the h5 itself (the XML index is only
            # written at close): lets a crashed run's series be reopened
            self.h5[f"/Time/{i}"] = self.steps[i][0]
        self._pending = []
        self.h5.flush()

    def close(self):
        self._flush()
        h5rel = os.path.basename(self.h5path)
        nv = self.cells.shape[1]
        dim = self.points.shape[1]
        root = ET.Element("Xdmf", Version="3.0")
        dom = ET.SubElement(root, "Domain")
        tgrid = ET.SubElement(
            dom, "Grid", Name="TimeSeries", GridType="Collection",
            CollectionType="Temporal",
        )
        for i, (t, entry) in enumerate(self.steps):
            grid = ET.SubElement(tgrid, "Grid", Name=f"t{i}", GridType="Uniform")
            ET.SubElement(grid, "Time", Value=repr(t))
            topo = ET.SubElement(
                grid, "Topology", TopologyType=_TOPO_NAME[nv],
                NumberOfElements=str(len(self.cells)), NodesPerElement=str(nv),
            )
            di = ET.SubElement(
                topo, "DataItem",
                Dimensions=f"{len(self.cells)} {nv}", Format="HDF",
                NumberType="Int", Precision="8",
            )
            di.text = f"{h5rel}:/Mesh/topology"
            geo = ET.SubElement(
                grid, "Geometry", GeometryType="XY" if dim == 2 else "XYZ"
            )
            di = ET.SubElement(
                geo, "DataItem", Dimensions=f"{len(self.points)} {dim}",
                Format="HDF", NumberType="Float", Precision="8",
            )
            di.text = f"{h5rel}:/Mesh/geometry"
            for name, key in entry.items():
                attr = ET.SubElement(
                    grid, "Attribute", Name=name, AttributeType="Scalar",
                    Center="Node",
                )
                di = ET.SubElement(
                    attr, "DataItem", Dimensions=str(len(self.points)),
                    Format="HDF", NumberType="Float", Precision="8",
                )
                di.text = f"{h5rel}:{key}"
        ET.ElementTree(root).write(self.path, xml_declaration=True)
        self.h5.close()
