"""Post-hoc field probing from saved XDMF/HDF5 time series.

A numpy/scipy/h5py copy of ``knpemi_tpu/io/probe.py``: open a series
written by :class:`~knpemi_tpu_torch.io.xdmf.TimeSeriesWriter` (or by the
JAX package's), pick any points, get (n_times, n_points) traces of a
P1 field without a re-run.  ``locate_points`` finds the simplex of each
point (a k-d tree of cell centroids, barycentric weights; a point
outside every candidate takes its nearest cell's clipped weights),
``evaluate_p1`` interpolates a nodal field there.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

import numpy as np


def locate_points(points: np.ndarray, cells: np.ndarray, query: np.ndarray,
                  k_candidates: int = 32):
    """Find the simplex containing each query point (host numpy).

    Returns (cell_ids, bary) with bary the P1 barycentric weights
    (n_query, nodes_per_cell); points outside the mesh fall back to the
    nearest cell with weights clipped/renormalized (matching
    scifem.evaluate_function's closest-cell behavior for boundary
    roundoff).
    """
    from scipy.spatial import cKDTree

    points = np.asarray(points, float)
    cells = np.asarray(cells)
    query = np.atleast_2d(np.asarray(query, float))
    dim = points.shape[1]
    nv = cells.shape[1]
    assert nv == dim + 1, "locate_points expects simplex cells"
    cent = points[cells].mean(axis=1)
    tree = cKDTree(cent)
    kq = min(k_candidates, len(cells))
    _, cand = tree.query(query, k=kq)
    cand = cand.reshape(len(query), kq)

    found = np.full(len(query), -1, np.int64)
    bary = np.zeros((len(query), nv))
    best_def = np.full(len(query), np.inf)  # fallback: least-negative bary
    best_cell = np.zeros(len(query), np.int64)
    best_bar = np.zeros((len(query), nv))
    for ci in range(kq):
        rem = found < 0
        if not rem.any():
            break
        rows = np.flatnonzero(rem)
        c = cand[rows, ci]
        verts = points[cells[c]]  # (m, nv, dim)
        p0 = verts[:, 0]
        T = np.moveaxis(verts[:, 1:] - p0[:, None], 1, 2)  # (m, dim, dim)
        rhs = query[rows] - p0
        lam = np.linalg.solve(T, rhs[..., None])[..., 0]  # (m, dim)
        lam0 = 1.0 - lam.sum(axis=1)
        full = np.concatenate([lam0[:, None], lam], axis=1)  # (m, nv)
        deficit = np.maximum(-full.min(axis=1), 0.0)
        inside = deficit <= 1e-10
        hit = rows[inside]
        found[hit] = c[inside]
        bary[hit] = full[inside]
        better = deficit < best_def[rows]
        bi = rows[better]
        best_def[bi] = deficit[better]
        best_cell[bi] = c[better]
        best_bar[bi] = full[better]
    miss = found < 0
    if miss.any():
        found[miss] = best_cell[miss]
        b = np.clip(best_bar[miss], 0.0, None)
        bary[miss] = b / b.sum(axis=1, keepdims=True)
    return found, bary


def evaluate_p1(points, cells, values, query):
    """Evaluate a P1 nodal field at arbitrary points: values may be
    (n_dofs,) or (..., n_dofs); returns (...,) + (n_query,)."""
    cell_ids, bary = locate_points(points, cells, query)
    idx = cells[cell_ids]  # (nq, nv)
    vals = np.asarray(values)[..., idx]  # (..., nq, nv)
    return np.einsum("...qk,qk->...q", vals, bary)


class TimeSeriesReader:
    """Reader for XDMF time series written by ``TimeSeriesWriter``.

    >>> r = TimeSeriesReader("results/baseline/fields_0.xdmf")
    >>> r.times, r.fields
    >>> trace = r.evaluate("c_K", [[1e-4, 2e-4, 3e-4]])  # (n_times, 1)
    """

    def __init__(self, path: str):
        import h5py

        self.path = str(path)
        tree = ET.parse(self.path)
        grids = tree.getroot().findall(".//Grid[@GridType='Uniform']")
        self.times: List[float] = []
        self._entries: List[Dict[str, str]] = []
        h5file = None
        for g in grids:
            t = float(g.find("Time").get("Value"))
            entry = {}
            for attr in g.findall("Attribute"):
                txt = attr.find("DataItem").text.strip()
                h5file, key = txt.split(":", 1)
                entry[attr.get("Name")] = key
            self.times.append(t)
            self._entries.append(entry)
        h5path = os.path.join(os.path.dirname(os.path.abspath(self.path)),
                              h5file)
        self.h5 = h5py.File(h5path, "r")
        self.points = np.asarray(self.h5["/Mesh/geometry"])
        self.cells = np.asarray(self.h5["/Mesh/topology"])
        self._loc_cache: Dict[bytes, tuple] = {}

    @property
    def fields(self) -> List[str]:
        return sorted(self._entries[0]) if self._entries else []

    def read(self, name: str, step: Optional[int] = None,
             time: Optional[float] = None) -> np.ndarray:
        """Nodal values of ``name`` at a step index or the nearest saved
        time (the read_function(name, time) analog)."""
        if step is None:
            step = (
                int(np.argmin(np.abs(np.asarray(self.times) - time)))
                if time is not None else len(self.times) - 1
            )
        return np.asarray(self.h5[self._entries[step][name]])

    def series(self, name: str) -> np.ndarray:
        """(n_times, n_dofs) array of every saved step of ``name``."""
        return np.stack([self.read(name, step=i)
                         for i in range(len(self.times))])

    def evaluate(self, name: str, query, step: Optional[int] = None):
        """Point-evaluate ``name`` at arbitrary coordinates.

        With ``step=None``: full traces, (n_times, n_query); otherwise
        (n_query,) at that step.  Point location is cached per query
        set, so probing many fields at the same points is cheap.
        """
        query = np.atleast_2d(np.asarray(query, float))
        key = query.tobytes()
        if key not in self._loc_cache:
            self._loc_cache[key] = locate_points(
                self.points, self.cells, query
            )
        cell_ids, bary = self._loc_cache[key]
        idx = self.cells[cell_ids]

        def ev(vals):
            return np.einsum("qk,qk->q", vals[idx], bary)

        if step is not None:
            return ev(self.read(name, step=step))
        return np.stack([ev(self.read(name, step=i))
                         for i in range(len(self.times))])

    def close(self):
        self.h5.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
