"""A synthetic tissue mesh in emimesh conventions, for the ``mesh_file`` path.

    python -m knpemi_tpu_torch.tools.make_synthetic_emimesh [--n 16] \\
        [--L 4000] [--out results/emimesh/mesh.xdmf]

The counterpart of ``examples/astrocyte/tools/make_synthetic_emimesh.py``:
a (L nm)^3 box in the conventions of the reference's emimesh
reconstructions (remark_mesh.py:91-150): coordinates in nm, ECS cells
tagged 1, a neuron strip 7 and a glial strip 100, membrane facets tagged
by the owning cell's tag, exterior facets 200.  Written as XDMF
(``io.write_mesh``, which needs h5py and raises without it) with the cell
tags named ``mesh`` and the facet tags ``mesh_facets``; the astrocyte
scenario's config then reads it with ``mesh_file`` and converts it with ``remark``
(``mesh.remark_emimesh``).  Host only.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..mesh.core import Mesh
from ..mesh.generators import _structured_tets, _tag_cells_in_boxes

CELL_TAGS, FACET_TAGS = "mesh", "mesh_facets"


def synthetic_emimesh(n: int = 16, L: float = 4000.0) -> Mesh:
    """(L nm)^3 ECS box with a neuron strip (emimesh tag 7) and a glial
    strip (tag 100), the two-cell tissue's topology."""
    points, cells = _structured_tets(n, n, n, (0, 0, 0), (L, L, L))
    w = L / 8.0
    boxes = [
        ((L / 8, 2 * w, 2 * w), (7 * L / 8, 3 * w, 3 * w), 7),
        ((L / 8, 5 * w, 5 * w), (7 * L / 8, 6 * w, 6 * w), 100),
    ]
    tags = _tag_cells_in_boxes(points, cells, boxes)
    tags[tags == 0] = 1  # the emimesh ECS tag
    mesh = Mesh(points=points, cells=cells, cell_tags=tags)
    ft = np.zeros(mesh.n_facets, np.int32)
    for tag in (7, 100):
        ft[mesh.interface_facet_mask(1, tag)] = tag
    ft[mesh.exterior_facet_mask()] = 200
    mesh.facet_tags = ft
    return mesh


def main(argv=None) -> Mesh:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=16, help="cells per axis")
    ap.add_argument("--L", type=float, default=4000.0, help="edge (nm)")
    ap.add_argument("--out", default="results/emimesh/mesh.xdmf")
    args = ap.parse_args(argv)
    from ..io import write_mesh

    mesh = synthetic_emimesh(args.n, args.L)
    write_mesh(Path(args.out), mesh, cell_tag_name=CELL_TAGS, facet_tag_name=FACET_TAGS)
    counts = {int(t): int((mesh.cell_tags == t).sum()) for t in np.unique(mesh.cell_tags)}
    print(f"wrote {args.out}: {mesh.n_cells} cells, tags {counts}, "
          f"{int((mesh.facet_tags > 0).sum())} tagged facets")
    return mesh


if __name__ == "__main__":
    main()
