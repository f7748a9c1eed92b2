"""The local ECS width around a cell membrane.

    python -m knpemi_tpu_torch.tools.compute_local_width [--mesh FILE.xdmf] \\
        [--tags 1 2]

The counterpart of ``examples/astrocyte/tools/compute_local_width.py``:
for each membrane dof of cell ``tag_a``, the distance to the nearest
membrane dof of cell ``tag_b`` (scipy's ``cKDTree``), on a remarked
emimesh XDMF file (``io.read_mesh``, needs h5py) or, without one, the
synthetic astrocyte tissue mesh at resolution 0.  Host only.
"""

from __future__ import annotations

import argparse

import numpy as np
from scipy.spatial import cKDTree


def local_ecs_width(geom, tag_a: int, tag_b: int) -> np.ndarray:
    """Distance from each membrane dof of cell ``tag_a`` to the nearest
    membrane dof of cell ``tag_b`` (cm)."""
    d, _ = cKDTree(geom.membranes[tag_b].coords).query(geom.membranes[tag_a].coords)
    return d


def main(argv=None) -> np.ndarray:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh", default=None, help="remarked emimesh XDMF")
    ap.add_argument("--tags", type=int, nargs=2, default=[1, 2])
    args = ap.parse_args(argv)
    from ..ops.geometry import build_geometry

    if args.mesh:
        from ..io import read_mesh

        mesh = read_mesh(args.mesh)
    else:
        from ..mesh.tissue import astrocyte_tissue_mesh

        mesh = astrocyte_tissue_mesh(0)
    d = local_ecs_width(build_geometry(mesh), *args.tags)
    print(f"ECS width between membranes {args.tags}: min {d.min():.3e} cm, "
          f"median {np.median(d):.3e} cm, max {d.max():.3e} cm")
    return d


if __name__ == "__main__":
    main()
