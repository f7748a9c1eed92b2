"""ROI probe coordinates for the astrocyte figures.

    python -m knpemi_tpu_torch.tools.find_roi_points [MESH.xdmf] \\
        [--resolution 0] [--roi XL YL ZL XU YU ZU]

The counterpart of ``examples/astrocyte/tools/find_roi_points.py``: for
each membrane and subdomain, the median in-ROI dof and its +-5
neighbours (``mesh.find_roi_points``), printed in the reference's
``x_M = ...`` format.  The ROI defaults to the baseline config's source
box (cm).  Host only.
"""

from __future__ import annotations

import argparse

from ..mesh.tissue import astrocyte_tissue_mesh, find_roi_points
from ..ops.geometry import build_geometry


def print_points(points, domain, prefix):
    for p in points:
        print(f"Coordinates of point in {domain}")
        for ax, v in zip("xyz", p):
            print(f"{ax}_{prefix} = {v}")
        print("-----------------------------------")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mesh", nargs="?", default=None,
                    help="remarked XDMF mesh (default: the synthetic tissue)")
    ap.add_argument("--resolution", type=int, default=0)
    ap.add_argument("--roi", type=float, nargs=6,
                    default=[2100e-7, 2100e-7, 2100e-7, 2900e-7, 2900e-7, 2500e-7],
                    metavar=("XL", "YL", "ZL", "XU", "YU", "ZU"))
    args = ap.parse_args(argv)
    if args.mesh:
        from ..io import read_mesh

        mesh = read_mesh(args.mesh)
    else:
        mesh = astrocyte_tissue_mesh(args.resolution)
    geom = build_geometry(mesh)
    lo, hi = args.roi[:geom.dim], args.roi[3:3 + geom.dim]
    names = {0: "ECS", **{t: f"ICS cell {t}" for t in geom.cell_tags_list}}
    for mtag, mem in sorted(geom.membranes.items()):
        try:
            pts = find_roi_points(mem.coords, lo, hi)
        except ValueError:
            print(f"(membrane {mtag}: no dofs in ROI)")
            continue
        print_points(pts, f"membrane {mtag} (cell {mem.cell_tag})", "M")
    for t, sub in sorted(geom.subdomains.items()):
        try:
            pts = find_roi_points(sub.coords, lo, hi)
        except ValueError:
            print(f"({names[t]}: no dofs in ROI)")
            continue
        print_points(pts, names[t], "e" if t == 0 else "i")


if __name__ == "__main__":
    main()
