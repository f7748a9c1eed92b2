"""The benchmark scenario: ECS + one glial cell whose membrane is split into
three tagged membranes (5, 6, 7), each with its own Kir model.

    python -m knpemi_tpu_torch.drivers.run_benchmark [--resolution 0] \\
        [--Tstop MS] [--direct] [--mesh FILE.xdmf] [--outdir DIR] [--device cpu]

The port's counterpart of ``examples/benchmark/run_stim_duration.py``
(``sim.build_two_cell``): mV / ms / cm units, dt 0.1 ms, a box source
injecting K+ and removing Na+ in the ECS after t > 0.2 ms, 5 ms by
default.  By default the synthetic two-cell tissue mesh; ``--mesh`` reads
a mesh with the same tags through ``io.read_mesh`` (h5py, so the CPU
only where the card's machine has no h5py).  It runs on CUDA in float32
unless ``--device cpu`` asks for the CPU, where it runs in float64.

``solve_system`` records after every step (``save_every``) fourteen probe
traces: t; Na, K, Cl and phi at the ECS dof nearest the source box's
centre and at the ICS dof nearest the cell's centroid; phi_M at the
membrane-5 dof nearest that ICS dof; and the two-sided traces of K and
Na at that membrane dof.  With an output directory it writes
``traces.npz`` and ``phi_M.txt``, ``K_ECS.txt``, ``K_ICS.txt``,
``Na_ECS.txt``, ``Na_ICS.txt``.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..sim.scenarios import build_two_cell
from ..systems.types import resolve_device

TRACE_KEYS = ("t", "Na_e", "K_e", "Cl_e", "phi_e", "Na_i", "K_i", "Cl_i",
              "phi_i", "phi_M", "tr_K_e", "tr_K_i", "tr_Na_e", "tr_Na_i")
# the text exports: file name, trace
TXT_EXPORTS = (("phi_M", "phi_M"), ("K_ECS", "K_e"), ("K_ICS", "K_i"),
               ("Na_ECS", "Na_e"), ("Na_ICS", "Na_i"))


def build_simulation(resolution: int = 0, direct: bool = False, f_value: float = 500.0,
                     mesh=None, device=None, solver_options=None):
    """The scenario on ``device`` (None: CUDA): float32 on the card,
    float64 on the CPU."""
    device = resolve_device(device)
    dtype = torch.float32 if device.type == "cuda" else torch.float64
    return build_two_cell(resolution, f_value=f_value, mesh=mesh, dtype=dtype,
                          device=device, direct=direct, solver_options=solver_options)


def _probe_points(sim):
    """(ECS dof nearest the source box's centre, ICS dof nearest the cell's
    centroid, membrane-5 dof nearest that ICS dof)."""
    ecs = sim.geom.subdomains[0]
    ics = sim.geom.subdomains[1]
    mem = sim.geom.membranes[5]
    box_c = np.array([2500e-7, 2500e-7, 2300e-7])[: ecs.coords.shape[1]]
    p_e = int(np.argmin(((ecs.coords - box_c) ** 2).sum(axis=1)))
    cen = ics.coords.mean(axis=0)
    p_i = int(np.argmin(((ics.coords - cen) ** 2).sum(axis=1)))
    p_m = int(np.argmin(((mem.coords - ics.coords[p_i]) ** 2).sum(axis=1)))
    return p_e, p_i, p_m


def solve_system(resolution: int = 0, Tstop: float = 5.0, direct: bool = False,
                 verbose: bool = True, outdir: Optional[str] = None, save_every: int = 1,
                 mesh=None, device=None, sim=None):
    """Run the scenario to ``Tstop`` (ms).  ``sim``: a simulation built by
    the caller (:func:`build_simulation`), else one is built on
    ``device``.  Returns (state, emi_iters[], knp_iters[], traces)."""
    if sim is None:
        sim = build_simulation(resolution, direct=direct, mesh=mesh, device=device)
    state = sim.init_state()
    n_steps = int(round(Tstop / sim.params.dt))
    ion_idx = {ion.name: k for k, ion in enumerate(sim.ions)}
    p_e, p_i, p_m = _probe_points(sim)
    mem = sim.geom.membranes[5]
    m2e, m2i = int(mem.mem_to_ecs[p_m]), int(mem.mem_to_ics[p_m])
    traces = {k: [] for k in TRACE_KEYS}

    def observer(s):
        # s is a host copy: one transfer per chunk for every probe
        traces["t"].append(float(s.t))
        for name in ("Na", "K", "Cl"):
            traces[f"{name}_e"].append(float(s.c[0][ion_idx[name], p_e]))
            traces[f"{name}_i"].append(float(s.c[1][ion_idx[name], p_i]))
        traces["phi_e"].append(float(s.phi[0][p_e]))
        traces["phi_i"].append(float(s.phi[1][p_i]))
        traces["phi_M"].append(float(s.phi_M[5][p_m]))
        # two-sided membrane traces, for the Nernst potentials
        for name in ("K", "Na"):
            k = ion_idx[name]
            traces[f"tr_{name}_e"].append(float(s.c[0][k, m2e]))
            traces[f"tr_{name}_i"].append(float(s.c[1][k, m2i]))

    t0 = time.perf_counter()
    state, it_emi, it_knp, _ = sim.run(state, n_steps, save_every=save_every,
                                       observer=observer, verbose=verbose)
    wall = time.perf_counter() - t0
    if verbose:
        print(f"{n_steps} steps in {wall:.1f}s; avg it emi {it_emi.mean():.1f} "
              f"knp {it_knp.mean():.1f}")
        for m in sorted(sim.geom.membranes):
            pm = state.phi_M[m]
            print(f"  membrane {m}: phi_M in [{float(pm.min()):.2f}, "
                  f"{float(pm.max()):.2f}] mV")
        print(f"  K_e in [{float(state.c[0][0].min()):.2f}, "
              f"{float(state.c[0][0].max()):.2f}] mM")
    if outdir:
        out = Path(outdir)
        out.mkdir(parents=True, exist_ok=True)
        np.savez(out / "traces.npz", **{k: np.asarray(v) for k, v in traces.items()})
        for fname, key in TXT_EXPORTS:
            np.savetxt(out / f"{fname}.txt", np.asarray(traces[key]), fmt="%.10f")
        if verbose:
            print(f"wrote {out}/traces.npz (+txt exports)")
    return state, it_emi, it_knp, traces


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--resolution", type=int, default=0)
    ap.add_argument("--Tstop", type=float, default=5.0, help="end time (ms)")
    ap.add_argument("--direct", action="store_true", help="the host LU path")
    ap.add_argument("--mesh", default=None,
                    help="an XDMF mesh with cell tags 0/1 and membranes 5/6/7 "
                    "instead of the synthetic tissue (needs h5py)")
    ap.add_argument("--outdir", default="chip_work/benchmark",
                    help="directory for traces.npz and the txt exports")
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU in float64 (default: CUDA, float32)")
    args = ap.parse_args(argv)
    mesh = None
    if args.mesh:
        from ..io import read_mesh

        mesh = read_mesh(args.mesh)
    solve_system(args.resolution, Tstop=args.Tstop, direct=args.direct,
                 outdir=args.outdir, mesh=mesh, device=args.device)


if __name__ == "__main__":
    main()
