"""Local astrocyte depolarization: the flagship scenario, with checkpoints.

    python -m knpemi_tpu_torch.drivers.run_stim_duration -c baseline \\
        [--outdir chip_work] [--Tstop MS] [--resume] [--device cpu]

The port's counterpart of ``examples/astrocyte/run_stim_duration.py``:
ECS(0) + neuron(1, ``hh_mv``) + glial(2, Kir) (``sim.build_astrocyte``,
``config['solver']`` over that script's solver defaults), a pulsed ECS
K+/Na- source, YAML-configured with the same keys.  ``-c`` takes a config
name under ``examples/astrocyte/config_files/`` or a path.  It runs on
CUDA in float32 unless ``--device cpu`` asks for the CPU, where it runs
in float64 (the JAX script's "float32 on its accelerator, float64
elsewhere").

``solve_system`` writes, under ``<outdir>/<fname>/``: traces every
``save_frequency`` steps (t, mean phi_M of the neuron and the glial
cell, max and min ECS K+), an XDMF series per subdomain with a frame
every ``save_frequency_fields`` observer calls, and every
``checkpoint_every`` steps an atomic ``ckpt.npz`` (the complete state,
the number of observer calls ``n_saves`` and the traces) with one
rotation ``ckpt_prev.npz``; at the end ``final_state.npz`` and
``traces.npz``.  ``--resume`` continues from ``ckpt.npz``: the state is
reloaded, the EMI hierarchy refreshed from it when ``mg_refresh_every``
is on (with refreshes off, a resumed run and an uninterrupted one share
the set-up hierarchy and agree bit for bit), the series reopened and cut
to the frames the checkpoint had, and a finished run is left as it is.
Where h5py is not installed, no XDMF series is written (a warning says
so); traces and checkpoints are, and a resume continues as above.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import time
import warnings
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..io import TimeSeriesWriter, load_checkpoint, save_checkpoint
from ..sim.config import load_config
from ..sim.scenarios import build_astrocyte
from ..systems.types import resolve_device

CONFIG_DIR = Path(__file__).resolve().parents[2] / "examples" / "astrocyte" / "config_files"
TRACE_KEYS = ("t", "phi_M_neuron", "phi_M_glial", "K_e_max", "K_e_min")


def build_simulation(config: dict, device=None, dtype=None):
    """The scenario of ``config`` on ``device`` (None: CUDA) in ``dtype``
    (None: float32 on the card, float64 on the CPU)."""
    device = resolve_device(device)
    if dtype is None:
        dtype = torch.float32 if device.type == "cuda" else torch.float64
    return build_astrocyte(config, dtype=dtype, device=device)


def solve_system(config: dict, verbose: bool = True, outdir: Optional[str] = None,
                 resume: bool = False, device=None, sim=None):
    """Run the scenario to ``config['Tstop']`` (ms) or, with ``resume``,
    continue it from ``<outdir>/<fname>/ckpt.npz``.  ``sim``: a simulation
    of ``config`` built by the caller, else one is built on ``device`` by
    :func:`build_simulation`'s rule (``sim=build_simulation(config, device,
    torch.float64)`` runs the scenario in float64 on the card).  Returns
    (state, traces, emi_iters[],
    knp_iters[]) of the steps this call ran (a resumed finished run:
    none)."""
    t0 = time.perf_counter()
    if sim is None:
        sim = build_simulation(config, device)
    dt = sim.params.dt
    n_steps_total = int(round(float(config["Tstop"]) / dt))
    save_every = int(config.get("save_frequency", 5))
    field_stride = max(1, int(config.get("save_frequency_fields", 1)))
    ckpt_every = int(config.get("checkpoint_every", 0))

    out = Path(outdir) / str(config.get("fname", "astrocyte")) if outdir else None
    ckpt_path = out / "ckpt.npz" if out else None

    traces = {k: [] for k in TRACE_KEYS}
    n_saves = 0
    if resume:
        if ckpt_path is None or not ckpt_path.exists():
            raise SystemExit(f"--resume: no checkpoint at {ckpt_path}")
        state, meta = load_checkpoint(ckpt_path, device=sim.device, dtype=sim.dtype)
        n_saves = int(meta["n_saves"])
        for k in TRACE_KEYS:
            traces[k] = [float(v) for v in np.atleast_1d(meta[f"trace_{k}"])]
        if sim.opts.mg_refresh_every:
            # the lagged hierarchy from the restored concentrations
            sim.refresh_mg(state)
        if verbose:
            print(f"resumed from {ckpt_path}: step {int(state.step)}, "
                  f"t = {float(state.t):.3f} ms, {n_saves} saves")
    else:
        state = sim.init_state()

    n_steps = n_steps_total - int(state.step)
    if n_steps <= 0:
        print(f"nothing to do: checkpoint already at step {int(state.step)}"
              f" >= {n_steps_total}")
        return state, traces, np.array([]), np.array([])

    writers = {}
    if out is not None and importlib.util.find_spec("h5py") is None:
        warnings.warn("h5py is not installed: no XDMF series is written; the traces "
                      "and checkpoints are", RuntimeWarning, stacklevel=2)
    elif out is not None:
        n_frames = (n_saves + field_stride - 1) // field_stride
        for tag, sub in sim.geom.subdomains.items():
            writers[tag] = TimeSeriesWriter(
                out / f"results_sub_{tag}.xdmf", sub.coords, sub.cells,
                resume_at=n_frames if resume else None)

    def observer(s):
        # s is a host copy: one transfer per chunk for all of it
        nonlocal n_saves
        traces["t"].append(float(s.t))
        traces["phi_M_neuron"].append(float(s.phi_M[1].mean()))
        traces["phi_M_glial"].append(float(s.phi_M[2].mean()))
        traces["K_e_max"].append(float(s.c[0][0].max()))
        traces["K_e_min"].append(float(s.c[0][0].min()))
        if n_saves % field_stride == 0:
            for tag, w in writers.items():
                fields = {f"phi_{tag}": s.phi[tag].numpy()}
                for k, ion in enumerate(sim.ions):
                    fields[f"c_{ion.name}_{tag}"] = s.c[tag][k].numpy()
                w.write(float(s.t), fields)
        n_saves += 1

    def write_ckpt(s):
        if ckpt_path is None:
            return
        for w in writers.values():
            w._flush()  # the h5 holds every frame the checkpoint counts
        tmp = ckpt_path.with_name("ckpt_tmp.npz")
        save_checkpoint(tmp, s, n_saves=n_saves,
                        **{f"trace_{k}": np.asarray(v) for k, v in traces.items()})
        if ckpt_path.exists():  # one rotation against a torn write
            os.replace(ckpt_path, ckpt_path.with_name("ckpt_prev.npz"))
        os.replace(tmp, ckpt_path)
        if verbose:
            print(f"  checkpoint @ step {int(s.step)} (t = {float(s.t):.1f} ms) "
                  f"-> {ckpt_path}")

    t1 = time.perf_counter()
    if verbose:
        print(f"set-up {t1 - t0:.1f}s ({sim.dtype}, {sim.device})")
    state, it_emi, it_knp, _ = sim.run(
        state, n_steps, save_every=save_every, observer=observer, verbose=verbose,
        checkpoint_every=ckpt_every, checkpoint_cb=write_ckpt)
    wall = time.perf_counter() - t1
    if verbose:
        print(f"{n_steps} steps in {wall:.1f}s ({wall / n_steps * 1e3:.1f} ms/step); "
              f"avg it emi {it_emi.mean():.1f} knp {it_knp.mean():.1f}")
        print(f"refreshes {sim.refresh_counts}")
        if sim.device.type == "cuda":
            print(f"peak device memory {torch.cuda.max_memory_allocated(sim.device) / 2**30:.3f} GiB")
    if out is not None:
        write_ckpt(state)  # a finished run's checkpoint resumes to a no-op
    for w in writers.values():
        w.close()
    if out is not None:
        save_checkpoint(out / "final_state.npz", state)
        np.savez(out / "traces.npz", **{k: np.asarray(v) for k, v in traces.items()})
    return state, traces, it_emi, it_knp


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("-c", metavar="config", default="baseline",
                        help="config name under examples/astrocyte/config_files/ or a path")
    parser.add_argument("--outdir", default="chip_work",
                        help="where <fname>/ goes (default chip_work, which git ignores; "
                        "the tracked results/ holds the JAX package's runs)")
    parser.add_argument("--Tstop", type=float, default=None,
                        help="override the config's Tstop (ms)")
    parser.add_argument("--resume", action="store_true",
                        help="continue from <outdir>/<fname>/ckpt.npz")
    parser.add_argument("--device", default=None,
                        help="cpu to run on the CPU in float64 (default: CUDA, float32)")
    args = parser.parse_args(argv)
    cfg_path = Path(args.c)
    if not cfg_path.exists():
        cfg_path = CONFIG_DIR / f"{args.c}.yml"
    config = load_config(cfg_path)
    if args.Tstop is not None:
        config["Tstop"] = args.Tstop
    solve_system(config, outdir=args.outdir, resume=args.resume, device=args.device)


if __name__ == "__main__":
    main()
