"""The lagged EMI hierarchy under sustained stimulation, at the flagship's size.

    python -m knpemi_tpu_torch.tools.stress_mg_refresh [--mesh-n 64] \\
        [--steps 120] [--chunk 10] [--refresh-every 40] [--f-scale 4] \\
        [--duty D] [--verbose] [--device cpu] [--dtype float32|float64] \\
        [--out FILE]

The counterpart of the JAX package's ``tools/stress_mg_refresh.py``.  The
EMI hierarchy is built from the t = 0 operator; a strong, long source
drives the ECS K+ up inside the source box and moves the EMI operator's
kappa by tens of percent there.  One simulation of
``examples/astrocyte/config_files/baseline.yml`` at ``--mesh-n``, its
source strength times ``--f-scale`` (``--duty``: the pulse width as a
fraction of the period, from t = 0), runs twice from its initial state:

* stale: ``mg_refresh_every`` 0, the t = 0 hierarchy throughout;
* fresh: the hierarchy refreshed every ``--refresh-every`` steps
  (``Simulation.run``'s refresh at a chunk boundary; the refresh mode is
  ``SolverOptions.mg_refresh_async``, the worker thread by default).

The tool prints the per-chunk EMI iterations of both beside the ECS K+
maximum, and one JSON line with the JAX tool's keys (``k_e_max_final``,
``stale_it_first10``, ``stale_it_tail``, ``fresh_it_tail``: the last
three chunks, ``wall_s``), the per-chunk table, the fresh leg's
``refresh_counts``, the device, dtype and the card's line; ``--out``
writes it to a file as well.  It runs on the card (float32 by default)
unless ``--device cpu`` asks for the CPU (float64 by default).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import torch

from . import card_line
from ..drivers.run_stim_duration import CONFIG_DIR, build_simulation
from ..sim.config import load_config, pulsed_source_gate

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def stress_config(config: dict, f_scale: float = 4.0, duty: float | None = None) -> dict:
    """``config`` with its source strength times ``f_scale``, the pulse
    width ``duty`` of the period from t = 0 (None: the config's), and the
    EMI refresh off (each leg sets its own)."""
    cfg = dict(config)
    cfg["f_value"] = float(cfg["f_value"]) * f_scale
    if duty is not None:
        cfg["pulse_width"] = float(cfg["period"]) * duty
        cfg["delay"] = 0.0
    cfg["solver"] = {**(cfg.get("solver") or {}), "mg_refresh_every": 0}
    return cfg


def stressed_inputs(inputs: dict, config: dict, f_scale: float = 4.0,
                    duty: float | None = None) -> dict:
    """``parallel.programs.simulation_inputs`` of a build of ``config``,
    turned into those of :func:`stress_config`'s: each ion's ECS source
    times ``f_scale`` (for a power of two the same bits as a build from
    the scaled strength) and the stressed pulse gate; no mesh or geometry
    is built."""
    ions = [dataclasses.replace(ion, f_source_q={t: f_scale * q for t, q in
                                                 ion.f_source_q.items()})
            if ion.f_source_q else ion for ion in inputs["ions"]]
    gate = pulsed_source_gate(stress_config(config, f_scale, duty))
    return {**inputs, "ions": ions, "source_gate": gate}


def stress_legs(sim, steps: int, chunk: int, refresh_every: int,
                verbose: bool = False) -> dict:
    """The stale and the fresh leg of ``sim`` from ``sim.init_state()``, the
    ECS K+ maximum read after every chunk; ``sim``'s ``mg_refresh_every``
    is restored afterwards.  Returns the record without the build's keys."""
    built = sim.opts
    legs = {}
    try:
        for name, every in (("stale", 0), ("fresh", refresh_every)):
            kmax = []
            sim.opts = dataclasses.replace(built, mg_refresh_every=every)
            before = dict(sim.refresh_counts)
            t0 = time.perf_counter()
            state, it_e, it_k, ok = sim.run(
                sim.init_state(), steps, save_every=chunk, verbose=verbose,
                observer=lambda h: kmax.append(float(h.c[0][0].max())))
            legs[name] = dict(
                it_e=it_e, it_k=it_k, ok=ok, kmax=kmax, wall=time.perf_counter() - t0,
                finite=all(bool(torch.isfinite(v).all()) for v in
                           (*state.c.values(), *state.phi_M.values())),
                refresh_counts={k: sim.refresh_counts[k] - before[k] for k in before})
    finally:
        sim.opts = built
    stale, fresh = legs["stale"], legs["fresh"]
    chunks = []
    for i in range(len(stale["it_e"]) // chunk):
        s = slice(i * chunk, (i + 1) * chunk)
        chunks.append(dict(
            steps=[i * chunk + 1, (i + 1) * chunk],
            k_e_max_stale=stale["kmax"][i], k_e_max_fresh=fresh["kmax"][i],
            stale_it=float(stale["it_e"][s].mean()), fresh_it=float(fresh["it_e"][s].mean()),
            stale_knp_it=float(stale["it_k"][s].mean()),
            fresh_knp_it=float(fresh["it_k"][s].mean())))
    tail = slice(-3 * chunk, None)  # the last three chunks: the excursion's peak
    dev = sim.device
    rec = {
        "metric": "mg_refresh_stress",
        "dofs": int(sim.geom.emi_size),
        "steps": steps,
        "k_e_max_final": stale["kmax"][-1] if stale["kmax"] else None,
        "stale_it_first10": float(stale["it_e"][:10].mean()),
        "stale_it_tail": float(stale["it_e"][tail].mean()),
        "fresh_it_tail": float(fresh["it_e"][tail].mean()),
        "refresh_every": refresh_every,
        "wall_s": [stale["wall"], fresh["wall"]],
        "chunk": chunk,
        "chunks": chunks,
        "refresh_counts": fresh["refresh_counts"],
        "mg_refresh_async": built.mg_refresh_async,
        "converged": {k: bool(v["ok"].all()) for k, v in legs.items()},
        "finite": {k: v["finite"] for k, v in legs.items()},
        "emi_iters": {k: v["it_e"].tolist() for k, v in legs.items()},
        "knp_iters": {k: v["it_k"].tolist() for k, v in legs.items()},
        "device": str(dev),
        "dtype": str(sim.dtype).replace("torch.", ""),
        "nvidia_smi": card_line(dev),
    }
    if dev.type == "cuda":
        rec["peak_device_bytes"] = torch.cuda.max_memory_allocated(dev)
    return rec


def stress(config: dict, steps: int, chunk: int, refresh_every: int, f_scale: float = 4.0,
           duty: float | None = None, device=None, dtype=None, verbose: bool = False) -> dict:
    """Build :func:`stress_config` of ``config`` (``config['solver']``: more
    ``SolverOptions`` fields, e.g. ``mg_refresh_async``) on ``device``
    (None: CUDA) in ``dtype`` and run :func:`stress_legs`."""
    cfg = stress_config(config, f_scale, duty)
    t0 = time.perf_counter()
    sim = build_simulation(cfg, device, dtype)
    setup = time.perf_counter() - t0
    print(f"# built: {sim.geom.emi_size} EMI dofs, setup {setup:.0f}s", file=sys.stderr)
    if sim.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(sim.device)
    rec = stress_legs(sim, steps, chunk, refresh_every, verbose)
    rec.update(f_value=cfg["f_value"], f_scale=f_scale, duty=duty, setup_seconds=setup)
    return rec


def print_table(rec: dict) -> None:
    print(f"{'steps':>12} {'K_e max':>8} {'stale it':>9} {'fresh it':>9}")
    for c in rec["chunks"]:
        a, b = c["steps"]
        print(f"{a:>5}..{b:<5} {c['k_e_max_stale']:>8.2f} {c['stale_it']:>9.1f} "
              f"{c['fresh_it']:>9.1f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh-n", type=int, default=64,
                    help="cells per axis of the tissue mesh (64: 840,015 dofs)")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--chunk", type=int, default=10)
    ap.add_argument("--refresh-every", type=int, default=40)
    ap.add_argument("--f-scale", type=float, default=4.0,
                    help="multiplier on the baseline source strength")
    ap.add_argument("--duty", type=float, default=None,
                    help="the source's duty cycle (1.0: always on; default: the config's "
                         "1 ms in 10, between whose pulses K_e decays back)")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--device", default=None, help="cpu to run on the CPU (default: CUDA)")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default=None,
                    help="default: float32 on the card, float64 on the CPU")
    ap.add_argument("--out", default=None, help="write the JSON record here too")
    args = ap.parse_args(argv)
    cfg = load_config(CONFIG_DIR / "baseline.yml")
    cfg["mesh_n"] = args.mesh_n
    rec = stress(cfg, args.steps, args.chunk, args.refresh_every, args.f_scale, args.duty,
                 args.device, DTYPES.get(args.dtype), args.verbose)
    rec.update(mesh_n=args.mesh_n,
               command=" ".join(["python -m knpemi_tpu_torch.tools.stress_mg_refresh",
                                 *(argv if argv is not None else sys.argv[1:])]))
    print_table(rec)
    print(json.dumps(rec), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rec, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
