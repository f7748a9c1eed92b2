"""Field-level gate for tuned solver options on the flagship scenario.

    python -m knpemi_tpu_torch.tools.compare_solver_opts [--mesh-n 64] \\
        [--steps 100] [--chunk 10] [--min-iter 2] [--restart 8] [--tol 1e-5] \\
        [--rtol-knp R] [--rtol-emi R] [--knp-post-smooth on|off] \\
        [--device cpu] [--dtype float32|float64] [--out FILE]

The counterpart of the JAX package's ``tools/compare_solver_opts.py``.
The astrocyte flagship (``examples/astrocyte/config_files/baseline.yml``
at ``--mesh-n``, built by ``drivers/run_stim_duration.py``'s
``build_simulation`` with the EMI hierarchy refresh pinned off, so that
both legs see the same preconditioner) runs twice from one state: the
reference-parity options (KNP ``min_iter`` 5, restart 30, the rtols the
simulation was built with) and the tuned ones.  Each leg runs an untimed
warm-up chunk first.  The tool prints the worst relative difference of
every field (``max|parity - tuned| / max|parity|`` of ``c[t]``,
``phi[t]``, ``phi_M[m]``), both legs' iteration counts and host-clock
ms/step, and one JSON line with the JAX tool's keys, each leg's
per-step EMI and KNP iterations, the device, dtype and the card's line;
it exits 1 where the worst difference is above ``--tol``.  ``--out``
writes the JSON to a file as well.

It runs on the card (float32 by default) unless ``--device cpu`` asks
for the CPU (float64 by default).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import card_line
from ..drivers.run_stim_duration import CONFIG_DIR, build_simulation
from ..sim.config import load_config
from ..sim.stepper import _to_host

DTYPES = {"float32": torch.float32, "float64": torch.float64}
# the reference's KNP GMRES settings (pdeSolver.py:101: ksp_min_it 5)
PARITY = dict(min_iter_knp=5, restart=30, knp_post_smooth=True)


def build(mesh_n: int, device=None, dtype=None, solver: dict | None = None):
    """The flagship of ``baseline.yml`` at ``mesh_n`` with the EMI refresh
    pinned off; ``solver``: more ``SolverOptions`` fields over the
    config's."""
    cfg = load_config(CONFIG_DIR / "baseline.yml")
    cfg["mesh_n"] = mesh_n
    cfg["solver"] = {**(cfg.get("solver") or {}), **(solver or {}), "mg_refresh_every": 0}
    return build_simulation(cfg, device, dtype)


def options(sim) -> dict:
    """The solver options a leg sets, as ``sim`` holds them now (the KNP
    post-smoothing per hierarchy)."""
    return dict(min_iter_knp=sim.knp_solver.min_iter, restart=sim.knp_solver.restart,
                rtol_knp=sim.knp_solver.rtol, rtol_emi=sim.emi_solver.rtol,
                knp_post_smooth={t: mg.post_smooth for t, mg in sim.knp_solver.mg.items()})


def set_options(sim, opts: dict) -> None:
    """Set :func:`options`' fields on ``sim``'s solvers and hierarchies
    (``knp_post_smooth``: one flag for all, or one per hierarchy)."""
    sim.knp_solver.min_iter = opts["min_iter_knp"]
    sim.knp_solver.restart = opts["restart"]
    sim.knp_solver.rtol = opts["rtol_knp"]
    sim.emi_solver.rtol = opts["rtol_emi"]
    post = opts["knp_post_smooth"]
    for t, mg in sim.knp_solver.mg.items():
        mg.post_smooth = post[t] if isinstance(post, dict) else post


def _rel(a, b) -> float:
    a = a.detach().cpu().to(torch.float64)
    b = b.detach().cpu().to(torch.float64)
    den = float(a.abs().max())
    return float((a - b).abs().max()) / den if den else 0.0


def _leg(sim, opts, state, steps: int, chunk: int, warmup: bool, keep_first: bool):
    set_options(sim, opts)
    if warmup:
        sim.run(state if state is not None else sim.init_state(), chunk, save_every=chunk)
    s = state if state is not None else sim.init_state()
    first = None
    sync = torch.cuda.synchronize if sim.device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    if keep_first:
        # the leg's first step on its own, its state kept on the host
        s, e1, k1, _ = sim.run(s, 1)
        first = _to_host(s)
        s, e, k, ok = sim.run(s, steps - 1, save_every=chunk)
        e, k = np.concatenate([e1, e]), np.concatenate([k1, k])
    else:
        s, e, k, ok = sim.run(s, steps, save_every=chunk)
    sync()
    return s, e, k, time.perf_counter() - t0, first


def compare(sim, steps: int, chunk: int, tuned: dict, state=None, warmup: bool = True,
            parity: dict | None = None, tol: float = 1e-5, keep_first: bool = False):
    """Both legs of ``steps`` steps in chunks of ``chunk`` from ``state``
    (None: ``sim.init_state()``), parity then tuned, each after an untimed
    warm-up chunk where ``warmup``; afterwards ``sim`` has the options it
    had before.  ``tuned``: fields of :func:`options` over the parity
    leg's; ``parity``: the parity leg's (None: ``PARITY`` with the rtols
    ``sim`` was built with).  Returns (record, states): the record has
    the JAX tool's keys and more; states are the legs' final states and,
    with ``keep_first``, each leg's state after its first step on the
    host (``"parity_first"``, ``"tuned_first"``)."""
    built = options(sim)
    parity = {**PARITY, "rtol_knp": built["rtol_knp"], "rtol_emi": built["rtol_emi"],
              **(parity or {})}
    tuned = {**parity, **tuned}
    if sim.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(sim.device)
    legs = {}
    try:
        for name, opts in (("parity", parity), ("tuned", tuned)):
            legs[name] = _leg(sim, opts, state, steps, chunk, warmup, keep_first)
    finally:
        set_options(sim, built)
    ref, ite_a, itk_a, wall_a, _ = legs["parity"]
    tun, ite_b, itk_b, wall_b, _ = legs["tuned"]
    diffs = {}
    for t in ref.c:
        diffs[f"c[{t}]"] = _rel(ref.c[t], tun.c[t])
    for t in ref.phi:
        diffs[f"phi[{t}]"] = _rel(ref.phi[t], tun.phi[t])
    for m in ref.phi_M:
        diffs[f"phi_M[{m}]"] = _rel(ref.phi_M[m], tun.phi_M[m])
    max_diff = max(diffs.values())
    dev = sim.device
    rec = {
        "steps": steps,
        "max_rel_diff": max_diff,
        "tol": tol,
        "passed": max_diff <= tol,
        # solves stopped exactly at min_iter: a full clip with a large
        # field difference suggests solves cut off while still descending
        "tuned_min_iter_clip_frac": float(np.mean(itk_b <= tuned["min_iter_knp"])),
        "diffs": diffs,
        "knp_iters_parity": float(itk_a.mean()),
        "knp_iters_tuned": float(itk_b.mean()),
        "emi_iters_parity": float(ite_a.mean()),
        "emi_iters_tuned": float(ite_b.mean()),
        "ms_per_step_parity": wall_a / steps * 1e3,
        "ms_per_step_tuned": wall_b / steps * 1e3,
        "emi_iters": {"parity": ite_a.tolist(), "tuned": ite_b.tolist()},
        "knp_iters": {"parity": itk_a.tolist(), "tuned": itk_b.tolist()},
        "options": {"parity": parity, "tuned": tuned},
        "from_step": 0 if state is None else int(state.step),
        "warmup": warmup,
        "dofs": int(sim.geom.emi_size),
        "device": str(dev),
        "dtype": str(sim.dtype).replace("torch.", ""),
        "nvidia_smi": card_line(dev),
    }
    if dev.type == "cuda":
        rec["peak_device_bytes"] = torch.cuda.max_memory_allocated(dev)
    states = {"parity": ref, "tuned": tun}
    if keep_first:
        states.update(parity_first=legs["parity"][4], tuned_first=legs["tuned"][4])
    return rec, states


def print_table(rec: dict) -> None:
    print(f"{'field':>12} {'max rel diff':>14}")
    for k, v in rec["diffs"].items():
        print(f"{k:>12} {v:>14.3e}")
    for name in ("parity", "tuned"):
        k = np.asarray(rec["knp_iters"][name])
        print(f"KNP iters  {name:6s}: {k.mean():.2f} mean (min {k.min()}, max {k.max()})")
    print(f"EMI iters  parity/tuned: {rec['emi_iters_parity']:.2f} / "
          f"{rec['emi_iters_tuned']:.2f}")
    print(f"ms/step    parity/tuned: {rec['ms_per_step_parity']:.1f} / "
          f"{rec['ms_per_step_tuned']:.1f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh-n", type=int, default=64)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--chunk", type=int, default=10)
    ap.add_argument("--min-iter", type=int, default=2, help="tuned min_iter_knp")
    ap.add_argument("--restart", type=int, default=8, help="tuned GMRES restart")
    ap.add_argument("--tol", type=float, default=1e-5,
                    help="exit 1 where the worst relative field difference is above this")
    ap.add_argument("--rtol-knp", type=float, default=None,
                    help="tuned KNP GMRES rtol (default: the parity leg's)")
    ap.add_argument("--rtol-emi", type=float, default=None,
                    help="tuned EMI CG rtol (default: the parity leg's)")
    ap.add_argument("--knp-post-smooth", choices=["on", "off"], default="on",
                    help="off: the KNP V(1,0) cycle in the tuned leg")
    ap.add_argument("--device", default=None, help="cpu to run on the CPU (default: CUDA)")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default=None,
                    help="default: float32 on the card, float64 on the CPU")
    ap.add_argument("--out", default=None, help="write the JSON record here too")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    sim = build(args.mesh_n, args.device, DTYPES.get(args.dtype))
    setup = time.perf_counter() - t0
    print(f"# built: {sim.geom.emi_size} EMI dofs, setup {setup:.0f}s", file=sys.stderr)
    tuned = dict(min_iter_knp=args.min_iter, restart=args.restart,
                 knp_post_smooth=args.knp_post_smooth == "on")
    if args.rtol_knp is not None:
        tuned["rtol_knp"] = args.rtol_knp
    if args.rtol_emi is not None:
        tuned["rtol_emi"] = args.rtol_emi
    rec, _ = compare(sim, args.steps, args.chunk, tuned, tol=args.tol)
    rec.update(mesh_n=args.mesh_n, setup_seconds=setup,
               command=" ".join(["python -m knpemi_tpu_torch.tools.compare_solver_opts",
                                 *(argv if argv is not None else sys.argv[1:])]))
    print_table(rec)
    print(json.dumps(rec), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rec, indent=1) + "\n")
    if not rec["passed"]:
        print(f"# FAIL: max_rel_diff {rec['max_rel_diff']:.3e} > tol {args.tol:.0e}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
