"""float32 against float64 on the flagship scenario: the attainable-accuracy curve.

    python -m knpemi_tpu_torch.tools.accuracy_flagship run --dtype f32|f64 \\
        --out X.npz [--tstop 300] [-c baseline] [--mesh-n N] [--device cpu]
    python -m knpemi_tpu_torch.tools.accuracy_flagship compare A B
    python -m knpemi_tpu_torch.tools.accuracy_flagship [--tstop 300] \\
        [-c baseline] [--mesh-n N] [--device cpu] [--outdir DIR]

The same discretization and solvers in both precisions, their divergence
measured over simulated time on the astrocyte flagship scenario
(``drivers/run_stim_duration.py``'s ``build_simulation``).

``run``: one leg, on the card unless ``--device cpu``.  ``-c`` takes a
config name under ``examples/astrocyte/config_files/`` or a path.  Every
100 steps the complete state, the traces so far and every step's
iteration counts go to ``<out>.ckpt.npz`` (the npz checkpoint layout of
``io.save_checkpoint``; a finished leg writes one too); a rerun with the
same ``--out`` resumes from it, with an EMI hierarchy refresh from the
restored state where refreshes are on.  The leg writes ``<out>``: the
traces ``t``, ``phi_M_neuron``, ``phi_M_glial``, ``K_e_max`` and
``phi_e_norm`` every ``save_frequency`` steps, ``it_emi`` / ``it_knp``
per step, ``wall`` (seconds of this call's stepping) and the final
fields ``final_phi_M_1``, ``final_phi_M_2``, ``final_phi_0``,
``final_c_K_0``, ``final_c_Na_0`` and ``final_c_K_1``.

``compare A B``: A (float32) against B (float64 reference), a table of
about 12 rows and one JSON line.  Either may also be a driver campaign
directory: its ``traces.npz`` gives the rows (the driver's traces share
``t``, ``phi_M_neuron``, ``phi_M_glial`` and ``K_e_max`` with a leg's),
its ``ckpt.npz`` (the complete last state), where present, the final
fields.

With no sub-command: both legs one after the other in this process (into
``--outdir``), then their comparison.  The keys of every file and of the
JSON are those of the JAX package's ``tools/accuracy_flagship.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..drivers.run_stim_duration import CONFIG_DIR, build_simulation
from ..io import load_checkpoint, save_checkpoint
from ..sim.config import load_config

TRACE_KEYS = ("t", "phi_M_neuron", "phi_M_glial", "K_e_max", "phi_e_norm")
FINAL_KEYS = ("phi_M_1", "phi_M_2", "phi_0", "c_K_0", "c_Na_0", "c_K_1")
DTYPES = {"f32": torch.float32, "f64": torch.float64}
CHECKPOINT_EVERY = 100  # steps (10 ms)
# float32 against float64 over the first 30 ms: twice the JAX package's
# measured envelope (results/accuracy/compare_30ms.json)
GATES_30MS = {"max_dphi_M_neuron_mV": 0.29, "max_dphi_M_glial_mV": 0.52,
              "max_rel_dK_e": 0.056}


def config_path(name) -> Path:
    """A config file: ``name`` as a path, else ``CONFIG_DIR/<name>.yml``."""
    p = Path(name)
    return p if p.exists() else CONFIG_DIR / f"{name}.yml"


def final_fields(state) -> dict:
    """The six fields of a state the comparison holds at the end, on the host."""
    host = lambda v: v.detach().cpu().numpy()
    return {"phi_M_1": host(state.phi_M[1]), "phi_M_2": host(state.phi_M[2]),
            "phi_0": host(state.phi[0]), "c_K_0": host(state.c[0][0]),
            "c_Na_0": host(state.c[0][2]), "c_K_1": host(state.c[1][0])}


def run_leg(dtype: str, tstop: float, out, mesh_n=None, config="baseline", device=None,
            checkpoint_every: int = CHECKPOINT_EVERY) -> dict:
    """One leg in ``dtype`` ('f32' or 'f64') to ``tstop`` ms, resumed from
    ``<out>.ckpt.npz`` where it exists.  Returns what it wrote to ``out``."""
    out = Path(out)
    cfg = load_config(config_path(config))
    cfg["Tstop"] = tstop
    if mesh_n:
        cfg["mesh_n"] = mesh_n
    sim = build_simulation(cfg, device=device, dtype=DTYPES[dtype])
    n_steps = int(round(tstop / sim.params.dt))
    save_every = int(cfg.get("save_frequency", 5))

    traces = {k: [] for k in TRACE_KEYS}
    it_prev = (np.zeros(0, int), np.zeros(0, int))
    ckpt = out.with_name(out.name + ".ckpt.npz")
    if ckpt.exists():
        state, meta = load_checkpoint(ckpt, device=sim.device, dtype=sim.dtype)
        for k in traces:
            traces[k] = [float(v) for v in np.atleast_1d(meta[f"trace_{k}"])]
        it_prev = (np.atleast_1d(meta["it_emi"]).astype(int),
                   np.atleast_1d(meta["it_knp"]).astype(int))
        if sim.opts.mg_refresh_every and not sim.opts.direct:
            sim.refresh_mg(state)
        print(f"# {dtype}: resumed at step {int(state.step)}", file=sys.stderr)
    else:
        state = sim.init_state()

    def observer(s):
        # s is a host copy
        traces["t"].append(float(s.t))
        traces["phi_M_neuron"].append(float(s.phi_M[1].mean()))
        traces["phi_M_glial"].append(float(s.phi_M[2].mean()))
        traces["K_e_max"].append(float(s.c[0][0].max()))
        traces["phi_e_norm"].append(float(torch.linalg.norm(s.phi[0])))

    # every step's (emi, knp) iterations, device scalars read at a
    # checkpoint, so a resumed leg keeps the counts of the steps before it
    step_iters = []
    step = sim.step

    def counted_step(s):
        s = step(s)
        step_iters.append(torch.stack([s.emi_iters, s.knp_iters]))
        return s

    sim.step = counted_step

    def write_ckpt(host_state, done=None):
        if done is None:
            done = torch.stack(step_iters).cpu().numpy().T if step_iters else np.zeros((2, 0))
        tmp = ckpt.with_name(ckpt.name + ".tmp.npz")
        save_checkpoint(tmp, host_state,
                        it_emi=np.concatenate([it_prev[0], np.asarray(done[0], int)]),
                        it_knp=np.concatenate([it_prev[1], np.asarray(done[1], int)]),
                        **{f"trace_{k}": np.asarray(v) for k, v in traces.items()})
        os.replace(tmp, ckpt)

    n_rem = n_steps - int(state.step)
    t0 = time.perf_counter()
    if n_rem > 0:
        state, it_e, it_k, _ = sim.run(state, n_rem, save_every=save_every,
                                       observer=observer, checkpoint_every=checkpoint_every,
                                       checkpoint_cb=write_ckpt)
        write_ckpt(state, (it_e, it_k))  # a finished leg resumes to a no-op
    else:
        it_e = it_k = np.zeros(0, int)
    wall = time.perf_counter() - t0
    it_e = np.concatenate([it_prev[0], np.asarray(it_e, int)])
    it_k = np.concatenate([it_prev[1], np.asarray(it_k, int)])
    rec = dict(wall=wall, it_emi=it_e, it_knp=it_k,
               **{k: np.asarray(v) for k, v in traces.items()},
               **{f"final_{k}": v for k, v in final_fields(state).items()})
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez(out, **rec)
    print(f"# {dtype}: {n_steps} steps, {wall:.0f}s ({wall / max(n_rem, 1) * 1e3:.1f} ms/step "
          f"over {max(n_rem, 0)} steps), avg emi_it {it_e.mean():.1f}, refreshes "
          f"{sim.refresh_counts}", file=sys.stderr)
    return rec


def load_leg(path) -> dict:
    """A leg's arrays: an npz written by ``run``, or a driver campaign
    directory (``traces.npz``, and the final fields of ``ckpt.npz``
    where it exists)."""
    path = Path(path)
    if not path.is_dir():
        with np.load(path) as f:
            return {k: f[k] for k in f.files}
    with np.load(path / "traces.npz") as f:
        leg = {k: f[k] for k in f.files}
    if (path / "ckpt.npz").exists():
        with np.load(path / "ckpt.npz") as f:
            c0, c1 = f["c__0"], f["c__1"]
            leg.update(final_phi_M_1=f["phi_M__1"], final_phi_M_2=f["phi_M__2"],
                       final_phi_0=f["phi__0"], final_c_K_0=c0[0], final_c_Na_0=c0[2],
                       final_c_K_1=c1[0], final_t=f["scalar__t"])
    return leg


def compare(a, b, tmax=None) -> dict:
    """a = the float32 leg, b = the float64 reference leg; with ``tmax``
    (ms) only the saves up to it, and no final fields."""
    A, B = load_leg(a), load_leg(b)
    n = min(len(A["t"]), len(B["t"]))
    if tmax is not None:
        n = min(n, int(np.searchsorted(A["t"], tmax + 0.05, side="right")))
    if abs(float(A["t"][n - 1]) - float(B["t"][n - 1])) > 0.05:
        raise ValueError(f"the legs' saves are at different times: {A['t'][n - 1]} "
                         f"against {B['t'][n - 1]} ms")
    rows = []
    for i in range(n):
        rows.append((
            float(A["t"][i]),
            abs(float(A["phi_M_neuron"][i]) - float(B["phi_M_neuron"][i])),
            abs(float(A["phi_M_glial"][i]) - float(B["phi_M_glial"][i])),
            abs(float(A["K_e_max"][i]) - float(B["K_e_max"][i]))
            / max(abs(float(B["K_e_max"][i])), 1e-30),
        ))
    print(f"{'t (ms)':>8} {'|dphi_M n| mV':>14} {'|dphi_M g| mV':>14} {'rel dK_e':>10}")
    # about 12 evenly spaced rows of the curve
    for i in range(0, n, max(1, n // 12)):
        t, dn, dg, dk = rows[i]
        print(f"{t:>8.1f} {dn:>14.3e} {dg:>14.3e} {dk:>10.2e}")
    # the final fields, where both legs have them and end at the same time
    end = lambda L: float(L.get("final_t", L["t"][-1]))
    fin = None
    if tmax is None and abs(end(A) - end(B)) <= 0.05 and all(
            f"final_{k}" in A and f"final_{k}" in B for k in FINAL_KEYS):
        fin = {}
        for k in FINAL_KEYS:
            x, y = A[f"final_{k}"], B[f"final_{k}"]
            fin[k] = float(np.linalg.norm(x - y) / max(np.linalg.norm(y), 1e-30))
    avg = lambda L: float(L["it_emi"].mean()) if "it_emi" in L else None
    out = {
        "metric": "f32_vs_f64_flagship",
        "t_final_ms": float(A["t"][n - 1]),
        "max_dphi_M_neuron_mV": max(r[1] for r in rows),
        "max_dphi_M_glial_mV": max(r[2] for r in rows),
        "max_rel_dK_e": max(r[3] for r in rows),
        "final_rel_l2": fin,
        "avg_emi_iters": [avg(A), avg(B)],
    }
    print(json.dumps(out))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd")
    r = sub.add_parser("run")
    r.add_argument("--dtype", choices=sorted(DTYPES), required=True)
    r.add_argument("--out", required=True)
    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    c.add_argument("--tmax", type=float, default=None,
                   help="compare the saves up to this time (ms) only")
    for p in (ap, r):
        p.add_argument("--tstop", type=float, default=300.0)
        p.add_argument("--mesh-n", type=int, default=None)
        p.add_argument("-c", "--config", default="baseline",
                       help="config name under examples/astrocyte/config_files/ or a path")
        p.add_argument("--device", default=None,
                       help="cpu to run on the CPU (default: CUDA)")
    ap.add_argument("--outdir", default="chip_work/accuracy",
                    help="where both legs go with no sub-command (git ignores chip_work)")
    args = ap.parse_args(argv)
    if args.cmd == "compare":
        return compare(args.a, args.b, args.tmax)
    kw = dict(mesh_n=args.mesh_n, config=args.config, device=args.device)
    if args.cmd == "run":
        run_leg(args.dtype, args.tstop, args.out, **kw)
        return None
    outdir = Path(args.outdir)
    legs = {d: outdir / f"flagship_{d}.npz" for d in ("f32", "f64")}
    for d, path in legs.items():
        print(f"# running {d} leg...", file=sys.stderr)
        run_leg(d, args.tstop, path, **kw)
    return compare(legs["f32"], legs["f64"])


if __name__ == "__main__":
    main()
