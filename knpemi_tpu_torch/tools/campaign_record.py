"""The committed record of a flagship campaign and its float64 twin.

    python -m knpemi_tpu_torch.tools.campaign_record CAMPAIGN_DIR --log LOG \\
        --twin TWIN.npz

From a driver campaign directory (``traces.npz`` and, for the final
fields, its last ``ckpt.npz``), its concatenated log and the twin leg of
``accuracy_flagship run --dtype f64``, writes under
``results_torch/flagship_300ms/``:

* ``campaign_300ms/traces.npz`` and ``campaign.log`` (copies);
* ``summary.json``: ``summarize_campaign`` of the two;
* ``twin_f64.npz``: the twin without its ``final_*`` fields;
* ``envelope.json``: ``accuracy_flagship compare`` of the campaign
  against the twin (table and JSON), over the whole twin and over its
  first 30 ms, with ``accuracy_flagship.GATES_30MS``, and the twin's
  per-step iterations by phase;
* ``against_jax.json``: the summary beside the JAX package's campaign
  summary (``results/flagship_300ms/``, a TPU run), the gates of that comparison, each
  call's set-up seconds, peak device memory and refreshes from the log,
  and ``compare`` of the JAX campaign's traces against the twin.

Prints the gates; exits 1 if one is missed.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import re
import shutil
import sys
from pathlib import Path

import numpy as np

from . import accuracy_flagship as acc
from .summarize_campaign import summarize

ROOT = Path(__file__).resolve().parents[2]
RECORD = ROOT / "results_torch" / "flagship_300ms"
JAX_RECORD = ROOT / "results" / "flagship_300ms"
TWIN_NPZ = "twin_f64.npz"
PHASES = ("stimulated_phase", "relaxation_phase")


def _gate(value, limit, held) -> dict:
    return {"value": value, "limit": limit, "held": bool(held)}


def side_by_side(port: dict, ref: dict) -> dict:
    """Each figure of two campaign summaries as [reference, port], and the
    gates on the port's: K_e peak and final within 5%, the peak's time
    within 1 ms, phi_M min / max / final within 1 mV, AP crossings equal."""
    rows = {
        "K_e_" + k: [ref["K_e"][k], port["K_e"][k]] for k in ref["K_e"]}
    for cell in ("phi_M_neuron_mV", "phi_M_glial_mV"):
        rows.update({f"{cell}_{k}": [ref[cell][k], port[cell][k]] for k in ref[cell]})
    for k in ("t_final_ms", "n_saves", "neuron_ap_crossings", "wall_min_stepping"):
        rows[k] = [ref.get(k), port.get(k)]
    for ph in PHASES:
        for k in ("chunks", "ms_per_step_mean", "ms_per_step_p90", "emi_it", "knp_it"):
            rows[f"{ph}_{k}"] = [ref.get(ph, {}).get(k), port.get(ph, {}).get(k)]
    rel = lambda k: abs(rows[k][1] - rows[k][0]) / abs(rows[k][0])
    gates = {
        "K_e_peak_within_5pct": _gate(rel("K_e_peak_mM"), 0.05, rel("K_e_peak_mM") <= 0.05),
        "K_e_peak_time_within_1ms": _gate(
            abs(rows["K_e_peak_at_ms"][1] - rows["K_e_peak_at_ms"][0]), 1.0,
            abs(rows["K_e_peak_at_ms"][1] - rows["K_e_peak_at_ms"][0]) <= 1.0),
        "K_e_final_within_5pct": _gate(rel("K_e_final_mM"), 0.05,
                                       rel("K_e_final_mM") <= 0.05),
        "neuron_ap_crossings_equal": _gate(port["neuron_ap_crossings"], 0,
                                           port["neuron_ap_crossings"]
                                           == ref["neuron_ap_crossings"]),
    }
    for cell in ("phi_M_neuron_mV", "phi_M_glial_mV"):
        for k in ("min", "max", "final"):
            d = abs(port[cell][k] - ref[cell][k])
            gates[f"{cell}_{k}_within_1mV"] = _gate(d, 1.0, d <= 1.0)
    return {"columns": ["jax", "port"], "rows": rows, "gates": gates}


def calls_from_log(log: Path) -> list:
    """Each call's set-up seconds, peak device memory and refreshes, from
    the driver's verbose lines."""
    calls = []
    for line in Path(log).read_text().splitlines():
        m = re.match(r"set-up ([0-9.]+)s", line)
        if m:
            calls.append({"setup_s": float(m.group(1))})
        m = re.match(r"(\d+) steps in ([0-9.]+)s \(([0-9.]+) ms/step\)", line)
        if m and calls:
            calls[-1].update(steps=int(m.group(1)), stepping_s=float(m.group(2)),
                             ms_per_step=float(m.group(3)))
        m = re.match(r"refreshes \{'installed': (\d+), 'skipped': (\d+)\}", line)
        if m and calls:
            calls[-1].update(refreshes_installed=int(m.group(1)),
                             refreshes_skipped=int(m.group(2)))
        m = re.match(r"peak device memory ([0-9.]+) GiB", line)
        if m and calls:
            calls[-1]["peak_device_gib"] = float(m.group(1))
    return calls


def leg_iterations(leg: dict, stim_end: float = 100.0) -> dict:
    """Per-step Krylov iterations of an ``accuracy_flagship`` leg by phase
    (steps ending at or before ``stim_end`` ms, and after): range and mean."""
    it_e, it_k = np.asarray(leg["it_emi"]), np.asarray(leg["it_knp"])
    dt = float(leg["t"][-1]) / len(it_e)
    stim = np.arange(1, len(it_e) + 1) * dt <= stim_end + dt / 2
    out = {}
    for name, sel in (("stimulated_phase", stim), ("relaxation_phase", ~stim)):
        if sel.any():
            out[name] = {"steps": int(sel.sum()),
                         "emi_it": [int(it_e[sel].min()), int(it_e[sel].max())],
                         "knp_it": [int(it_k[sel].min()), int(it_k[sel].max())],
                         "emi_mean": float(it_e[sel].mean()),
                         "knp_mean": float(it_k[sel].mean())}
    return out


def _compare(a, b, tmax=None) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = acc.compare(a, b, tmax)
    return {"compare": out, "table": buf.getvalue().splitlines()[:-1]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("campaign")
    ap.add_argument("--log", required=True)
    ap.add_argument("--twin", required=True)
    args = ap.parse_args(argv)
    campaign, out, jax_dir = Path(args.campaign), RECORD, JAX_RECORD
    (out / "campaign_300ms").mkdir(parents=True, exist_ok=True)
    if campaign.resolve() != (out / "campaign_300ms").resolve():
        shutil.copyfile(campaign / "traces.npz", out / "campaign_300ms" / "traces.npz")
    if Path(args.log).resolve() != (out / "campaign.log").resolve():
        shutil.copyfile(args.log, out / "campaign.log")
    summary = summarize(out / "campaign_300ms", out / "campaign.log")
    (out / "summary.json").write_text(json.dumps(summary, indent=1) + "\n")
    with np.load(args.twin) as f:
        np.savez(out / TWIN_NPZ, **{k: f[k] for k in f.files if not k.startswith("final_")})

    whole = _compare(campaign, args.twin)
    first = _compare(campaign, args.twin, tmax=30.0)
    env_gates = {k: _gate(first["compare"][k], lim, first["compare"][k] <= lim)
                 for k, lim in acc.GATES_30MS.items()}
    with np.load(args.twin) as f:
        twin_iters = leg_iterations({k: f[k] for k in ("t", "it_emi", "it_knp")})
    envelope = {**whole, "first_30ms": first, "gates_30ms": env_gates,
                "twin_iterations": twin_iters}
    (out / "envelope.json").write_text(json.dumps(envelope, indent=1) + "\n")

    ref = json.loads((jax_dir / "summary.json").read_text())
    sbs = side_by_side(summary, ref)
    against = {
        "jax": "results/flagship_300ms/summary.json (the JAX package on a TPU, float32)",
        "side_by_side": sbs,
        "port_calls": calls_from_log(out / "campaign.log"),
        "jax_tpu_f32_vs_port_f64": _compare(jax_dir / "campaign_300ms", args.twin),
    }
    (out / "against_jax.json").write_text(json.dumps(against, indent=1) + "\n")
    gates = {**sbs["gates"], **{f"envelope_30ms_{k}": v for k, v in env_gates.items()}}
    for k, g in gates.items():
        print(f"{'held' if g['held'] else 'MISSED':>6}  {k}: {g['value']} (limit {g['limit']})")
    return 0 if all(g["held"] for g in gates.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
