"""Summarize a flagship campaign directory (traces.npz + campaign.log).

    python -m knpemi_tpu_torch.tools.summarize_campaign DIR [--log FILE] \\
        [--stim-end 100]

The long-horizon record of a driver campaign
(``drivers/run_stim_duration.py``): K_e excursion and recovery, neuron
and glial membrane potentials over the whole trajectory, a crude count
of action potentials and, from the driver's verbose chunk lines
("steps a..b: X ms/step, emi_it=E knp_it=K"), per-phase step cost and
Krylov iterations and the minutes spent stepping.  Legs resumed from a
checkpoint are joined at the driver's "resumed from ... step N" line.
Prints one JSON block, with the keys of the JAX package's
``tools/summarize_campaign.py``; numpy only.
"""

from __future__ import annotations

import argparse
import json
import re
from pathlib import Path

import numpy as np

CHUNK = re.compile(r"steps (\d+)\.\.(\d+): ([0-9.]+) ms/step, emi_it=(\d+) knp_it=(\d+)")
SEAM = re.compile(r"resumed from .*step (\d+)")


def parse_log(path: Path):
    """Per-chunk (step_end, ms_per_step, emi_it, knp_it, steps) from the
    driver's verbose lines, concatenated across resumed legs."""
    rows = []
    off = 0
    for line in Path(path).read_text().splitlines():
        m = CHUNK.search(line)
        if m:
            a, b, ms, ie, ik = (float(g) for g in m.groups())
            rows.append((b + off, ms, ie, ik, b - a + 1))
        # a resumed leg restarts its local step numbering at 1
        m2 = SEAM.search(line)
        if m2:
            off = int(m2.group(1))
    return np.asarray(rows) if rows else np.zeros((0, 5))


def summarize(results, log=None, stim_end: float = 100.0) -> dict:
    """The summary of the campaign directory ``results``; ``log`` defaults
    to ``<results>/../campaign.log`` and is read where it exists."""
    res = Path(results)
    tr = np.load(res / "traces.npz")
    t = tr["t"]
    ke = tr["K_e_max"]
    out = {
        "t_final_ms": float(t[-1]),
        "n_saves": int(len(t)),
        "K_e": {
            "baseline_mM": float(ke[0]),
            "peak_mM": float(ke.max()),
            "peak_at_ms": float(t[int(ke.argmax())]),
            "final_mM": float(ke[-1]),
            # recovery fraction of the excursion at the end of the run
            "recovered_frac": float((ke.max() - ke[-1]) / max(ke.max() - ke[0], 1e-30)),
        },
    }
    for key, name in (("phi_M_neuron", "phi_M_neuron_mV"), ("phi_M_glial", "phi_M_glial_mV")):
        v = tr[key]
        out[name] = {"min": float(v.min()), "max": float(v.max()), "final": float(v[-1])}
    # crude AP count: depolarization crossings of -20 mV (mean trace)
    v = tr["phi_M_neuron"]
    out["neuron_ap_crossings"] = int(((v[1:] > -20) & (v[:-1] <= -20)).sum())

    log = Path(log) if log else res.parent / "campaign.log"
    if log.exists():
        rows = parse_log(log)
        if len(rows):
            dt_ms = t[-1] / rows[-1][0] if rows[-1][0] else 0.1
            stim = rows[:, 0] * dt_ms <= stim_end

            def phase(sel):
                r = rows[sel]
                return {
                    "chunks": int(len(r)),
                    "ms_per_step_mean": round(float(r[:, 1].mean()), 1),
                    "ms_per_step_p90": round(float(np.percentile(r[:, 1], 90)), 1),
                    "emi_it": [int(r[:, 2].min()), int(r[:, 2].max())],
                    "knp_it": [int(r[:, 3].min()), int(r[:, 3].max())],
                }

            out["stimulated_phase"] = phase(stim)
            if (~stim).any():
                out["relaxation_phase"] = phase(~stim)
            # each chunk's step count comes from its own line (steps redone
            # after a crash and resume overlap at the seam): all the time
            # spent stepping, the redone steps included
            out["wall_min_stepping"] = round(float((rows[:, 1] * rows[:, 4]).sum() / 6e4), 1)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("results")
    ap.add_argument("--log", default=None)
    ap.add_argument("--stim-end", type=float, default=100.0,
                    help="end of the pulsed-source phase (ms)")
    args = ap.parse_args(argv)
    out = summarize(args.results, args.log, args.stim_end)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
