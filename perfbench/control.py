"""The readings the limits of ``correct`` are set from, on the card.

    python3 perfbench/control.py --workload <cell> --seeds 11 12 ... \\
        [--control-seeds 3] [--steps 25] [--out FILE]

One process builds the cell's simulation once; for each seed it sets the
seeded initial state, runs ``--steps`` steps through ``Simulation.run``
in the traffic's chunks (a short window at the cell's own load, long
enough to reach the first pulse of a source), samples the chunk
transitions as a benchmark run does and prints, as one JSON line, the
program's numbers against the reference (the lower readings) and, for
the first ``--control-seeds`` seeds, the control's: the reference with
every phase's output stored in bfloat16, the precision below the
configuration's float32 (the upper readings), and whether each side
passes the cell's limits by a run's own comparison (``check.fails``).
The benchmark's own runs never run the control.
"""

import argparse
import json
import sys
import time
from pathlib import Path

T_START = time.time()
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def readings(workload, seeds, control_seeds, steps, device="cuda", config_override=None,
             emit=print):
    import torch

    from perfbench import bench, check, spec
    from perfbench.reference.step import Reference

    c = spec.cell(workload, spec.benchmark())
    if config_override is not None:
        config_override(c)
    cfg, traffic = c["config"], c["traffic"]
    dev = torch.device(device)
    se = int(traffic["save_every"])
    sim = spec.load_module("scenarios", cfg["scenario"]).build(
        cfg, traffic, getattr(torch, traffic["dtype"]), dev)
    ref = Reference(cfg, traffic, dev)
    num = check.Numbering(sim.geom, ref.geom)
    out = []
    for i, seed in enumerate(seeds):
        from knpemi_tpu_torch.sim.stepper import _to_host

        st = sim.init_state()
        bench.perturb(sim, st, traffic["perturb"], seed)
        hosts = [_to_host(st)]
        sim.run(st, steps, save_every=se, observer=hosts.append)
        picks = bench.sample_chunks(hosts, traffic, float(cfg["physics"]["dt"]), seed)
        rec = dict(workload=workload, seed=seed, chunks=picks,
                   program=bench.compare(ref, num, hosts, picks, se))
        if i < control_seeds:
            rec["control"] = bench.compare(ref, num, hosts, picks, se, check.bf16_store)
        rec["worst_program"] = {k: max(p[k] for p in rec["program"]) for k in check.NUMBERS}
        # each side through a run's own comparison
        rec["program_correct"] = not any(check.fails(p, c["limits"]) for p in rec["program"])
        if "control" in rec:
            rec["least_control"] = {k: min(p[k] for p in rec["control"]) for k in check.NUMBERS}
            rec["control_correct"] = not any(check.fails(p, c["limits"]) for p in rec["control"])
        emit(json.dumps(rec))
        out.append(rec)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--steps", type=int, default=25)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    recs = readings(args.workload, args.seeds, args.control_seeds, args.steps)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in recs))
    print(f"control readings: {time.time() - T_START:.1f} s", file=sys.stderr)


if __name__ == "__main__":
    main()
