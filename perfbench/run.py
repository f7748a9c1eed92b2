"""The benchmark of the PyTorch / CUDA port, one cell a run.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Prints the card, its power limit, the dofs
per step, the window's steps and the refreshes installed, then as its
last line one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``compared``: each number the comparison holds against its limit (also
the last lines of standard error).  Exits 2 without a result where there
is no card, too few cards or, after the window, a JAX module in the
process.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every cache of the run at a fixed path inside the checkout
CACHE = ROOT / ".perfbench_cache"
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
os.environ.setdefault("USE_FLAX", "0")
sys.path.insert(0, str(ROOT))

KEYS = ("correct", "attempted", "failed", "metrics", "device", "breakdown", "compared")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        from perfbench import bench
    except ImportError as e:  # the program is not in this directory
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    result = bench.run(args.workload, args.seed, args.seconds, bool(args.trace), T_START)
    if result is None:
        return 2
    bad = bench.forbidden_modules()
    if bad:
        print(f"perfbench: the process holds {bad}", file=sys.stderr)
        return 2
    print(json.dumps({k: result[k] for k in KEYS if k in result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
