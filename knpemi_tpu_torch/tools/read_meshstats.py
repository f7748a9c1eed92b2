"""The volume and surface summaries of an emimesh ``meshstatistic.yml``.

    python -m knpemi_tpu_torch.tools.read_meshstats FILE.yml

The counterpart of ``examples/astrocyte/tools/read_meshstats.py``: the
file's ``volumes``, ``surfaces``, ``cells`` and ``labels`` where it has
any of them, else the whole file.  Host only (yaml).
"""

from __future__ import annotations

import argparse

STAT_KEYS = ("volumes", "surfaces", "cells", "labels")


def read_meshstats(path) -> dict:
    import yaml

    with open(path) as f:
        stats = yaml.safe_load(f)
    out = {k: stats[k] for k in STAT_KEYS if k in stats}
    return out or stats


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("yml", help="emimesh meshstatistic.yml")
    args = ap.parse_args(argv)
    stats = read_meshstats(args.yml)
    for k, v in stats.items():
        print(f"{k}: {v}")
    return stats


if __name__ == "__main__":
    main()
