"""What a cell is made of, found by name.

``BENCHMARK.json`` at the root of the checkout lists the configurations,
the cells and the metrics.  Everything that belongs to one of them is a
file of its own under ``perfbench/``, found by its name:

  configs/<config>.json        the configuration (its ``file`` entry)
  traffic/<traffic>.json       a traffic mix
  limits/<cell>.json           the limits of the numbers ``check.py`` compares
  scenarios/<scenario>.py      builds the program's simulation of a configuration
  metrics/<metric>.py          reads one per-layer metric from a traced run
  roofline/<layer>.py          the least bytes of one layer's work (every
                               file there that defines ``Count``)

so that a cell, a configuration or a metric is added by adding files and
entries, never by editing one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parent.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str, root: Path = ROOT) -> ModuleType:
    """``perfbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = root / "perfbench" / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    key = f"perfbench_{kind}_{name}".replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(name: str, bench: dict, root: Path = ROOT) -> dict:
    """The cell ``name`` with its configuration, traffic mix, limits and
    metrics: {workload, config, traffic, limits, end_to_end, per_layer}."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; the benchmark has {sorted(cells)}")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    applies = lambda m: name in m.get("workloads", [name])
    return dict(
        workload=w,
        config=load_json(root / cfg_entry["file"]),
        traffic=load_json(root / "perfbench" / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(root / "perfbench" / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if applies(m)],
        per_layer=[m for m in bench["per_layer"] if applies(m)],
    )


def roofline_layers(root: Path = ROOT) -> dict:
    """{layer: module} of every ``roofline/<layer>.py`` that defines a
    ``Count`` (its helpers define none)."""
    out = {}
    for path in sorted((root / "perfbench" / "roofline").glob("*.py")):
        mod = load_module("roofline", path.stem, root)
        if hasattr(mod, "Count"):
            out[path.stem] = mod
    return out
