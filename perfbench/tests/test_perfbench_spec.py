"""Every cell of BENCHMARK.json resolves to its files, and a new
configuration, traffic mix, cell or metric is found by name alone."""

import json
import re
import shutil

import pytest

from perfbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_cell_resolves():
    bench = spec.benchmark()
    for w in bench["workloads"]:
        c = spec.cell(w["name"], bench)
        assert c["config"]["name"] == w["config"]
        assert set(c["limits"]) >= {"phi", "c", "ode"}
        spec.load_module("scenarios", c["config"]["scenario"])
        for m in c["per_layer"]:
            assert callable(spec.load_module("metrics", m["name"]).read)
        names = {m["name"] for m in c["end_to_end"]}
        assert {"ms_per_step", "peak_mem_gib", "setup_s"} <= names
    # the layers the roofline readers take, found by file
    assert set(spec.roofline_layers()) == {"emi", "knp"}


def test_contract_shapes():
    bench = spec.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    for entry in bench["configs"] + bench["workloads"] + bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(entry["name"]), entry["name"]
    for c in bench["configs"]:
        cfg = json.load(open(spec.ROOT / c["file"]))
        assert cfg["reduced"] == c["reduced"]
    for m in bench["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
    assert 1 <= bench["run_seconds"] <= 51


def test_new_files_found_without_edits(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(spec.ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.benchmark()
    cfg = json.load(open(spec.ROOT / "perfbench/configs/astrocyte_n64.json"))
    cfg["name"] = "astrocyte_n96"
    cfg["scenario_args"]["mesh_n"] = 96
    (root / "perfbench/configs/astrocyte_n96.json").write_text(json.dumps(cfg))
    (root / "perfbench/traffic/hz300.json").write_text(
        (spec.ROOT / "perfbench/traffic/baseline.json").read_text())
    (root / "perfbench/limits/astrocyte_n96.hz300.json").write_text(
        json.dumps({"phi": 1.0, "c": 1.0, "ode": 1.0}))
    (root / "perfbench/metrics/step_ms_p90.py").write_text(
        "def read(rec):\n    return 42.0\n")
    (root / "perfbench/roofline/ode.py").write_text(
        "class Count:\n    def __init__(self, sim):\n        pass\n")
    bench["configs"].append(dict(bench["configs"][0], name="astrocyte_n96",
                                 file="perfbench/configs/astrocyte_n96.json"))
    bench["workloads"].append(dict(name="astrocyte_n96.hz300", config="astrocyte_n96",
                                   traffic="hz300", chips=1, why="a new cell"))
    bench["per_layer"].append(dict(name="step_ms_p90", unit="ms", better="lower",
                                   source="host_clock", layer="x", moves="ms_per_step"))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    c = spec.cell("astrocyte_n96.hz300", spec.benchmark(root), root)
    assert c["config"]["scenario_args"]["mesh_n"] == 96
    assert "step_ms_p90" in [m["name"] for m in c["per_layer"]]
    assert spec.load_module("metrics", "step_ms_p90", root).read({}) == 42.0
    assert set(spec.roofline_layers(root)) == {"emi", "knp", "ode"}
    # a metric restricted to listed cells stays out of the new one
    assert "emi_roofline" not in [m["name"] for m in c["per_layer"]]
    with pytest.raises(KeyError):
        spec.cell("no.such_cell", spec.benchmark(root), root)
