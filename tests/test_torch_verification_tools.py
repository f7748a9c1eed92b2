"""The port's verification tools and mesh helpers against the JAX package's.

* ``compare_solver_opts``: the JAX tool (``tools/compare_solver_opts.py``,
  its ``main`` run in this process) and the port's ``compare`` at
  ``mesh_n`` 8, 15 steps in chunks of 5, tuned = min_iter 2, restart 8,
  rtol KNP 3e-6, EMI 1e-5: both legs' per-step iterations equal, every
  field difference to 1e-9 absolute; the port's ``main`` exits 1 where
  ``--tol`` is below the measured difference;
* ``stress_mg_refresh``: the JAX tool and the port's ``stress`` at
  ``mesh_n`` 8, 20 steps in chunks of 5, a refresh every 10 steps,
  f-scale 4, duty 1.0, the refresh synchronous in both: per-step EMI
  iterations of both legs equal, the ECS K+ maximum of every chunk to
  1e-9 relative;
* ``local_ecs_width`` on the tissue mesh, ``make_synthetic_emimesh``
  written by each and read back through either package's ``read_mesh`` +
  ``remark_emimesh`` to the same geometry, ``read_meshstats`` and
  ``find_roi_points``' output: equal to the JAX scripts'.

Float64 on the CPU (the JAX tools build float64 under the tests' x64;
the JAX example takes its per-ion KNP branch on the CPU, so the port runs
``knp_batched: false``).  The JAX scripts are loaded by path; the JAX
example's ``build_simulation`` is wrapped to record each ``run``.
"""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from knpemi_tpu_torch.drivers.run_stim_duration import CONFIG_DIR
from knpemi_tpu_torch.sim.config import load_config
from knpemi_tpu_torch.tools import compare_solver_opts as cso
from knpemi_tpu_torch.tools import stress_mg_refresh as smr

ROOT = Path(__file__).resolve().parents[1]
TUNED = dict(min_iter_knp=2, restart=8, rtol_knp=3e-6, rtol_emi=1e-5)
PER_ION = {"knp_batched": False}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op torch thread a test (test processes share the host's
    cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def jax_runs(monkeypatch):
    """The JAX example's ``build_simulation`` as ``run_stim_duration`` for
    the JAX tools, its options made synchronous in the refresh and each
    ``run`` of the built simulation recorded: (per-step EMI and KNP
    iterations, the ECS K+ maximum at every observer call)."""
    ex = _load(ROOT / "examples" / "astrocyte" / "run_stim_duration.py",
               "jax_example_run_stim_duration")
    runs = []
    build = ex.build_simulation

    def recording_build(cfg, *a, **kw):
        cfg = {**cfg, "solver": {**(cfg.get("solver") or {}), "mg_refresh_async": False}}
        sim = build(cfg, *a, **kw)
        run = sim.run

        def recorded(state, n, save_every=None, observer=None, **kw):
            kmax = []

            def obs(h):
                kmax.append(float(np.max(np.asarray(h.c[0][0]))))
                if observer is not None:
                    observer(h)

            out = run(state, n, save_every=save_every, observer=obs, **kw)
            runs.append((np.asarray(out[1]), np.asarray(out[2]), kmax))
            return out

        sim.run = recorded
        return sim

    monkeypatch.setattr(ex, "build_simulation", recording_build)
    monkeypatch.setitem(sys.modules, "run_stim_duration", ex)
    return runs


def _jax_tool_json(monkeypatch, capsys, name, *argv):
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *map(str, argv)])
    tool = _load(ROOT / "tools" / f"{name}.py", f"jax_tool_{name}")
    try:
        tool.main()
    except SystemExit as e:  # the field gate's exit
        assert e.code == 1
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_compare_solver_opts_equals_jax_tool(jax_runs, monkeypatch, capsys):
    ref = _jax_tool_json(monkeypatch, capsys, "compare_solver_opts", "--mesh-n", 8,
                         "--steps", 15, "--chunk", 5, "--rtol-knp", 3e-6, "--rtol-emi", 1e-5)
    # warm-up and timed leg, parity then tuned
    assert [len(r[0]) for r in jax_runs] == [5, 15, 5, 15]
    sim = cso.build(8, device="cpu", solver=PER_ION)
    built = cso.options(sim)
    rec, states = cso.compare(sim, 15, 5, TUNED)
    assert cso.options(sim) == built
    for leg, (e, k, _) in (("parity", jax_runs[1]), ("tuned", jax_runs[3])):
        assert rec["emi_iters"][leg] == e.tolist(), leg
        assert rec["knp_iters"][leg] == k.tolist(), leg
    assert set(rec["diffs"]) == set(ref["diffs"])
    for key, v in ref["diffs"].items():
        assert abs(rec["diffs"][key] - v) <= 1e-9, key
    assert 0 < rec["max_rel_diff"] <= ref["tol"] and rec["passed"] == ref["passed"]
    for key in ("knp_iters_parity", "knp_iters_tuned", "tuned_min_iter_clip_frac"):
        assert rec[key] == ref[key], key
    assert rec["dtype"] == "float64" and rec["device"] == "cpu" and rec["nvidia_smi"] is None
    assert set(states) == {"parity", "tuned"}


def test_compare_keeps_the_first_step_and_starts_from_a_state():
    """From a state, without warm-up: the tuned leg's first step kept on
    the host is the simulation's own step with its options after the
    comparison (which restored them)."""
    sim = cso.build(8, device="cpu", solver={**PER_ION, **TUNED})
    state = sim.run(sim.init_state(), 12)[0]
    rec, states = cso.compare(sim, 4, 2, TUNED, state=state, warmup=False,
                              parity=dict(rtol_knp=1e-7, rtol_emi=1e-6), keep_first=True)
    assert rec["from_step"] == 12 and not rec["warmup"]
    assert rec["options"]["parity"]["rtol_knp"] == 1e-7
    own = sim.step(state)
    for f in ("c", "phi", "phi_M"):
        for k, v in getattr(own, f).items():
            assert torch.equal(getattr(states["tuned_first"], f)[k], v)
    assert int(states["tuned_first"].step) == 13 and int(states["tuned"].step) == 16
    assert len(rec["knp_iters"]["tuned"]) == 4


def test_compare_main_exits_1_below_the_measured_difference(tmp_path, capsys):
    out = tmp_path / "rec.json"
    argv = ["--mesh-n", "8", "--steps", "3", "--chunk", "3", "--device", "cpu",
            "--out", str(out)]
    assert cso.main(argv + ["--tol", "1e-12"]) == 1
    rec = json.loads(out.read_text())
    assert rec["max_rel_diff"] > 1e-12 and not rec["passed"] and rec["mesh_n"] == 8
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec
    assert cso.main(argv + ["--tol", str(2 * rec["max_rel_diff"])]) == 0


def test_stress_mg_refresh_equals_jax_tool(jax_runs, monkeypatch, capsys):
    ref = _jax_tool_json(monkeypatch, capsys, "stress_mg_refresh", "--mesh-n", 8, "--steps",
                         20, "--chunk", 5, "--refresh-every", 10, "--f-scale", 4,
                         "--duty", 1.0)
    assert len(jax_runs) == 2
    cfg = load_config(CONFIG_DIR / "baseline.yml")
    cfg.update(mesh_n=8, solver={**PER_ION, "mg_refresh_async": False})
    rec = smr.stress(cfg, 20, 5, 10, f_scale=4.0, duty=1.0, device="cpu")
    capsys.readouterr()
    for leg, (e, _, kmax) in zip(("stale", "fresh"), jax_runs):
        assert rec["emi_iters"][leg] == e.tolist(), leg
        port = [c[f"k_e_max_{leg}"] for c in rec["chunks"]]
        np.testing.assert_allclose(port, kmax, rtol=1e-9, atol=0)
    assert rec["refresh_counts"] == {"installed": 1, "skipped": 0}
    assert not rec["mg_refresh_async"] and all(rec["converged"].values())
    for key in ("dofs", "steps", "f_value", "refresh_every"):
        assert rec[key] == ref[key], key
    assert round(rec["k_e_max_final"], 3) == ref["k_e_max_final"]
    for key in ("stale_it_first10", "stale_it_tail", "fresh_it_tail"):
        assert round(rec[key], 2) == ref[key], key
    # the excursion: well above the initial ECS K+
    assert rec["k_e_max_final"] > 3.1 + 10.0


def test_stressed_inputs_equal_a_build_of_the_stressed_config():
    """The chip run's route (the flagship's inputs, the source scaled by 4)
    gives the ions and gate of a build of the stressed config."""
    from knpemi_tpu_torch.drivers.run_stim_duration import build_simulation
    from knpemi_tpu_torch.parallel.programs import simulation_inputs

    cfg = load_config(CONFIG_DIR / "baseline.yml")
    cfg["mesh_n"] = 8
    inputs = smr.stressed_inputs(simulation_inputs(build_simulation(cfg, "cpu")), cfg, 4.0,
                                 1.0)
    ref = simulation_inputs(build_simulation(smr.stress_config(cfg, 4.0, 1.0), "cpu"))
    for a, b in zip(inputs["ions"], ref["ions"]):
        assert set(a.f_source_q or {}) == set(b.f_source_q or {})
        for t in a.f_source_q or {}:
            assert np.array_equal(a.f_source_q[t], b.f_source_q[t])
    t = torch.linspace(0.0, 30.0, 301, dtype=torch.float64)
    assert torch.equal(inputs["source_gate"](t), ref["source_gate"](t))


def test_local_ecs_width_equals_jax_script():
    from knpemi_tpu.mesh.tissue import astrocyte_tissue_mesh as jax_mesh
    from knpemi_tpu.ops.geometry import build_geometry as jax_geometry
    from knpemi_tpu_torch.mesh.tissue import astrocyte_tissue_mesh
    from knpemi_tpu_torch.ops.geometry import build_geometry
    from knpemi_tpu_torch.tools.compute_local_width import local_ecs_width

    jax_script = _load(ROOT / "examples" / "astrocyte" / "tools" / "compute_local_width.py",
                       "jax_compute_local_width")
    ref = jax_script.local_ecs_width(jax_geometry(jax_mesh(0, n=8)), 1, 2)
    out = local_ecs_width(build_geometry(astrocyte_tissue_mesh(0, n=8)), 1, 2)
    assert out.shape == ref.shape and len(out) > 0
    assert np.array_equal(out, ref)


def test_synthetic_emimesh_equals_jax_script(tmp_path, capsys):
    """Each package's file, read back by each package's reader and remarked
    (emimesh 1 -> ECS 0, 7 -> 1, 100 -> 2, nm -> cm), builds one geometry."""
    from knpemi_tpu.io import read_mesh as jax_read
    from knpemi_tpu.mesh.tissue import remark_emimesh as jax_remark
    from knpemi_tpu.ops.geometry import build_geometry as jax_geometry
    from knpemi_tpu_torch.io import read_mesh
    from knpemi_tpu_torch.mesh.tissue import remark_emimesh
    from knpemi_tpu_torch.ops.geometry import build_geometry
    from knpemi_tpu_torch.tools import make_synthetic_emimesh as mse

    jax_script = _load(ROOT / "examples" / "astrocyte" / "tools" / "make_synthetic_emimesh.py",
                       "jax_make_synthetic_emimesh")
    paths = {"jax": tmp_path / "jax" / "mesh.xdmf", "port": tmp_path / "port" / "mesh.xdmf"}
    sys_argv = sys.argv
    try:
        sys.argv = ["make_synthetic_emimesh.py", "--n", "8", "--out", str(paths["jax"])]
        jax_script.main()
    finally:
        sys.argv = sys_argv
    mse.main(["--n", "8", "--out", str(paths["port"])])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split(":", 1)[1] == lines[1].split(":", 1)[1]
    remark = dict(ecs_tag_in=1, scale=1e-7, tag_map={7: 1, 100: 2})
    names = dict(cell_tag_name=mse.CELL_TAGS, facet_tag_name=mse.FACET_TAGS)
    geoms = []
    for path in paths.values():
        geoms.append(jax_geometry(jax_remark(jax_read(path, **names), **remark)))
        geoms.append(build_geometry(remark_emimesh(read_mesh(path, **names), **remark)))
    g0 = geoms[0]
    assert sorted(g0.subdomains) == [0, 1, 2] and sorted(g0.membranes) == [1, 2]
    for g in geoms[1:]:
        assert g.emi_size == g0.emi_size
        for t, s in g0.subdomains.items():
            assert np.array_equal(np.asarray(g.subdomains[t].coords), np.asarray(s.coords))
            assert np.array_equal(np.asarray(g.subdomains[t].cells), np.asarray(s.cells))
        for m, s in g0.membranes.items():
            assert np.array_equal(np.asarray(g.membranes[m].coords), np.asarray(s.coords))
            assert g.membranes[m].cell_tag == s.cell_tag


def test_read_meshstats_and_roi_points_equal_jax_scripts(tmp_path, capsys):
    import yaml

    from knpemi_tpu_torch.tools import find_roi_points, read_meshstats

    tools = ROOT / "examples" / "astrocyte" / "tools"
    jax_stats = _load(tools / "read_meshstats.py", "jax_read_meshstats")
    full = {"volumes": {1: 2.5e9, 7: 1.0e8}, "surfaces": {7: 3.0e6}, "other": 4}
    bare = {"n_vertices": 120, "n_cells": 400}
    for i, stats in enumerate((full, bare)):
        path = tmp_path / f"stats{i}.yml"
        path.write_text(yaml.safe_dump(stats))
        assert read_meshstats.read_meshstats(path) == jax_stats.read_meshstats(path)
    assert read_meshstats.main([str(tmp_path / "stats0.yml")]) == {
        k: full[k] for k in ("volumes", "surfaces")}
    capsys.readouterr()
    jax_roi = _load(tools / "find_roi_points.py", "jax_find_roi_points")
    sys_argv = sys.argv
    try:
        sys.argv = ["find_roi_points.py"]
        jax_roi.main()
    finally:
        sys.argv = sys_argv
    ref = capsys.readouterr().out
    find_roi_points.main([])
    out = capsys.readouterr().out
    assert out == ref and out.count("Coordinates of point") >= 3
