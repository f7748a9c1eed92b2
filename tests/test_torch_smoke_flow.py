"""``chip_smoke.py`` as a module: what can be said of it without a card.

The script needs a CUDA device to run.  Here it is only imported: the
import must touch neither ``torch`` nor the port, the flagship is fixed
at its full width (no argument makes it smaller), and ``main`` refuses
to run without CUDA.
"""

import inspect
from pathlib import Path
import sys

import pytest

import chip_smoke


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread a test: the flows are thousands of small ops,
    which the threads of several test processes on one host slow down
    (the drivers flow: 37 s alone with one thread, 875 s with the default
    threads among six test processes on one host)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_flagship_is_fixed_at_full_width():
    assert (chip_smoke.MESH_N, chip_smoke.FLAGSHIP_DOFS) == (64, 840_015)
    assert list(inspect.signature(chip_smoke.flagship).parameters) == [
        "build_astrocyte", "baseline", "SolverOptions"]


def test_every_kernel_has_a_source_and_a_tpu_origin():
    assert len(chip_smoke.KERNEL_SOURCES) == 14
    # K11f fills the drift of both KNP branches; K11 is the per-ion one's
    assert set(chip_smoke.BATCHED_PATH) == set(chip_smoke.KERNEL_SOURCES) - {"K11"}
    assert "K11f" in chip_smoke.ASSEMBLY
    assert set(chip_smoke.CELL_KERNELS) < set(chip_smoke.ASSEMBLY)


def test_main_refuses_without_cuda(capsys):
    assert chip_smoke.main() == 1
    out = capsys.readouterr()
    assert out.out == "" and "CUDA is not available" in out.err


def test_step_diff_reads_an_ab_by_kernel_name(tmp_path, capsys):
    """``--step-diff`` on the host: parent, change, change, parent legs of
    both multigrid paths; the change drops kernel "a", adds "c" and
    slows "b" at an equal count."""
    import json

    def leg(pkg, banded, ms, kernels):
        return json.dumps(dict(phase="step_profile", package=pkg, mg_banded=banded,
                               device_kernel_ms_per_step=ms, all_kernels=kernels))

    parent = {"a": [1.0, 4.0], "b": [2.0, 8.0]}
    change = {"b": [2.5, 8.0], "c": [0.25, 2.0]}
    legs = []
    for pkg, kernels, ms in (("P", parent, 3.0), ("C", change, 2.75),
                             ("C", change, 2.75), ("P", parent, 3.5)):
        legs += [leg(pkg, False, ms, kernels), leg(pkg, True, ms, kernels)]
    path = tmp_path / "ab.txt"
    path.write_text("\n".join(["NVIDIA H100", *legs]) + "\n")
    assert chip_smoke.main(["--step-diff", str(path)]) == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["mg_banded"] for r in rows] == [False, True]
    for r in rows:
        assert r["parent_ms"] == [3.0, 3.5] and r["change_ms"] == [2.75, 2.75]
        assert r["change_less_parent_ms"] == -0.5 and r["parent_spread_ms"] == 0.5
        assert r["net_count_moved_ms"] == -0.75 and r["net_count_equal_ms"] == 0.5
        assert [(t["name"], t["ms"]) for t in r["top"]] == [("a", -1.0), ("b", 0.5),
                                                          ("c", 0.25)]


def test_environment_line_names_h5py_and_yaml():
    rec = chip_smoke.environment("NVIDIA H100 80GB HBM3, 700.00 W")
    assert rec["phase"] == 0 and rec["case"] == "environment"
    assert {"h5py", "yaml", "nvidia_smi", "python"} <= set(rec)


def _on_the_cpu(monkeypatch, mesh_n=8):
    """The resume checks' CUDA calls made harmless, the driver's build on
    the CPU in float64, the flagship cut to ``mesh_n``."""
    import torch

    import knpemi_tpu_torch.io as tio
    from knpemi_tpu_torch.drivers import run_stim_duration as drv
    from knpemi_tpu_torch.sim import build_astrocyte

    load = tio.load_checkpoint
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a, **k: None)
    monkeypatch.setattr(tio, "load_checkpoint",
                        lambda p, device=None, dtype=None: load(p, device="cpu", dtype=dtype))
    monkeypatch.setattr(drv, "build_simulation", lambda c, device=None: build_astrocyte(
        c, dtype=torch.float64, device="cpu"))
    monkeypatch.setattr(chip_smoke, "MESH_N", mesh_n)


@pytest.mark.parametrize("h5py", [True, False], ids=["h5py", "no h5py"])
def test_resume_phase_flow_on_the_cpu(monkeypatch, tmp_path, h5py):
    """The resume phase's flow at mesh_n 8 on the CPU: two builds (the
    split leg's first part runs on the gold leg's, its resumed part on a
    build of its own), the gold and split legs bitwise equal in state and
    traces and, with h5py, in every XDMF dataset, the geometry read from
    the mesh file equal to the synthetic one; without h5py the line says
    so."""
    import importlib.util

    from knpemi_tpu_torch.sim import ASTROCYTE_BASELINE

    _on_the_cpu(monkeypatch)
    if not h5py:
        real = importlib.util.find_spec
        monkeypatch.setattr(importlib.util, "find_spec",
                            lambda name, *a: None if name == "h5py" else real(name, *a))
    # (h): the banded flagship build of the same options, here on the CPU,
    # against which the gold leg's build is held
    import torch

    from knpemi_tpu_torch.sim import SolverOptions, build_astrocyte
    from knpemi_tpu_torch.sim.stepper import _to_host

    fresh = build_astrocyte({**ASTROCYTE_BASELINE, "mesh_n": 8}, dtype=torch.float64,
                            device="cpu", solver_options=SolverOptions(
                                mg_banded=True, knp_batched=True, **chip_smoke.TUNED))
    monkeypatch.setitem(chip_smoke.HOST_SETUP, "builds", [])
    monkeypatch.setitem(chip_smoke.HOST_SETUP, "fresh", dict(
        hierarchy_sha=chip_smoke.hierarchy_sha(fresh),
        first_step=_to_host(fresh.step(fresh.init_state()))))
    rec = chip_smoke.resume_phase(ASTROCYTE_BASELINE, tmp_path)
    assert chip_smoke.HOST_SETUP["fresh_vs_cached"]["identical"]
    assert "fresh" not in chip_smoke.HOST_SETUP
    assert [b["build"] for b in chip_smoke.HOST_SETUP["builds"]] == [
        "resume gold", "resume split resumed"]
    assert rec["legs"]["split first"]["build"] == "the gold leg's"
    assert rec["identical"] and rec["traces_equal_before_checkpoint"]
    assert list(rec["legs"]) == ["gold", "split first", "split resumed"]
    n, stop = chip_smoke.RESUME_STEPS, chip_smoke.RESUME_STOP
    assert [rec["legs"][k]["steps"] for k in rec["legs"]] == [n, stop, n - stop]
    assert sum(rec["legs"]["split resumed"]["knp_iters"]) > 0
    if h5py:
        assert rec["mesh_file"]["geometry_equal"] and rec["xdmf"]["datasets"] > 0
    else:
        assert rec["xdmf"] == "h5py not installed"
        assert rec["mesh_file"].startswith("h5py not installed")
    assert rec["checkpoint_bytes"] > 0 and rec["step"] == n


def test_in_process_resume_flow_on_the_cpu(monkeypatch, tmp_path):
    import torch

    from knpemi_tpu_torch.sim import ASTROCYTE_BASELINE, SolverOptions, build_astrocyte

    _on_the_cpu(monkeypatch)
    sim = build_astrocyte({**ASTROCYTE_BASELINE, "mesh_n": 8}, dtype=torch.float32,
                          device="cpu", solver_options=SolverOptions(mg_banded=True,
                                                                     **chip_smoke.TUNED))
    state, *_ = sim.run(sim.init_state(), 12)
    rec = chip_smoke.resume_in_process(sim, state, tmp_path)
    assert rec["identical"] and rec["from_step"] == 12 and rec["checkpoint_bytes"] > 0
    assert chip_smoke.step_determinism(sim, state)["identical"]


def test_campaign_phase_flow_on_the_cpu(monkeypatch, tmp_path):
    """The ``campaign`` phase's flow at mesh_n 8 on the CPU (the CPU
    launches no kernel, so no kernel is required): the driver's two
    float32 legs joined at the resume seam in the log, the summary's
    gates, the float64 accuracy leg resumed at 1 ms, its final fields
    float64, and compared under the envelope gates, and the DCP round
    trip."""
    import torch

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "CAMPAIGN_DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "CAMPAIGN", {**chip_smoke.CAMPAIGN, "mesh_n": 8})
    monkeypatch.setattr(chip_smoke, "reachable_kernels", lambda sim: set())
    rec, launches = chip_smoke.campaign_phase(tmp_path)
    assert not any(launches.values())
    assert [leg["steps"] for leg in rec["legs"]] == [10, 10]
    assert rec["chunk_ends"] == [5, 10, 15, 20]
    assert rec["summary"]["n_saves"] == 4 and rec["summary"]["stimulated_phase"]["chunks"] == 4
    log = (tmp_path / "campaign.log").read_text()
    assert "resumed from" in log and log.count("set-up") == 2
    env = rec["envelope"]
    assert env["t_final_ms"] == rec["summary"]["t_final_ms"]
    assert set(env["final_rel_l2"]) == {"phi_M_1", "phi_M_2", "phi_0", "c_K_0", "c_Na_0",
                                        "c_K_1"}
    # float32 against float64: a difference, inside the gates
    assert all(0 < env[k] <= lim for k, lim in rec["gates"].items())
    assert min(env["final_rel_l2"].values()) > 0 and rec["twin_final_dtypes"] == ["float64"]
    assert rec["dcp"]["identical"] and rec["dcp"]["bytes"] > 0
    assert sum(rec["legs"][1]["knp_iters"]) > 0


def test_far_add_cases_cover_every_far_remainder_on_the_cpu():
    """``far_cases`` on the 3-D res-1 banded scenario on the CPU: a case for
    every banded operator of the EMI and KNP hierarchies that has a far
    remainder, one vector counted under K5 and a batch under K6b, the
    first timed, each case's kernel and plain version on the same inputs
    leaving them as they were, a bound of positive bytes, and the step
    able to reach K5 (and K6b where a KNP hierarchy has a far remainder)."""
    import torch

    from knpemi_tpu_torch.sim import SolverOptions, build_idealized

    sim = build_idealized(dim=3, resolution=1, dtype=torch.float64, device="cpu",
                          solver_options=SolverOptions(mg_banded=True))
    hier = {"EMI": sim.emi_solver.mg, **{f"KNP tag {t}": mg for t, mg
                                         in sorted(sim.knp_solver.mg.items())}}
    n_far = {h: len(chip_smoke._far_bands(mg)) for h, mg in hier.items()}
    assert n_far["EMI"] >= 1
    for h, mg in hier.items():
        Bs = (None,) if h == "EMI" else (2, 1, 8)
        cases = chip_smoke.far_cases(mg, h, torch.float64, Bs)
        assert len(cases) == n_far[h] * len(Bs)
        assert [c["time"] for c in cases] == [k == 0 for k in range(len(cases))]
        for c in cases:
            want = "K5 ellw_rmatvec" if "one vector" in c["variant"] else \
                "K6b ellw_rmatvec_batch"
            assert c["name"] == want and c["variant"].startswith("far add")
            assert c["nbytes"] > 0 and c["ops"] > 0 and c["tol"]["float64"] == 1e-13
            y1, y2 = c["kern"](), c["plain"]()
            assert torch.equal(y1, y2) and torch.equal(c["kern"](), y1)
    knp_far = sum(v for h, v in n_far.items() if h != "EMI")
    assert {"K5", *(("K6b",) if knp_far else ())} <= chip_smoke.reachable_kernels(sim)


def test_mms_phase_flow_on_the_cpu(monkeypatch):
    """The ``mms`` phase's flow on the CPU with the 3-D study at M = 4, 8,
    16 (the card runs 8, 16, 32) and the ladder's rungs at M = 32, 64 (the
    card runs 100, 200): every gate passes (rates, per ion against
    batched, iterative against direct at M = 16, the second device's run
    at M = 8, here the CPU twice; the ladder's rate, iterative against
    direct and device against CPU), and the record has each M's errors,
    iterations and seconds.  One intra-op thread: the Krylov solves are
    thousands of small ops, which threads of several test processes on
    one host slow down ~30x."""
    import torch

    monkeypatch.setattr(chip_smoke, "MMS_DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "MMS_PATH", ())
    monkeypatch.setattr(chip_smoke, "MMS_MS", {3: (4, 8, 16), 2: (8, 16, 32)})
    monkeypatch.setattr(chip_smoke, "LADDER_MS", (32, 64))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out, counts = chip_smoke.mms_phase()
    finally:
        torch.set_num_threads(n)
    assert not any(counts.values())  # the CPU launches no kernel
    studies = {dim: out[dim] for dim in ("3-D", "2-D")}
    for dim, rec in studies.items():
        assert list(rec["per_M"]) == list(chip_smoke.MMS_MS[int(dim[0])])
        for f in chip_smoke.MMS_FIELDS:
            assert rec["rates"][f][-1] > rec["rate_gate"]
        for M, row in rec["per_M"].items():
            assert row["iters"]["emi"] > 0 and row["iters"]["knp_batched"] > 0
            assert ("knp_per_ion" in row["iters"]) == (M in chip_smoke.MMS_PER_ION_MS)
            assert row["solve_seconds"] > 0
    row8 = out["3-D"]["per_M"][8]
    assert row8["cpu_iters"] == row8["iters"] and row8["gpu_vs_cpu_max_rel"] == 0.0
    assert row8["repeat_bitwise"] and row8["repeat_iters"] == row8["iters"]
    for dim, rec in studies.items():
        rows = list(rec["per_M"].values())
        assert all(len(r["data_sha256"]["all"]) == 16 for r in rows)
        assert len({r["data_sha256"]["all"] for r in rows}) == len(rows)
        # the kernel checks at the largest M only: the EMI operator, and K3
        # and K11 twice on each subdomain, all bitwise across launches
        assert ["kernel_checks" in r for r in rows] == [False] * (len(rows) - 1) + [True]
        kc = rows[-1]["kernel_checks"]
        checks = {k: v for k, v in kc.items() if k != "systems_sha256"}
        assert len(checks) == 9 and all(v["deterministic"] for v in checks.values())
        assert all(v["max_abs_err"] <= 1e-13 * v["max_abs_y"] for v in checks.values())
        assert set(kc["systems_sha256"]) == {"emi_load", "knp_load", "knp_drift"}
    assert set(out["3-D"]["per_M"][16]["errors_direct"]) == set(chip_smoke.MMS_FIELDS)
    lad = out["ladder"]
    assert [r["M"] for r in lad["rungs"]] == [32, 64]
    assert all(lad["rates"][f][-1] > chip_smoke.LADDER_RATE for f in chip_smoke.MMS_FIELDS)
    assert all(r["converged"] == dict(emi=True, knp=True) and "fields" not in r
               for r in lad["rungs"])
    assert lad["cpu"]["iters"] == lad["rungs"][0]["iters"]
    assert lad["cpu"]["gpu_vs_cpu_max_rel"] == 0.0
    assert set(lad["direct"]["errors"]) == set(chip_smoke.MMS_FIELDS)


def test_drivers_phase_flow_on_the_cpu(monkeypatch):
    """The ``drivers`` phase's flow on the CPU (its card calls made
    harmless; the CPU launches no kernel, so no kernel is required): the
    benchmark scenario's kernel checks and its 20 steps with the K_e
    probe rising after the onset, GPU-vs-CPU parity (here the CPU twice),
    the 2-D driver meeting the golden fixture in float64 and float32,
    the 3-D driver and the calibration run."""
    import torch

    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(chip_smoke, "DRIVERS_DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "reachable_kernels", lambda sim: set())
    monkeypatch.setitem(chip_smoke.HOST_SETUP, "builds", [])
    out, launches = chip_smoke.drivers_phase()
    assert not any(launches.values())
    b = out["benchmark"]
    assert b["steps"] == 20 and b["dofs_per_step"] > 0
    assert sorted(b["phi_M_range_mV"]) == [5, 6, 7]
    assert b["K_e_probe_mM"][1] > b["K_e_probe_mM"][0]
    assert b["host_setup_detail"]["emi_assembly_cache"] in ("hit", "miss")
    names = {r["name"].split()[0] for r in out["kernel_checks"]["float64"]}
    assert names == {"K1", "K1f", "K2", "K3", "K4", "K9", "K10"}
    assert {r["variant"] for r in out["kernel_checks"]["float32"]
            if r["name"].startswith("K2")} == {"membrane 5", "membrane 6", "membrane 7"}
    p = out["benchmark_parity"]
    assert p["max_abs_dphi_M_mV"] == 0.0 and len(p["knp_iters"]) == 4
    for key in ("run_2d_res1_float64", "run_2d_res1_float32"):
        assert out[key]["held"] and out[key]["steps"] == 100 and out[key]["trace_len"] == 20
    assert out["run_3d_res0_float32"]["steps"] == 20
    assert out["calibration"]["max_rel_gpu_vs_cpu"] == 0.0


def test_flagship_build_records_on_the_cpu(tmp_path, monkeypatch):
    """(g) and (h)'s pieces on a small build: the set-up record, the native
    sweep against the plain one, and the hierarchy hashes and first steps
    of a fresh and a cached build, equal."""
    import torch

    from knpemi_tpu_torch.sim import SolverOptions, build_idealized, stepper
    from knpemi_tpu_torch.solvers import mg

    monkeypatch.setattr(stepper, "CACHE_DIR", tmp_path)
    monkeypatch.setattr(mg, "CACHE_DIR", tmp_path)
    build = lambda: build_idealized(dim=3, resolution=0, device="cpu",
                                    solver_options=SolverOptions(mg_banded=True,
                                                                 mg_coarse_max=100))
    fresh, cached = build(), build()
    rec = [chip_smoke.setup_record(k, s, 1.0) for k, s in (("a", fresh), ("b", cached))]
    assert [r["emi_assembly_cache"] for r in rec] == ["miss", "hit"]
    assert all(r["emi_multigrid"] > 0 and "knp_vanek_sweep" in r for r in rec)
    sweep = chip_smoke.native_sweep_check(fresh)
    assert sweep["identical"] and sweep["rows"] == fresh.geom.emi_size
    assert chip_smoke.hierarchy_sha(fresh) == chip_smoke.hierarchy_sha(cached)
    a, b = fresh.step(fresh.init_state()), cached.step(cached.init_state())
    assert not chip_smoke.differing_fields(a, b)
    other = build_idealized(dim=3, resolution=0, device="cpu",
                            solver_options=SolverOptions(mg_banded=True, mg_coarse_max=200))
    assert chip_smoke.hierarchy_sha(other) != chip_smoke.hierarchy_sha(fresh)
    assert torch.equal(a.phi[0], b.phi[0])


def test_multi_device_phase_flow_on_the_cpu(monkeypatch, tmp_path):
    """The ``multi_device`` phase's flow on the CPU at a small size: (a)-(c)
    on the 2-D res-1 case (4 gloo ranks; no NCCL here), (d) and (e) on the
    tissue at ``mesh_n`` 10 from a carried float32 state, every gate held
    (SPMD bitwise, 1e-8, CPU against CPU, the 1e-5 field-equivalence gate
    and the repeated steps' bits), the kernels' rows all held (here the
    plain versions against themselves) and the rank's launch counts
    returned.  One intra-op thread a rank."""
    import torch

    import pickle

    from knpemi_tpu_torch.interop import state_to_numpy
    from knpemi_tpu_torch.parallel.programs import simulation_inputs
    from knpemi_tpu_torch.sim import (ASTROCYTE_BASELINE, SolverOptions, build_astrocyte,
                                      build_idealized)

    fl = dict(mesh_n=10, keep=13, steps=2, repeat=1)
    monkeypatch.setattr(chip_smoke, "MD_DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "MD_NCCL", False)
    monkeypatch.setattr(chip_smoke, "MD_THREADS", 1)
    monkeypatch.setattr(chip_smoke, "MD_SMALL", dict(dim=2, resolution=1))
    monkeypatch.setattr(chip_smoke, "MD_FLAGSHIP", fl)
    monkeypatch.setattr(chip_smoke, "MD_PATH", ())
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        sim = build_astrocyte({**ASTROCYTE_BASELINE, "mesh_n": 10}, dtype=torch.float32,
                              device="cpu",
                              solver_options=SolverOptions(knp_batched=True, **chip_smoke.TUNED))
        s = sim.init_state()
        for _ in range(fl["keep"]):
            s = sim.step(s)
        kept, e, k = state_to_numpy(s), [], []
        for _ in range(fl["steps"]):
            s = sim.step(s)
            e.append(int(s.emi_iters))
            k.append(int(s.knp_iters))
        setup = tmp_path / "inputs.pkl"
        setup.write_bytes(pickle.dumps(simulation_inputs(sim)))
        monkeypatch.setattr(chip_smoke, "MD_CARRIED", dict(
            kept=kept, final=state_to_numpy(s), iters=list(zip(e, k)), setup=str(setup)))
        out, launches = chip_smoke.multi_device_phase(build_idealized, SolverOptions)
    finally:
        torch.set_num_threads(n)
    assert out["a_spmd"]["bitwise_gloo_4"] and out["a_spmd"]["bitwise_nccl_1"] is None
    assert out["c_distributed"]["iters"] == out["c_distributed"]["cpu_iters"]
    d = out["d_flagship"]
    assert d["repeat_bitwise"] and len(d["iters"]) == fl["steps"]
    assert len(d["memory_per_rank"]) == 4 and d["collectives_per_step"] > 0
    assert all(m["host_hwm"] or m["ru_maxrss"] for m in d["memory_per_rank"])
    assert set(d["setup_seconds"]) >= {"partition", "hierarchies", "scatter"}
    names = {r["name"].split()[0] for r in out["e_kernels"]}
    assert names >= {"K1", "K1f", "K2", "K3", "K4", "K7", "K8", "K9", "K10", "K11f"}
    assert all(r["held"] and r["deterministic"] for r in out["e_kernels"])
    assert not any(launches.values())  # the CPU launches no kernel


def test_warming_fills_the_cache_the_sharded_build_reads(tmp_path, monkeypatch):
    """``multi_device`` (d)'s warming on a small build: the distributed
    hierarchies over 4 ranks (the EMI one and one a subdomain) land in the
    cache, and the sharded mode's builds of the same operators then find
    each there (no hierarchy is built).  The warming process's flow:
    :func:`chip_smoke.finish_warming` fails the run with the output of a
    failed process."""
    import numpy as np
    import torch

    from knpemi_tpu_torch.parallel import sharded
    from knpemi_tpu_torch.parallel import sharded_mg as smg
    from knpemi_tpu_torch.sim import SolverOptions, build_idealized, stepper
    from knpemi_tpu_torch.solvers import mg

    monkeypatch.setattr(stepper, "CACHE_DIR", tmp_path)
    monkeypatch.setattr(mg, "CACHE_DIR", tmp_path)
    sim = build_idealized(dim=2, resolution=1, device="cpu", solver_options=SolverOptions())
    before = set(tmp_path.glob("*.pkl"))
    sharded.warm_distributed_hierarchies(sim, 4)
    assert len(set(tmp_path.glob("*.pkl")) - before) == 1 + len(sim.geom.sub_tags)

    def refuse(*a, **kw):
        raise AssertionError("a hierarchy was built, not read from the cache")

    monkeypatch.setattr(mg, "build_hierarchy", refuse)
    ops = list(sharded.distributed_operators(sim, 4))
    assert [k for k, *_ in ops] == ["emi", *sim.geom.sub_tags]
    for _, A0, parts, tags in ops:
        gids, L256, _ = smg.local_layout_gids(parts, tags, 4)
        smg.build_local(A0, gids, L256, 4, sim.opts, np.float32 if sim.dtype ==
                        torch.float32 else np.float64)
    w = chip_smoke.start_warming(str(tmp_path / "no-such-inputs.pkl"))
    with pytest.raises(AssertionError, match="no-such-inputs"):
        chip_smoke.finish_warming(w, timeout=120)
    assert not chip_smoke._WARMERS


def test_shared_mesh_builds_step_as_builds_from_scratch():
    """Phase 2's builder: a case's later builds, from a copy of the first
    build's mesh, geometry and membrane models, step as a build from
    scratch with the same options does, bitwise."""
    import torch

    from knpemi_tpu_torch.sim import SolverOptions, build_idealized

    build = chip_smoke.shared_mesh(build_idealized)
    kw = dict(dim=2, resolution=1, g_syn_bar=10.0, dtype=torch.float64, device="cpu")
    first = build(**kw, solver_options=SolverOptions())
    for opts in (SolverOptions(mg_banded=True), SolverOptions(mg_smoother="cheby", mg_degree=3)):
        shared, fresh = build(**kw, solver_options=opts), build_idealized(**kw, solver_options=opts)
        assert shared.geom is not first.geom and shared.opts == opts
        a, b = shared.run(shared.init_state(), 2)[0], fresh.run(fresh.init_state(), 2)[0]
        for f in ("phi", "phi_M", "c"):
            assert all(torch.equal(getattr(a, f)[k], getattr(b, f)[k]) for k in getattr(b, f))


def _phase2_cut(monkeypatch):
    """Phase 2 on the CPU at a small size: the card's legs on the CPU, the
    3-D res-1 case cut to 2-D res 1, the tissue to mesh_n 8, one option of
    each table and one cycle case (the CPU legs' process is handed the same
    constants)."""
    monkeypatch.setattr(chip_smoke, "PHASE2_DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "PARITY_CASE", dict(dim=2, resolution=1, g_syn_bar=10.0))
    monkeypatch.setattr(chip_smoke, "PARITY_ASTRO_MESH_N", 8)
    monkeypatch.setattr(chip_smoke, "OPTION_CASES", {"W-cycle": dict(gamma=2)})
    monkeypatch.setattr(chip_smoke, "OPTION_CASES_2D", {
        "emi_precond=jacobi": dict(emi_precond="jacobi", maxiter=4000)})
    monkeypatch.setattr(chip_smoke, "CYCLE_APPLY_CASES", {"W-cycle": dict(gamma=2)})


def test_phase2_flow_reads_the_cpu_legs_process_files(monkeypatch):
    """Phase 2's CPU legs in their own process, the card's legs (here on
    the CPU) held against what it wrote: every case passes, each CPU record
    in the phase's lines is the one read from the process's file, and an
    iteration count changed in what was read fails the comparison."""
    from knpemi_tpu_torch.sim import (ASTROCYTE_BASELINE, SolverOptions, build_astrocyte,
                                      build_idealized)

    _phase2_cut(monkeypatch)
    read = {}
    load = chip_smoke.load_cpu_legs

    def recording_load(out_dir):
        legs = load(out_dir)
        read.update(files=sorted(p.name for p in Path(out_dir).glob("leg_*.npz")), legs=legs)
        return legs

    monkeypatch.setattr(chip_smoke, "load_cpu_legs", recording_load)
    w = chip_smoke.start_phase2_cpu()
    cpu, timing = chip_smoke.finish_phase2_cpu(w)
    assert not Path(w["dir"]).exists() and not chip_smoke._WARMERS
    assert cpu is read["legs"] and list(cpu) == chip_smoke.phase2_keys()
    assert read["files"] == [f"leg_{i:02d}.npz" for i in range(len(cpu))]
    assert timing["seconds"] > 0
    build = chip_smoke.shared_mesh(build_idealized)
    par = chip_smoke.parity(build, SolverOptions, cpu)
    for path in chip_smoke.PARITY_PATHS:
        assert par[f"{path}_cpu"] is cpu[f"parity {path}"][0]
        assert par[f"{path}_cpu"]["seconds"] != par[f"{path}_cuda"]["seconds"]
    ref = chip_smoke.parity_refresh(build, SolverOptions, cpu)
    assert ref["ell_cpu"]["refresh_counts"] == {"installed": 2, "skipped": 0}
    ast = chip_smoke.parity_astrocyte(build_astrocyte, ASTROCYTE_BASELINE, SolverOptions, cpu)
    assert ast["per_ion_cpu"] is cpu["astrocyte per_ion"][0]
    opt = chip_smoke.parity_options(build, SolverOptions, cpu)
    assert all(opt[label]["cpu"] is cpu[f"options {label}"][0]
               for label in chip_smoke.option_runs())
    rec, state = cpu["parity ell"]
    cpu["parity ell"] = ({**rec, "knp_iters": [k + 1 for k in rec["knp_iters"]]}, state)
    with pytest.raises(AssertionError, match="iteration counts differ"):
        chip_smoke.parity(build, SolverOptions, cpu)


def test_a_failing_cpu_legs_process_fails_the_run(monkeypatch):
    """A CPU leg that raises fails the run with the process's output."""
    _phase2_cut(monkeypatch)
    monkeypatch.setattr(chip_smoke, "PARITY_CASE", dict(dim=2, resolution=1, g_syn_bar=10.0,
                                                        no_such_argument=1))
    w = chip_smoke.start_phase2_cpu()
    with pytest.raises(AssertionError, match="no_such_argument"):
        chip_smoke.finish_phase2_cpu(w, timeout=300)
    assert not Path(w["dir"]).exists() and not chip_smoke._WARMERS


def test_phase2_cases_and_gates_are_unchanged():
    """The CPU legs cover every case phase 2 held GPU against CPU before
    they moved to their own process, at the same sizes, steps and gates."""
    assert chip_smoke.PHASE2_DEVICE == "cuda"
    assert chip_smoke.PARITY_CASE == dict(dim=3, resolution=1, g_syn_bar=10.0)
    assert chip_smoke.PARITY_ASTRO_MESH_N == 20
    options = ["mg_smoother=cheby", "mg_nu=2", "knp_post_smooth=False", "W-cycle",
               "compensated_dots=True"]
    assert list(chip_smoke.OPTION_CASES) == options and chip_smoke.OPTION_STEPS_3D == 1
    assert list(chip_smoke.OPTION_CASES_2D) == ["direct=True", "emi_precond=jacobi"]
    assert chip_smoke.CYCLE_APPLY_TOL == {"emi": 1e-12, "knp": 1e-12, "emi W": 1e-10}
    assert chip_smoke.phase2_keys() == [
        "parity ell", "parity banded", "parity banded_per_ion", "refresh ell",
        "refresh banded", "astrocyte batched", "astrocyte per_ion",
        *(f"options 3-D res 1 {p}: {n}" for p in ("ell", "banded") for n in options),
        "options 2-D res 1: direct=True", "options 2-D res 1: emi_precond=jacobi",
        *(f"cycle {p}: {n}" for p in ("ell", "banded") for n in ("cheby", "W-cycle"))]
    runs = chip_smoke.option_runs()
    assert {steps for _, steps, _ in runs.values()} == {1, 2}
    assert [steps for label, (_, steps, _) in runs.items() if label.startswith("2-D")] == [2, 2]
    # the phase-2 gates: 1e-9 in phi_M and relative in c
    import types

    import torch

    one = lambda v: types.SimpleNamespace(phi_M={1: torch.tensor([v])},
                                          c={0: torch.tensor([[1.0]])})
    chip_smoke.gpu_vs_cpu(one(1e-9), one(0.0), "gate")
    with pytest.raises(AssertionError, match="gates 1e-9"):
        chip_smoke.gpu_vs_cpu(one(2e-9), one(0.0), "gate")


def test_tools_phase_flow_on_the_cpu(monkeypatch):
    """The ``tools`` phase's flow at mesh_n 8 on the CPU (the CPU launches no
    kernel, so none is required): compare from the batched run's last
    state under the 1e-5 gate with the tuned leg's first step the
    simulation's own, and the stress legs on a build from the batched
    build's inputs: 2 refreshes installed, ECS K+ up by more than 1 mM.
    Float64: at this size float32 rounding alone moves phi_e by more than
    the gate between any two option sets whose iteration counts differ
    (the card's float32 run is at mesh_n 64)."""
    import torch

    from knpemi_tpu_torch.parallel.programs import simulation_inputs
    from knpemi_tpu_torch.sim import ASTROCYTE_BASELINE, SolverOptions, build_astrocyte
    from knpemi_tpu_torch.sim.scenarios import K_E_INIT_A

    monkeypatch.setattr(chip_smoke, "reachable_kernels", lambda sim: set())
    monkeypatch.setattr(chip_smoke, "TOOLS_PATH", ())
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a, **k: None)
    config = {**ASTROCYTE_BASELINE, "mesh_n": 8}
    sim = build_astrocyte(config, dtype=torch.float64, device="cpu",
                          solver_options=SolverOptions(knp_batched=True, **chip_smoke.TUNED))
    state = sim.run(sim.init_state(), 22)[0]
    rec = chip_smoke.tools_phase(sim, simulation_inputs(sim), state, config)
    assert not any(rec["launches"].values())
    cmp, st = rec["compare"], rec["stress"]
    assert cmp["passed"] and cmp["tuned_first_step_is_own_step"] and cmp["from_step"] == 22
    assert cmp["options"]["tuned"]["min_iter_knp"] == 2
    assert cmp["options"]["parity"]["rtol_knp"] == 1e-7
    assert [len(cmp["emi_iters"][leg]) for leg in ("parity", "tuned")] == [10, 10]
    assert st["refresh_counts"] == {"installed": 2, "skipped": 0} and not st["mg_refresh_async"]
    assert len(st["chunks"]) == 3 and st["chunks"][-1]["k_e_max_stale"] > K_E_INIT_A + 1.0
    # the simulation keeps its own options
    assert (sim.knp_solver.min_iter, sim.knp_solver.rtol, sim.emi_solver.rtol) == (2, 3e-6, 1e-5)


def test_phase_seconds_groups_a_smoke_runs_lines(tmp_path, capsys):
    """``--phase-seconds``: each group's seconds from the ``script_s`` of its
    last line less the group before's; the tools phase is the flagship's,
    its own seconds beside; lines without ``script_s`` are skipped."""
    import json

    lines = [dict(phase=0, case="environment", script_s=1.0), dict(phase=0, script_s=3.0),
             dict(phase="drivers", case="run_benchmark (a-c)", script_s=10.0),
             dict(phase=1, case="launch floor", script_s=11.0),
             dict(phase=1, path="mg_banded=False", script_s=15.0),
             dict(phase=3, path="mg_banded=True", script_s=20.0),
             dict(phase=1, path="mg_banded=True l=4", script_s=30.0),
             dict(phase=1, path="flagship batched", script_s=40.0),
             dict(phase="tools", seconds=6.5, script_s=50.0),
             dict(phase=3, path="flagship banded", script_s=60.0),
             dict(phase="multi_device", script_s=70.0), dict(phase="resume", script_s=75.0),
             dict(phase="campaign", script_s=77.0), dict(phase=2, script_s=80.0),
             dict(phase=2, script_s=90.0), dict(phase="mms", script_s=95.0),
             dict(phase="drivers", case="the native sweep (g)", script_s=95.5),
             dict(phase=1, case="P1 operator per solve", script_s=96.0)]
    path = tmp_path / "smoke.txt"
    path.write_text("NVIDIA H100\n" + "\n".join(map(json.dumps, lines))
                    + '\n{"kernels": []}\n')
    assert chip_smoke.main(["--phase-seconds", str(path)]) == 0
    rec = json.loads(capsys.readouterr().out)
    want = [3.0, 7.0, 1.0, 9.0, 10.0, 30.0, 10.0, 5.0, 2.0, 13.0, 5.0, 1.0]
    assert [rec[g] for g in chip_smoke.PHASE_GROUPS] == want
    assert rec["of which tools"] == 6.5 and rec["script (to its last phase line)"] == 96.0
