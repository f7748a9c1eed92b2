"""The port's other drivers against the JAX package's, on the CPU.

* ``drivers/run_2d.py`` at resolution 1 in float64 (100 steps, the probe
  every 5): the golden fixture's gates of ``tests/test_golden_traces.py``
  (probe trace and final phi_M within 2e-4 V, final concentrations
  within 3e-3 relative under that test's dof map, which
  ``chip_smoke.golden_dof_maps`` reproduces without JAX), and the JAX
  example's ``solve_system`` traces (its XLA path, as JAX runs on the
  CPU) within 1e-9 of the phi_M swing;
* the benchmark scenario (``sim.build_two_cell``, the driver
  ``drivers/run_benchmark.py``) on a coarse two-cell tissue (n = 10,
  built by each package's ``mesh.tissue._build`` from the same arrays,
  membranes split into tags 5, 6, 7) against the JAX example's
  ``build_simulation``, float64, 4 steps (the source gate opens at the
  fourth): the port on its per-ion KNP branch, the one JAX takes on the
  CPU, equal EMI and KNP iterations, phi, phi_M and c within 1e-9
  relative; the probe points equal JAX's;
* every driver's ``main`` with ``--device cpu`` at tiny settings writes
  what it should: ``run_benchmark`` (also with ``--mesh``), ``run_2d``,
  ``run_3d`` and ``run_calibration`` (``--plot``).
"""

import importlib.util
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from knpemi_tpu_torch.drivers import run_2d as R2
from knpemi_tpu_torch.drivers import run_3d as R3
from knpemi_tpu_torch.drivers import run_benchmark as RB
from knpemi_tpu_torch.drivers import run_calibration as RC
from knpemi_tpu_torch.sim import SolverOptions

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "data" / "golden_2d_res1.npz"


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def run2d():
    sim = R2.build_simulation(1, device="cpu")
    assert sim.dtype == torch.float64
    state, it_e, it_k, traces = R2.solve_system(1, save_every=5, verbose=False, sim=sim)
    return sim, state, it_e, it_k, traces


def _jax_golden_maps():
    """tests/test_golden_traces.py's map: the JAX geometry under the Morton
    order the fixture was made in."""
    sys.path.insert(0, str(ROOT / "examples" / "idealized"))
    import run_2d as J

    os.environ["KNPEMI_ORDER"] = "morton"
    try:
        return J.build_simulation(resolution=1).geom
    finally:
        os.environ.pop("KNPEMI_ORDER")


def test_run_2d_meets_the_golden_fixture(run2d):
    sim, state, it_e, it_k, traces = run2d
    g = np.load(GOLDEN)
    assert R2.probe_dof(sim) == int(g["probe"])
    assert len(it_e) == 100 and len(traces["phi_M_probe"]) == 20
    np.testing.assert_allclose(np.asarray(traces["phi_M_probe"]), g["phi_M_probe"], atol=2e-4)
    np.testing.assert_allclose(state.phi_M[1].numpy(), g["phi_M_final"], atol=2e-4)
    geom_m = _jax_golden_maps()
    maps = {}
    for tag, sub in sim.geom.subdomains.items():
        inv = np.full(int(sub.vertices.max()) + 1, -1, dtype=np.int64)
        inv[np.asarray(sub.vertices)] = np.arange(sub.n_dofs)
        maps[tag] = inv[np.asarray(geom_m.subdomains[tag].vertices)]
        assert (maps[tag] >= 0).all()
    np.testing.assert_allclose(state.c[0].numpy()[:, maps[0]], g["c_final_ecs"], rtol=3e-3)
    np.testing.assert_allclose(state.c[1].numpy()[:, maps[1]], g["c_final_ics"], rtol=3e-3)
    # chip_smoke's map, made without JAX, is this one; its reading holds
    ours = chip_smoke.golden_dof_maps(sim)
    for tag in maps:
        np.testing.assert_array_equal(ours[tag], maps[tag])
    rec = chip_smoke.golden_2d(sim, state, traces)
    assert rec["held"] and rec["probe_max_abs_dV"] <= 2e-4


def test_run_2d_matches_the_jax_example(run2d):
    _, state, it_e, it_k, traces = run2d
    J = _load("jax_run_2d", ROOT / "examples" / "idealized" / "run_2d.py")
    sJ, ie, ik, tJ = J.solve_system(1, Tstop=1.0e-2, save_every=5, verbose=False)
    np.testing.assert_array_equal(it_e, np.asarray(ie))
    np.testing.assert_array_equal(it_k, np.asarray(ik))
    swing = float(np.ptp(np.asarray(tJ["phi_M_probe"])))
    assert swing > 0.1  # the action potential: ~134 mV
    for k in R2.TRACE_KEYS:
        np.testing.assert_allclose(np.asarray(traces[k]), np.asarray(tJ[k]), rtol=0,
                                   atol=1e-9 * swing, err_msg=k)
    np.testing.assert_allclose(state.phi_M[1].numpy(), np.asarray(sJ.phi_M[1]), rtol=0,
                               atol=1e-9 * swing)


# ---------------------------------------------------------------------------
# the benchmark scenario
# ---------------------------------------------------------------------------
def _two_cell_mesh(tissue, n=10, L=5.0):
    """two_cell_tissue_mesh's construction at n cells a side."""
    UM = tissue.UM
    cell = ((0.5 * UM, 1.0 * UM, 1.0 * UM), (4.5 * UM, 2.0 * UM, 2.0 * UM), 1)
    mesh = tissue._build(n, n, n, (0, 0, 0), (L * UM, L * UM, L * UM), [cell])
    mesh.facet_tags = np.zeros(mesh.n_facets, np.int32)
    tissue.split_membrane_x_slabs(mesh, 1, [2.0 * UM, 3.0 * UM], [5, 6, 7])
    mesh.facet_tags[mesh.exterior_facet_mask()] = tissue.EXTERIOR_BOUNDARY_TAG
    return mesh


N_BENCH = 4


@pytest.fixture(scope="module")
def bench():
    from knpemi_tpu.mesh import tissue as jt
    from knpemi_tpu_torch.mesh import tissue as tt

    mj, mt = _two_cell_mesh(jt), _two_cell_mesh(tt)
    for f in ("points", "cells", "cell_tags", "facet_tags"):
        np.testing.assert_array_equal(getattr(mj, f), getattr(mt, f))
    J = _load("jax_benchmark", ROOT / "examples" / "benchmark" / "run_stim_duration.py")
    simJ = J.build_simulation(mesh=mj, dtype=jnp.float64)
    assert not simJ.knp_sys.use_pallas  # the per-ion branch
    simT = RB.build_simulation(mesh=mt, device="cpu", solver_options=SolverOptions(
        rtol_emi=1e-5, rtol_knp=1e-7, knp_batched=False))
    step = jax.jit(simJ.step)
    sJ, sT, outJ, outT = simJ.init_state(), simT.init_state(), [], []
    for _ in range(N_BENCH):
        sJ, sT = step(sJ), simT.step(sT)
        outJ.append(jax.device_get(sJ))
        outT.append(sT)
    return J, simJ, simT, outJ, outT


def test_benchmark_scenario_is_the_jax_one(bench):
    J, simJ, simT, _, _ = bench
    assert sorted(simT.geom.membranes) == [5, 6, 7] and sorted(simT.mem_models) == [5, 6, 7]
    assert simT.params.dt == simJ.params.dt == 0.1
    for a, b in zip(simJ.ions, simT.ions):
        assert (a.name, a.z, a.D, a.c_init) == (b.name, b.z, b.D, b.c_init)
    sJ, sT = jax.device_get(simJ.init_state()), simT.init_state()
    for f in ("c", "phi_M", "ode_states", "ode_params"):
        for k, v in getattr(sJ, f).items():
            np.testing.assert_array_equal(getattr(sT, f)[k].numpy(), np.asarray(v))
    for t in (0.0, 0.2, 0.30000000000000004):
        assert float(simT.source_gate(torch.tensor(t, dtype=torch.float64))) == float(
            simJ.source_gate(jnp.asarray(t)))
    assert J._probe_points(simJ) == RB._probe_points(simT)


@pytest.mark.parametrize("step", range(N_BENCH))
def test_benchmark_steps_match_jax(bench, step):
    _, _, _, outJ, outT = bench
    sJ, sT = outJ[step], outT[step]
    assert int(sT.emi_iters) == int(sJ.emi_iters)
    assert int(sT.knp_iters) == int(sJ.knp_iters)
    assert bool(sT.emi_ok) and bool(sT.knp_ok)
    scale = max(np.abs(np.asarray(v)).max() for v in sJ.phi.values())
    for t in sJ.phi:
        np.testing.assert_allclose(sT.phi[t].numpy(), np.asarray(sJ.phi[t]), rtol=0,
                                   atol=1e-9 * scale)
    for m in sJ.phi_M:
        np.testing.assert_allclose(sT.phi_M[m].numpy(), np.asarray(sJ.phi_M[m]), rtol=1e-9)
    for t in sJ.c:
        np.testing.assert_allclose(sT.c[t].numpy(), np.asarray(sJ.c[t]), rtol=1e-9)


def test_benchmark_source_turns_on_at_the_fourth_step(bench):
    _, _, simT, _, outT = bench
    K = [float(s.c[0][0].max()) for s in outT]
    # the source's K+ enters from the fourth step, whose start time is past 0.2 ms
    assert K[3] - K[2] > 10 * abs(K[2] - K[1])


# ---------------------------------------------------------------------------
# the drivers' command lines
# ---------------------------------------------------------------------------
def test_run_benchmark_main_writes_traces(tmp_path, capsys):
    RB.main(["--Tstop", "0.3", "--outdir", str(tmp_path), "--device", "cpu"])
    tr = np.load(tmp_path / "traces.npz")
    assert set(tr.files) == set(RB.TRACE_KEYS)
    assert len(tr["t"]) == 3 and np.isfinite(np.stack([tr[k] for k in tr.files])).all()
    for fname, key in RB.TXT_EXPORTS:
        np.testing.assert_allclose(np.loadtxt(tmp_path / f"{fname}.txt"), tr[key], atol=1e-9)
    out = capsys.readouterr().out
    assert "membrane 7" in out and "K_e in" in out


def test_run_benchmark_main_reads_a_mesh_file(tmp_path):
    pytest.importorskip("h5py")
    from knpemi_tpu_torch.io import write_mesh
    from knpemi_tpu_torch.mesh import tissue as tt

    write_mesh(tmp_path / "two_cell.xdmf", _two_cell_mesh(tt))
    RB.main(["--mesh", str(tmp_path / "two_cell.xdmf"), "--Tstop", "0.2",
             "--outdir", str(tmp_path / "out"), "--device", "cpu"])
    assert len(np.load(tmp_path / "out" / "traces.npz")["t"]) == 2


def test_run_2d_main_writes_traces_and_snapshots(tmp_path, capsys):
    R2.main(["--Tstop", "5e-4", "--outdir", str(tmp_path), "--device", "cpu"])
    tr = np.load(tmp_path / "run2d_res1.npz")
    assert set(tr.files) == set(R2.TRACE_KEYS) and len(tr["t"]) == 1
    snaps = np.load(tmp_path / "run2d_res1_snapshots.npz")
    assert {"0_t", "0_phi_M", "0_phi_e", "0_phi_i", "0_c_K_0", "0_c_Na_1"} <= set(snaps.files)
    assert "average iterations emi" in capsys.readouterr().out


def test_run_3d_main_runs(capsys):
    R3.main(["--Tstop", "3e-4", "--g-syn-bar", "10", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "res 0: 3 steps" in out and "average number of iterations emi" in out


def test_run_calibration_main_prints_and_plots(tmp_path, capsys):
    pytest.importorskip("matplotlib")
    RC.main(["--steps", "60", "--device", "cpu", "--plot", str(tmp_path / "cal.png")])
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if "_init = " in ln]
    assert [ln.split("_init")[0] for ln in lines] == list(RC.get_model("calibration").state_names)
    assert (tmp_path / "cal.png").stat().st_size > 0


def test_run_calibration_plot_needs_matplotlib(monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(RuntimeError, match="matplotlib"):
        RC.run(n_steps=1, plot="x.png", device="cpu", verbose=False)
