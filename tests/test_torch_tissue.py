"""The astrocyte tissue flagship of the port against the JAX package's.

Module by module on the same seeded numpy inputs (float64): the tissue
meshes and their geometry, array for array; the ``hh_mv`` and ``glial``
membrane models (1e-12 relative, including V at the rate singularities);
the source-box indicator, the pulsed gate over t in [0, 120] ms and the
static source vector; ``ASTROCYTE_BASELINE`` against the YAML file.

Then the slice as a whole at ``mesh_n=10``, ``dt=0.1``: 13 float64 steps,
past the source onset (the gate first reads t >= 1 at the 12th step,
where ten additions of 0.1 have given 0.9999999999999999).  The JAX
example's ``build_simulation`` on the CPU takes its per-ion KNP branch;
the port with ``knp_batched=False`` must match it in EMI and KNP
iteration counts step for step and in phi, phi_M and c to 1e-9 relative.
With both tolerances at 1e-12 the port's batched branch must give the
same fields to 1e-8 (the two Krylov processes differ, their converged
answers do not).
"""

import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples" / "astrocyte"))

from knpemi_tpu.mesh import tissue as jtissue
from knpemi_tpu.models import get_model as jget_model
from knpemi_tpu.ops.geometry import build_geometry as jbuild
from knpemi_tpu.sim import config as jconfig

from knpemi_tpu_torch.mesh import tissue as ttissue
from knpemi_tpu_torch.models import available_models, get_model as tget_model
from knpemi_tpu_torch.ops.geometry import build_geometry as tbuild
from knpemi_tpu_torch.sim import ASTROCYTE_BASELINE, SolverOptions, build_astrocyte
from knpemi_tpu_torch.sim import config as tconfig

BASELINE_YML = ROOT / "examples" / "astrocyte" / "config_files" / "baseline.yml"
N_STEPS = 13
ONSET = 11  # index of the first step whose source gate is on


# ---------------------------------------------------------------------------
# host data
# ---------------------------------------------------------------------------
MESHES = [
    ("astrocyte_tissue_mesh", dict(n=10)),
    ("two_cell_tissue_mesh", dict(resolution=0)),
]


@pytest.mark.parametrize("name,kw", MESHES, ids=[m[0] for m in MESHES])
def test_tissue_mesh_and_geometry_equal(name, kw):
    mj, mt = getattr(jtissue, name)(**kw), getattr(ttissue, name)(**kw)
    for f in ("points", "cells", "cell_tags", "facet_tags"):
        np.testing.assert_array_equal(getattr(mj, f), getattr(mt, f), err_msg=f)
    gj, gt = jbuild(mj), tbuild(mt)
    assert gj.sub_tags == gt.sub_tags and gj.emi_offsets() == gt.emi_offsets()
    assert sorted(gj.membranes) == sorted(gt.membranes)
    for t in gj.subdomains:
        a, b = gj.subdomains[t], gt.subdomains[t]
        for f in ("vertices", "parent_cells", "cells", "coords", "grads", "vols"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    for m in gj.membranes:
        a, b = gj.membranes[m], gt.membranes[m]
        assert a.cell_tag == b.cell_tag
        for f in ("facet_dofs", "facet_edofs", "facet_idofs", "areas",
                  "mem_to_ecs", "mem_to_ics", "vertices", "coords"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def test_remark_and_roi_equal():
    """remark_emimesh (tag map, scaling, slab split) and find_roi_points."""
    from knpemi_tpu.mesh import Mesh as JMesh
    from knpemi_tpu_torch.mesh import Mesh as TMesh

    base = jtissue.astrocyte_tissue_mesh(n=10)
    tags = np.where(base.cell_tags == 0, 1, np.where(base.cell_tags == 2, 100, 7))
    kw = dict(ecs_tag_in=1, scale=1e-3, tag_map={100: 2, 7: 1},
              membrane_slab_cuts=[0.2, 0.3], membrane_slab_tags=[5, 6, 7])
    out = []
    for mod, cls in ((jtissue, JMesh), (ttissue, TMesh)):
        raw = cls(points=base.points * 1e3, cells=base.cells.copy(), cell_tags=tags.copy())
        out.append(mod.remark_emimesh(raw, **kw))
    for f in ("points", "cells", "cell_tags", "facet_tags"):
        np.testing.assert_array_equal(getattr(out[0], f), getattr(out[1], f), err_msg=f)
    assert set(np.unique(out[1].cell_tags)) == {0, 1, 2}
    lo, hi = (1e-4, 1e-4, 1e-4), (4e-4, 4e-4, 4e-4)
    np.testing.assert_array_equal(jtissue.find_roi_points(base.points, lo, hi),
                                  ttissue.find_roi_points(base.points, lo, hi))


# ---------------------------------------------------------------------------
# membrane models
# ---------------------------------------------------------------------------
def _model_inputs(name, n=64):
    """Seeded states and parameters of physiological size, mV units; the
    first V values sit on and next to the rate singularities."""
    ode = tget_model(name)
    rng = np.random.default_rng(11)
    y = np.tile(ode.init_states(), (n, 1))
    p = np.tile(ode.init_params(Cm=1.0, psi=96500e3 / (8.315e3 * 307e3)), (n, 1))
    iv = ode.state_indices("V")
    y[:, iv] = rng.uniform(-100.0, 40.0, n)
    y[:6, iv] = [-40.0, -55.0, -40.0 + 1e-7, -55.0 - 1e-7, -40.0 - 1e-3, -55.0 + 1e-3]
    for gate in ("m", "h", "n"):
        if gate in ode.state_names:
            y[:, ode.state_indices(gate)] = rng.uniform(0.01, 0.99, n)
    for ion, (lo_e, hi_e, lo_i, hi_i) in dict(
            K=(2.0, 12.0, 90.0, 130.0), Na=(120.0, 150.0, 8.0, 20.0),
            Cl=(110.0, 140.0, 4.0, 8.0)).items():
        p[:, ode.parameter_indices(f"{ion}_e")] = rng.uniform(lo_e, hi_e, n)
        p[:, ode.parameter_indices(f"{ion}_i")] = rng.uniform(lo_i, hi_i, n)
    p[:, ode.parameter_indices("stim_amplitude")] = rng.uniform(0.0, 5.0, n)
    return y, p


@pytest.mark.parametrize("t", [0.0, 3.7, 31.0, 130.0])
@pytest.mark.parametrize("name", ["hh_mv", "glial"])
def test_membrane_model_matches_jax(name, t):
    oj, ot = jget_model(name), tget_model(name)
    assert tuple(oj.state_names) == tuple(ot.state_names)
    assert tuple(oj.param_names) == tuple(ot.param_names)
    np.testing.assert_array_equal(oj.default_states, ot.default_states)
    np.testing.assert_array_equal(oj.default_params, ot.default_params)
    y, p = _model_inputs(name)
    tj = jnp.asarray(t, jnp.float64)
    dyj = np.asarray(jax.vmap(lambda yy, pp: oj.rhs(tj, yy, pp))(
        jnp.asarray(y), jnp.asarray(p)))
    cuj = np.asarray(jax.vmap(lambda yy, pp: jnp.stack(oj.currents(tj, yy, pp)))(
        jnp.asarray(y), jnp.asarray(p)))
    tt = torch.tensor(t, dtype=torch.float64)
    dyt = ot.rhs(tt, torch.as_tensor(y), torch.as_tensor(p)).numpy()
    cut = torch.stack(ot.currents(tt, torch.as_tensor(y), torch.as_tensor(p)), dim=1).numpy()
    assert np.isfinite(dyt).all() and np.isfinite(cut).all()
    np.testing.assert_allclose(dyt, dyj, rtol=1e-12, atol=1e-12 * np.abs(dyj).max())
    np.testing.assert_allclose(cut, cuj, rtol=1e-12, atol=1e-12 * np.abs(cuj).max())


def test_registry():
    assert {"hh", "hh_mv", "glial"} <= set(available_models())
    ode = tget_model("glial")
    assert ode.init_params(I_max=3.0)[ode.parameter_indices("I_max")] == 3.0
    assert ode.init_states(V=-70.0)[ode.state_indices("V")] == -70.0
    assert ode.parameter_indices("K_e", "K_i") == [10, 11]
    assert ode.init_params()[ode.parameter_indices("I_max")] == 10.75975


# ---------------------------------------------------------------------------
# configuration and the ECS source
# ---------------------------------------------------------------------------
def test_baseline_equals_yaml():
    ref = jconfig.load_config(BASELINE_YML)
    assert tconfig.load_config(BASELINE_YML) == ref
    assert tconfig.DEFAULTS == jconfig.DEFAULTS
    assert set(ASTROCYTE_BASELINE) == set(ref)
    for k, v in ref.items():
        assert ASTROCYTE_BASELINE[k] == v, k


def test_pulsed_gate_matches_jax():
    cfg = dict(ASTROCYTE_BASELINE)
    t = np.concatenate([np.linspace(0.0, 120.0, 4801),
                        np.cumsum(np.full(1200, 0.1))])  # the stepper's own clock
    gj = np.asarray(jconfig.pulsed_source_gate(cfg)(jnp.asarray(t)))
    gt = tconfig.pulsed_source_gate(cfg)(torch.as_tensor(t))
    assert gt.dtype == torch.float64
    np.testing.assert_array_equal(gt.numpy(), gj)
    assert 0 < gt.sum() < len(t)
    # a 0-d time, as the step passes it
    g0 = tconfig.pulsed_source_gate(cfg)(torch.tensor(1.5, dtype=torch.float64))
    assert g0.shape == () and float(g0) == 1.0


@pytest.fixture(scope="module")
def sims():
    """(JAX example's simulation, the port's per-ion simulation), mesh_n 10."""
    import run_stim_duration as R

    cfg = {**jconfig.load_config(BASELINE_YML), "mesh_n": 10}
    simJ = R.build_simulation(cfg, dtype=jnp.float64)
    assert not simJ.knp_sys.use_pallas  # the per-ion (vmapped) branch
    simT = build_astrocyte({**ASTROCYTE_BASELINE, "mesh_n": 10},
                           dtype=torch.float64, device="cpu",
                           solver_options=SolverOptions(
                               rtol_emi=1e-6, rtol_knp=1e-7, knp_batched=False,
                               mg_refresh_every=simJ.opts.mg_refresh_every))
    return simJ, simT


def test_source_indicator_and_vector_match_jax(sims):
    simJ, simT = sims
    cfg = ASTROCYTE_BASELINE
    lo = (cfg["x_L"], cfg["y_L"], cfg["z_L"])
    hi = (cfg["x_U"], cfg["y_U"], cfg["z_U"])
    qj = jconfig.source_box_indicator_q(simJ.geom, 0, lo, hi, 2.0)
    qt = tconfig.source_box_indicator_q(simT.geom, 0, lo, hi, 2.0)
    np.testing.assert_array_equal(qt, qj)
    assert 0 < qt.sum() < 2.0 * qt.size
    for t in simJ.knp_sys.tags:
        vj, vt = simJ.knp_sys._src_vec[t], simT.knp_sys._src_vec[t]
        assert (vj is None) == (vt is None)
        if vj is not None:
            vj = np.asarray(vj)
            assert np.abs(vj[0]).max() > 0  # K row; the Cl row is zero
            np.testing.assert_allclose(vt.numpy(), vj, rtol=0,
                                       atol=1e-14 * np.abs(vj).max())
    assert simT.knp_sys._src_vec[0] is not None and simT.knp_sys._src_vec[1] is None


def test_initial_state_and_params_match_jax(sims):
    """Three subdomains, two membranes, the params0 overwrite."""
    simJ, simT = sims
    sJ, sT = jax.device_get(simJ.init_state()), simT.init_state()
    assert sorted(sT.c) == [0, 1, 2] and sorted(sT.phi_M) == [1, 2]
    for f in ("c", "phi", "phi_M", "ode_states", "ode_params"):
        for k, v in getattr(sJ, f).items():
            np.testing.assert_array_equal(getattr(sT, f)[k].numpy(), np.asarray(v),
                                          err_msg=f"{f}[{k}]")
    assert simT.params.psi == simJ.params.psi
    assert simT.opts.rtol_emi == simJ.opts.rtol_emi == 1e-6
    assert simT.opts.mg_refresh_every == simJ.opts.mg_refresh_every == 100


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------
def _run_jax(sim, n):
    step = jax.jit(sim.step)
    out, s = [], sim.init_state()
    for _ in range(n):
        s = step(s)
        out.append(jax.device_get(s))
    return out


def _run_port(sim, n):
    out, s = [], sim.init_state()
    for _ in range(n):
        s = sim.step(s)
        out.append(s)
    return out


@pytest.fixture(scope="module")
def runs(sims):
    simJ, simT = sims
    return _run_jax(simJ, N_STEPS), _run_port(simT, N_STEPS)


def _assert_fields_close(sJ, sT, rtol):
    """phi (defined up to the null-space constant both solvers fix the same
    way), phi_M and c, each relative to the field's largest magnitude;
    c elementwise relative."""
    for t in sJ.phi:
        ref = np.asarray(sJ.phi[t])
        scale = max(np.abs(np.asarray(v)).max() for v in sJ.phi.values())
        np.testing.assert_allclose(sT.phi[t].numpy(), ref, rtol=0, atol=rtol * scale)
    for m in sJ.phi_M:
        ref = np.asarray(sJ.phi_M[m])
        np.testing.assert_allclose(sT.phi_M[m].numpy(), ref, rtol=rtol, atol=0)
    for t in sJ.c:
        np.testing.assert_allclose(sT.c[t].numpy(), np.asarray(sJ.c[t]), rtol=rtol, atol=0)


@pytest.mark.parametrize("step", range(N_STEPS))
def test_per_ion_step_matches_jax_example(runs, step):
    sJ, sT = runs[0][step], runs[1][step]
    assert int(sT.emi_iters) == int(sJ.emi_iters)
    assert int(sT.knp_iters) == int(sJ.knp_iters)
    assert bool(sT.emi_ok) and bool(sT.knp_ok)
    assert float(sT.t) == float(sJ.t)
    _assert_fields_close(sJ, sT, 1e-9)


@pytest.fixture(scope="module")
def both_branches():
    """The port's ion-batched branch (K3 on the P1 operator, the drift
    filled once per solve by K11f) and its per-ion branch (K11 with each
    ion's assembled P_b), the KNP solves to rtol 1e-12 so that their
    tolerance does not hide how far the two operators agree."""
    runs = {}
    for batched in (True, False):
        sim = build_astrocyte({**ASTROCYTE_BASELINE, "mesh_n": 10}, dtype=torch.float64,
                              device="cpu", solver_options=SolverOptions(
                                  rtol_emi=1e-6, rtol_knp=1e-12, knp_batched=batched,
                                  mg_refresh_every=100))
        runs[batched] = _run_port(sim, N_STEPS)
    return runs


@pytest.mark.parametrize("step", range(N_STEPS))
def test_batched_k3_matches_per_ion_k11(both_branches, step):
    """Over the source onset: equal EMI and KNP iterations, phi_M and c
    within 1e-9 relative."""
    sB, sP = both_branches[True][step], both_branches[False][step]
    assert int(sB.emi_iters) == int(sP.emi_iters)
    assert int(sB.knp_iters) == int(sP.knp_iters)
    assert bool(sB.emi_ok) and bool(sB.knp_ok)
    for m in sP.phi_M:
        np.testing.assert_allclose(sB.phi_M[m].numpy(), sP.phi_M[m].numpy(), rtol=1e-9,
                                   atol=0)
    for t in sP.c:
        np.testing.assert_allclose(sB.c[t].numpy(), sP.c[t].numpy(), rtol=1e-9, atol=0)


def test_carry_over_from_jax_state_at_the_onset(sims, runs):
    """JAX state before the onset step -> interop -> one port step == the
    JAX onset step (three subdomains, two membranes, two ODE models)."""
    from knpemi_tpu_torch.interop import state_from_numpy, state_to_numpy

    statesJ = runs[0]
    s = state_from_numpy(statesJ[ONSET - 1], "cpu", torch.float64)
    back = state_to_numpy(s)
    for f in ("c", "phi", "phi_M", "ode_states", "ode_params"):
        assert sorted(back[f]) == sorted(getattr(statesJ[ONSET - 1], f))
    s = sims[1].step(s)
    assert int(s.step) == ONSET + 1
    assert int(s.knp_iters) == int(statesJ[ONSET].knp_iters)
    _assert_fields_close(statesJ[ONSET], s, 1e-9)


def test_source_raises_K_e_in_both(runs):
    statesJ, statesT = runs
    K0 = 3.092970607490389
    for states, get in ((statesJ, lambda s: float(np.asarray(s.c[0][0]).max())),
                        (statesT, lambda s: float(s.c[0][0].max()))):
        before = [get(s) for s in states[:ONSET]]
        after = [get(s) for s in states[ONSET:]]
        assert max(before) < K0 + 1e-3       # resting: no source yet
        assert min(after) > K0 + 1.0         # the pulse adds mM within a step
        assert after[-1] > after[0]


def test_batched_matches_jax_at_tight_tolerance():
    """The port's ion-batched branch against the JAX per-ion run, both
    solved to rtol 1e-12, over the source onset: the same fields to 1e-8."""
    import run_stim_duration as R

    tight = dict(rtol_emi=1e-12, rtol_knp=1e-12)
    cfg = {**jconfig.load_config(BASELINE_YML), "mesh_n": 10, "solver": tight}
    simJ = R.build_simulation(cfg, dtype=jnp.float64)
    simT = build_astrocyte({**ASTROCYTE_BASELINE, "mesh_n": 10, "solver": tight},
                           dtype=torch.float64, device="cpu")
    assert simT.opts.knp_batched and simT.opts.rtol_knp == 1e-12
    # run_stim_duration.py's refresh cadence, taken over by default
    assert simT.opts.mg_refresh_every == simJ.opts.mg_refresh_every == 100
    sJ, sT = _run_jax(simJ, N_STEPS)[-1], _run_port(simT, N_STEPS)[-1]
    assert bool(sT.emi_ok) and bool(sT.knp_ok)
    assert float(sT.c[0][0].max()) > 4.0
    _assert_fields_close(sJ, sT, 1e-8)
