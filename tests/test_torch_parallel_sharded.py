"""The dof-sharded mode (``parallel/sharded.py``, ``sharded_mg.py``) on
gloo ranks on the CPU, float64, one intra-op thread a rank.

* ``distributed_mg=False`` (the single-device hierarchy, replicated), 2
  and 4 ranks, 2 steps of the 2-D res-1 case with a hierarchy of real
  levels: the port's single-device step to 1e-8, equal iterations (the
  JAX package's ``test_sharded_step_matches_single_device`` gate).
* The astrocyte tissue at ``mesh_n`` 10 (three subdomains, two membrane
  models, the ECS source), 4 ranks, 2 steps past the source's onset:
  the same gate.
* The distributed V-cycle, 4 ranks, 2 steps of the 2-D res-1 case with
  the per-ion KNP solve: the JAX package's ``ShardedSimulation`` on 4
  virtual devices (its XLA path), equal iterations, fields to 1e-9; the
  hop counts of every window and of the partition equal JAX's.
* A JAX state carried in (``interop.scatter_state``, from the JAX
  package's padded-global layout) and continued one step: the fields of
  JAX continuing on one device, to 1e-9.
* The sharded banded matvec with far entries against scipy (JAX's
  ``test_smv_far_entries_match_scipy``).
The ranks import no JAX.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

from knpemi_tpu_torch.interop import gather_state, scatter_state
from knpemi_tpu_torch.parallel import launch, programs
from knpemi_tpu_torch.sim import ASTROCYTE_BASELINE, SolverOptions, build_astrocyte, build_idealized
from knpemi_tpu_torch.sim.config import pulsed_source_gate

from test_torch_slice import jax_simulation

N_STEPS = 2
TISSUE = {**ASTROCYTE_BASELINE, "mesh_n": 10}
WARM = 12  # single-device steps before the tissue's sharded ones: past the onset


def _idealized(**opts):
    return functools.partial(build_idealized, dim=2, resolution=1, g_syn_bar=10.0,
                             dtype=torch.float64, solver_options=SolverOptions(**opts))


def jax_steps(sim, state, n):
    step = jax.jit(sim.step)
    out = []
    for _ in range(n):
        state = step(state)
        out.append(jax.device_get(state))
    return out


def _jax_padded(sh, s):
    """The JAX package's padded-global state (``pad_state``) on the host."""
    return jax.device_get(sh.pad_state(s))


@pytest.fixture(scope="module")
def jax_runs():
    from knpemi_tpu.parallel.sharded import ShardedSimulation

    simJ = jax_simulation(jnp.float64, use_pallas=False)
    sh = ShardedSimulation(simJ, devices=jax.devices()[:4])
    s, dist_states = sh.init_state(), []
    for _ in range(N_STEPS):
        s = sh.step(s)
        dist_states.append(jax.device_get(sh.unpad_state(s)))
    hops = {"emi": [[(w.hop_lo, w.hop_hi) for w in lm.wins] for lm in sh.emi_smg_meta.levels]}
    for t, m in sh.knp_smg_meta.items():
        hops[t] = [[(w.hop_lo, w.hop_hi) for w in lm.wins] for lm in m.levels]
    n_hops = {t: p.n_hops for t, p in sh.parts.items()}
    # one device: 2 steps, then the carried state's step
    simX = jax_simulation(jnp.float64, use_pallas=False, mg_coarse_max=100)
    single = jax_steps(simX, simX.init_state(), N_STEPS + 1)
    shX = ShardedSimulation(simX, devices=jax.devices()[:4], distributed_mg=False)
    carried = _jax_padded(shX, jax.tree.map(jnp.asarray, single[N_STEPS - 1]))
    return dict(dist=dist_states, hops=hops, n_hops=n_hops, single=single, carried=carried)


@pytest.fixture(scope="module")
def ranks4(jax_runs):
    rng = np.random.default_rng(7)
    n = 8 * 256 * 2  # the JAX test's size
    A = sp.diags([-1.0, 2.5, -1.0], [-1, 0, 1], shape=(n, n)).tolil()
    rr, cc = rng.integers(0, n, 200), rng.integers(0, n, 200)
    A[rr, cc] = rng.standard_normal(200)
    A = A.tocsr()
    x = rng.standard_normal(n)
    carried = {f: getattr(jax_runs["carried"], f) for f in
               ("c", "phi", "phi_M", "ode_states", "ode_params", "t", "step", "emi_iters",
                "knp_iters", "emi_ok", "knp_ok", "emi_res", "knp_res")}
    carried = {f: ({k: np.asarray(a) for k, a in v.items()} if isinstance(v, dict)
                   else np.asarray(v)) for f, v in carried.items()}
    tissue = functools.partial(build_astrocyte, TISSUE, dtype=torch.float64,
                               solver_options=SolverOptions(mg_coarse_max=100))
    cases = [
        ("sharded", dict(build=_idealized(mg_coarse_max=100), n_steps=N_STEPS,
                         distributed_mg=False, reference=True)),
        ("sharded", dict(build=tissue, n_steps=N_STEPS, distributed_mg=False,
                         reference=True, warm=WARM)),
        ("sharded", dict(build=_idealized(knp_batched=False), n_steps=N_STEPS,
                         distributed_mg=True)),
        ("sharded", dict(build=_idealized(knp_batched=False, mg_coarse_max=100), n_steps=1,
                         distributed_mg=False, state=carried)),
        ("smv", dict(A=A, x=x)),
    ]
    res = launch(programs.run_cases, 4, "gloo", "cpu", args=(cases,), threads=1, deadline=600)
    return res, A, x


@pytest.fixture(scope="module")
def ranks2():
    cases = [("sharded", dict(build=_idealized(mg_coarse_max=100), n_steps=N_STEPS,
                              distributed_mg=False, reference=True))]
    return launch(programs.run_cases, 2, "gloo", "cpu", args=(cases,), threads=1, deadline=600)


def _close(got, ref, rtol, atol_phi):
    for t in ref["phi"]:
        np.testing.assert_allclose(got["phi"][t], np.asarray(ref["phi"][t]), rtol=rtol,
                                   atol=atol_phi)
    for t in ref["c"]:
        np.testing.assert_allclose(got["c"][t], np.asarray(ref["c"][t]), rtol=rtol)
    for m in ref["phi_M"]:
        np.testing.assert_allclose(got["phi_M"][m], np.asarray(ref["phi_M"][m]), rtol=rtol,
                                   atol=atol_phi)


def _as_tree(s):
    return {f: getattr(s, f) for f in ("c", "phi", "phi_M", "emi_iters", "knp_iters")}


@pytest.mark.parametrize("step", range(N_STEPS))
@pytest.mark.parametrize("world", (2, 4))
def test_sharded_replicated_hierarchy_matches_single_device(ranks2, ranks4, world, step):
    r = (ranks2 if world == 2 else ranks4[0])[0]["results"][0]
    got, ref = r["states"][step], r["ref"][step]
    assert int(got["emi_iters"]) == int(ref["emi_iters"]) >= 2
    assert int(got["knp_iters"]) == int(ref["knp_iters"])
    _close(got, ref, 1e-8, 1e-10)


@pytest.mark.parametrize("step", range(N_STEPS))
def test_sharded_tissue_matches_single_device(ranks4, step):
    r = ranks4[0][0]["results"][1]
    got, ref = r["states"][step], r["ref"][step]
    assert int(got["emi_iters"]) == int(ref["emi_iters"])
    assert int(got["knp_iters"]) == int(ref["knp_iters"])
    _close(got, ref, 1e-8, 1e-10)
    # three subdomains, two membranes, and the source is on in these steps
    assert len(got["c"]) == 3 and len(got["phi_M"]) == 2
    t = torch.as_tensor(float(r["start"]["t"]) + step * TISSUE["dt"], dtype=torch.float64)
    assert float(pulsed_source_gate(TISSUE)(t)) == 1.0


@pytest.mark.parametrize("step", range(N_STEPS))
def test_distributed_vcycle_matches_jax(ranks4, jax_runs, step):
    got = ranks4[0][0]["results"][2]["states"][step]
    ref = _as_tree(jax_runs["dist"][step])
    assert int(got["emi_iters"]) == int(ref["emi_iters"])
    assert int(got["knp_iters"]) == int(ref["knp_iters"])
    _close(got, ref, 1e-9, 1e-9)


def test_hop_counts_equal_jax(ranks4, jax_runs):
    r = ranks4[0][0]["results"][2]
    assert r["hops"] == jax_runs["hops"]
    assert r["n_hops"] == jax_runs["n_hops"]


def test_carried_jax_state_continues_as_jax(ranks4, jax_runs):
    r = ranks4[0][0]["results"][3]
    got, ref = r["states"][0], _as_tree(jax_runs["single"][N_STEPS])
    assert int(got["emi_iters"]) == int(ref["emi_iters"])
    assert int(got["knp_iters"]) == int(ref["knp_iters"])
    _close(got, ref, 1e-9, 1e-9)


def test_smv_far_entries_match_scipy(ranks4):
    res, A, x = ranks4
    r = res[0]["results"][4]
    assert r["f_max"] > 0  # the far path is exercised
    y_ref = A @ x
    assert np.abs(r["y"] - y_ref).max() <= 1e-13 * np.abs(y_ref).max()
    # the far columns ride the one neighbour exchange
    assert r["counts"]["smv/halo"]["calls"] == 1 and "smv/far" not in r["counts"]


def test_ranks_load_no_jax(ranks2, ranks4):
    for res in (ranks2, ranks4[0]):
        assert not any(r["jax"] for r in res)


def test_state_round_trip(ranks4):
    """scatter_state / gather_state between a whole-domain state and the
    ranks' blocks, for 4 ranks' partition, on the host."""
    sim = build_idealized(dim=2, resolution=1, device="cpu",
                          solver_options=SolverOptions(direct=True))
    s = sim.init_state()
    blocks = scatter_state(sim, s, 4)
    assert len(blocks) == 4
    assert sum(b.c[0].shape[1] for b in blocks) == sim.geom.subdomains[0].n_dofs
    back = gather_state(sim, blocks)
    for t in s.c:
        assert torch.equal(back.c[t], s.c[t]) and torch.equal(back.phi[t], s.phi[t])
