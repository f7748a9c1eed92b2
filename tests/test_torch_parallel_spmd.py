"""The replicate-dofs SPMD mode (``parallel/spmd.py``) on gloo ranks.

For N = 1, 2 and 4 ranks on the CPU (one launch each, one intra-op
thread a rank), 2 steps of the 2-D res-1 case with a hierarchy that has
real levels (``mg_coarse_max=100``): every field of every step has the
same bits as the port's single-device step, in float64 and in float32;
and, in float64, it agrees with the JAX package's single-device step on
its exact (XLA) path within ``test_torch_slice_xla.py``'s gates (equal
iterations, 1e-12).  The ranks import no JAX, and the steps go through
the backend (gathers counted by site).
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from knpemi_tpu_torch.parallel import launch, programs
from knpemi_tpu_torch.sim import SolverOptions, build_idealized

from test_torch_slice import jax_simulation

N_STEPS = 2
WORLDS = (1, 2, 4)
DTYPES = {"f64": torch.float64, "f32": torch.float32}


def _build(dtype):
    return functools.partial(build_idealized, dim=2, resolution=1, g_syn_bar=10.0,
                             dtype=dtype, solver_options=SolverOptions(mg_coarse_max=100))


@pytest.fixture(scope="module")
def runs():
    out = {}
    for n in WORLDS:
        cases = [("spmd", dict(build=_build(dt), n_steps=N_STEPS)) for dt in DTYPES.values()]
        res = launch(programs.run_cases, n, "gloo", "cpu", args=(cases,), threads=1,
                     deadline=600)
        out[n] = res
    return out


@pytest.fixture(scope="module")
def jax_run():
    import jax

    sim = jax_simulation(jnp.float64, use_pallas=False, mg_coarse_max=100)
    step, s, out = jax.jit(sim.step), sim.init_state(), []
    for _ in range(N_STEPS):
        s = step(s)
        out.append(jax.device_get(s))
    return out


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("world", WORLDS)
def test_spmd_step_is_bitwise_the_single_device_step(runs, world, dtype):
    r = runs[world][0]["results"][list(DTYPES).index(dtype)]
    assert r["bitwise"]
    for a, b in zip(r["ref"], r["states"]):
        assert int(a["emi_iters"]) == int(b["emi_iters"]) >= 1
        for t in a["c"]:
            assert a["c"][t].tobytes() == b["c"][t].tobytes()
        for m in a["ode_states"]:
            assert a["ode_states"][m].tobytes() == b["ode_states"][m].tobytes()


@pytest.mark.parametrize("world", WORLDS)
def test_spmd_step_matches_jax(runs, jax_run, world):
    r = runs[world][0]["results"][0]
    for sJ, sT in zip(jax_run, r["states"]):
        assert int(sT["emi_iters"]) == int(sJ.emi_iters)
        assert int(sT["knp_iters"]) == int(sJ.knp_iters)
        for m in sJ.phi_M:
            np.testing.assert_allclose(sT["phi_M"][m], np.asarray(sJ.phi_M[m]), rtol=0,
                                       atol=1e-12)
        for t in sJ.c:
            np.testing.assert_allclose(sT["c"][t], np.asarray(sJ.c[t]), rtol=1e-12, atol=0)


@pytest.mark.parametrize("world", WORLDS)
def test_spmd_ranks_load_no_jax_and_gather_rows(runs, world):
    for rank, res in enumerate(runs[world]):
        assert res["jax"] is False, rank
        for r in res["results"]:
            # the rows of every apply and the ODE rows, gathered by the backend
            assert r["counts"]["rows"]["calls"] > 0 and r["counts"]["ode"]["calls"] > 0
            assert set(r["counts"]) <= {"rows", "ode"}
            assert r["totals"]["staged"] == 0
