"""The port's coupled step against the JAX package's exact (XLA) path.

The JAX XLA assembly path gathers exactly, as the port does, so in
float64 the two agree to roundoff: equal iteration counts, phi_M and
concentrations within 1e-12.  A small ``mg_coarse_max`` gives the 2-D
res-1 hierarchies real levels, so the V-cycle is part of the check
(the default 800 leaves them a single coarse solve at this size).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from knpemi_tpu_torch.sim import SolverOptions, build_idealized

from test_torch_slice import jax_simulation, run_jax, run_port

N_STEPS = 2


@pytest.fixture(scope="module")
def runs():
    simJ = jax_simulation(jnp.float64, use_pallas=False, mg_coarse_max=100)
    simT = build_idealized(dim=2, resolution=1, g_syn_bar=10.0,
                           dtype=torch.float64, device="cpu",
                           solver_options=SolverOptions(mg_coarse_max=100))
    assert len(simT._emi_hier.levels) >= 1
    return run_jax(simJ, N_STEPS), run_port(simT, N_STEPS)


@pytest.mark.parametrize("step", range(N_STEPS))
def test_step_f64_matches_jax_xla(runs, step):
    sJ, sT = runs[0][step], runs[1][step]
    assert int(sT.emi_iters) == int(sJ.emi_iters)
    assert int(sT.knp_iters) == int(sJ.knp_iters)
    for m in sJ.phi_M:
        np.testing.assert_allclose(sT.phi_M[m].numpy(), np.asarray(sJ.phi_M[m]),
                                   rtol=0, atol=1e-12)
    for t in sJ.c:
        np.testing.assert_allclose(sT.c[t].numpy(), np.asarray(sJ.c[t]),
                                   rtol=1e-12, atol=0)
    for m in sJ.ode_states:
        np.testing.assert_allclose(sT.ode_states[m].numpy(),
                                   np.asarray(sJ.ode_states[m]), rtol=1e-12, atol=1e-15)
