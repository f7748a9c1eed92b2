"""The port's float32 step against the JAX package's float32 Pallas step.

2-D res 1, one step, both in float32 (compensated dots, equilibrated
solvers): the tolerances of tests/test_pallas.py:89-95, whose float32
Krylov paths also differ in operation order — phi_M within 3e-6 V and
concentrations within 2e-5 relative — with equal KNP and EMI iteration
counts within 1.
"""

import numpy as np
import jax.numpy as jnp
import torch

from knpemi_tpu_torch.sim import build_idealized

from test_torch_slice import assert_step_close, jax_simulation, run_jax, run_port


def test_step_f32_matches_jax_pallas():
    simJ = jax_simulation(jnp.float32, use_pallas=True)
    simT = build_idealized(dim=2, resolution=1, g_syn_bar=10.0,
                           dtype=torch.float32, device="cpu")
    (sJ,) = run_jax(simJ, 1)
    (sT,) = run_port(simT, 1)
    assert sT.c[0].dtype == torch.float32
    assert_step_close(sJ, sT, phi_atol=3e-6, c_rtol=2e-5, elim_rtol=2e-5,
                      emi_slack=1)
    for t in sJ.c:
        assert np.isfinite(sT.c[t].numpy()).all()
