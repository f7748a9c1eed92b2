"""The port's coupled step against the JAX package's, on the 2-D res-1 case.

The JAX ``Simulation`` runs its blocked-assembly configuration with ELL
multigrid (``use_pallas=True, mg_banded=False``, the Pallas kernels in
interpret mode); the port runs the same scenario on the CPU in float64
with the plain versions of its kernels.  Gates, step by step: KNP
iterations equal, EMI iterations within 1, phi_M within 1e-8 V, the
solved concentrations within 1e-7 relative.

The JAX Pallas path is only float32-accurate even in float64 (its bf16
three-pass gathers), and the eliminated ion, c_Na = sum_k z_k c_k up to
sign, inherits that error amplified by the cancellation (~10x in the
ICS, where c_Na ~ 13 against c_K ~ 124 and c_Cl ~ 137): its gate is
1e-7 of the subdomain's largest concentration.  The port against the
JAX XLA path, which has no such error, is held to 1e-12 in
test_torch_slice_xla.py.

Also: a JAX state carried into the port (``interop.state_from_numpy``)
and stepped once agrees with JAX's own next step.
"""

import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples" / "idealized"))

from knpemi_tpu_torch.interop import state_from_numpy, state_to_numpy
from knpemi_tpu_torch.sim import SolverOptions, build_idealized

N_STEPS = 2


def jax_simulation(dtype, use_pallas, **opts):
    """run_2d.py's scenario at res 1, with explicit assembly/layout choices."""
    import run_2d as R
    from knpemi_tpu.mesh import idealized_2d_mesh
    from knpemi_tpu.models import get_model, setup_membrane_model
    from knpemi_tpu.ops.geometry import build_geometry
    from knpemi_tpu.sim import Simulation, SolverOptions as JOpts
    from knpemi_tpu.systems.types import Ion, PhysicalParams

    geom = build_geometry(idealized_2d_mesh(1))
    params = PhysicalParams(dt=1e-4, F=96485.0, R=8.314, temperature=300.0,
                            C_M=0.02, n_steps_ODE=25, rho_z=-1.0,
                            rho={0: 0.0, 1: 0.0})
    ions = [
        Ion("K", 1.0, {0: R.D_K, 1: R.D_K}, {0: R.K_E_INIT, 1: R.K_I_INIT}),
        Ion("Cl", -1.0, {0: R.D_CL, 1: R.D_CL}, {0: R.CL_E_INIT, 1: R.CL_I_INIT}),
        Ion("Na", 1.0, {0: R.D_NA, 1: R.D_NA}, {0: R.NA_E_INIT, 1: R.NA_I_INIT}),
    ]
    mm = setup_membrane_model(
        {"stimulus": {"stim_amplitude": 10.0},
         "stimulus_locator": lambda x: x[0] < 20e-6},
        params, {1: get_model("hh")}, geom, ions)
    return Simulation(
        geom, ions, params, mm,
        JOpts(**{"rtol_emi": 1e-5, "rtol_knp": 1e-7, "mg_banded": False, **opts}),
        dtype=dtype, use_pallas=use_pallas)


def run_jax(sim, n):
    states, s = [], sim.init_state()
    for _ in range(n):
        s = sim.step(s)
        states.append(jax.device_get(s))
    return states


def run_port(sim, n, state=None):
    states, s = [], state if state is not None else sim.init_state()
    for _ in range(n):
        s = sim.step(s)
        states.append(s)
    return states


def assert_step_close(sJ, sT, phi_atol, c_rtol, elim_rtol, emi_slack):
    assert int(sT.knp_iters) == int(sJ.knp_iters)
    assert abs(int(sT.emi_iters) - int(sJ.emi_iters)) <= emi_slack
    assert bool(sT.emi_ok) and bool(sT.knp_ok)
    for m in sJ.phi_M:
        np.testing.assert_allclose(sT.phi_M[m].numpy(), np.asarray(sJ.phi_M[m]),
                                   rtol=0, atol=phi_atol)
    for t in sJ.c:
        cJ, cT = np.asarray(sJ.c[t]), sT.c[t].numpy()
        np.testing.assert_allclose(cT[:-1], cJ[:-1], rtol=c_rtol, atol=0)
        np.testing.assert_allclose(cT[-1], cJ[-1], rtol=0,
                                   atol=elim_rtol * np.abs(cJ).max())


@pytest.fixture(scope="module")
def runs():
    simJ = jax_simulation(jnp.float64, use_pallas=True)
    assert simJ.emi_sys.use_pallas and simJ.knp_sys.use_pallas
    simT = build_idealized(dim=2, resolution=1, g_syn_bar=10.0,
                           dtype=torch.float64, device="cpu")
    return simT, run_jax(simJ, N_STEPS), run_port(simT, N_STEPS)


@pytest.mark.parametrize("step", range(N_STEPS))
def test_step_f64_matches_jax_pallas(runs, step):
    _, statesJ, statesT = runs
    assert_step_close(statesJ[step], statesT[step], phi_atol=1e-8, c_rtol=1e-7,
                      elim_rtol=1e-7, emi_slack=1)


def test_carry_over_from_jax_state(runs):
    """JAX step 1 -> state_from_numpy -> one port step == JAX step 2."""
    simT, statesJ, _ = runs
    s1 = state_from_numpy(statesJ[0], "cpu", torch.float64)
    (s2,) = run_port(simT, 1, s1)
    assert int(s2.step) == 2
    assert_step_close(statesJ[1], s2, phi_atol=1e-8, c_rtol=1e-7,
                      elim_rtol=1e-7, emi_slack=1)


def test_state_roundtrip(runs):
    """state_to_numpy(state_from_numpy(jax state)) gives the JAX arrays back."""
    _, statesJ, _ = runs
    back = state_to_numpy(state_from_numpy(statesJ[1], "cpu", torch.float64))
    for f in ("c", "phi", "phi_M", "ode_states", "ode_params"):
        for k, v in getattr(statesJ[1], f).items():
            np.testing.assert_array_equal(back[f][k], np.asarray(v))
    assert float(back["t"]) == float(statesJ[1].t)
    assert int(back["step"]) == int(statesJ[1].step)


def test_options_outside_the_slice_raise(runs):
    """What the port has not taken over raises instead of running something
    else: a multi-candidate near-null space, an EMI solve without its
    hierarchy.  (``mg_banded=True`` is ported: test_torch_mg_banded.py.)"""
    import scipy.sparse as sp
    from knpemi_tpu_torch.solvers import mg
    from knpemi_tpu_torch.solvers.api import EMISolver

    simT = runs[0]
    assert SolverOptions().mg_banded is False
    A = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(2000, 2000)).tocsr()
    with pytest.raises(NotImplementedError):
        mg.build_hierarchy(A, B=np.ones((2000, 2)))
    s = simT.init_state()
    with pytest.raises(NotImplementedError):
        EMISolver(simT.emi_sys).solve(s.c, s.phi_M)
