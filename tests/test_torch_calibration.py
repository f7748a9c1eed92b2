"""The calibration and ``hh_fixture`` models and the calibration driver,
against the JAX package's.

* ``rhs`` and ``currents`` of ``calibration`` and ``hh_fixture`` against
  JAX's (vmapped over the points) at 16 seeded random states, the rate
  singularities among them, at several times: 1e-12 relative in
  float64; one RK4 step of each (``models.engine.rk4_step``) the same;
* the registry holds what JAX's does;
* ``tests/test_calibration.py``'s checks through the port's driver
  (``drivers/run_calibration.py``): the calibrated state stays put over
  500 steps (relative drift < 1e-3) and a stimulated neuron fires;
* ``tests/test_ode.py``'s ``hh_fixture`` check: one PDE step of 25 RK4
  substeps against scipy's LSODA (rtol 1e-8, atol 1e-10) within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.integrate import solve_ivp

from knpemi_tpu.models import available_models as javailable
from knpemi_tpu.models import get_model as jget
from knpemi_tpu.models.engine import rk4_step as jrk4
from knpemi_tpu_torch.drivers import run_calibration as RC
from knpemi_tpu_torch.models import available_models, get_model, rk4_step

N = 16
TIMES = {"calibration": [0.0, 3.7, 19.9, 41.0], "hh_fixture": [0.0, 0.0123, 0.031, 130.0]}


def _inputs(name):
    """16 seeded states around the model's default, gates in (0, 1), the
    potentials uniform over -100..40 mV with the first ones on and next
    to the rate singularities (V = -40, -55 mV); the stimulus on."""
    ode = get_model(name)
    rng = np.random.default_rng(5)
    y0, p0 = ode.init_states(), ode.init_params(stim_amplitude=7.5)
    y = y0 * (1.0 + 0.2 * rng.uniform(-1.0, 1.0, (N, y0.size)))
    p = np.tile(p0, (N, 1)) * (1.0 + 0.05 * rng.uniform(-1.0, 1.0, (N, p0.size)))
    for gate in ("m", "h", "n"):
        y[:, ode.state_indices(gate)] = rng.uniform(0.01, 0.99, N)
    v = "V_n" if name == "calibration" else "V"
    y[:, ode.state_indices(v)] = rng.uniform(-100.0, 40.0, N)
    y[:4, ode.state_indices(v)] = [-40.0, -55.0, -40.0 + 1e-7, -55.0 - 1e-6]
    if name == "calibration":
        y[:, ode.state_indices("V_g")] = rng.uniform(-100.0, -60.0, N)
    return y, p


def _jax(name, t, y, p):
    oj = jget(name)
    tj = jnp.asarray(t, jnp.float64)
    dy = jax.vmap(lambda yy, pp: oj.rhs(tj, yy, pp))(jnp.asarray(y), jnp.asarray(p))
    cu = jax.vmap(lambda yy, pp: jnp.stack(oj.currents(tj, yy, pp)))(jnp.asarray(y),
                                                                     jnp.asarray(p))
    return np.asarray(dy), np.asarray(cu)


@pytest.mark.parametrize("name", ["calibration", "hh_fixture"])
def test_model_tables_match_jax(name):
    oj, ot = jget(name), get_model(name)
    assert tuple(oj.state_names) == tuple(ot.state_names)
    assert tuple(oj.param_names) == tuple(ot.param_names)
    assert tuple(oj.current_names) == tuple(ot.current_names)
    np.testing.assert_array_equal(oj.default_states, ot.default_states)
    np.testing.assert_array_equal(oj.default_params, ot.default_params)


def test_registry_matches_jax():
    assert available_models() == javailable()
    assert {"calibration", "hh_fixture"} <= set(available_models())


@pytest.mark.parametrize("name", ["calibration", "hh_fixture"])
@pytest.mark.parametrize("k", range(4))
def test_rhs_and_currents_match_jax(name, k):
    t = TIMES[name][k]
    y, p = _inputs(name)
    dyj, cuj = _jax(name, t, y, p)
    ot = get_model(name)
    tt = torch.tensor(t, dtype=torch.float64)
    Y, P = torch.as_tensor(y), torch.as_tensor(p)
    dyt = ot.rhs(tt, Y, P).numpy()
    cut = torch.stack(ot.currents(tt, Y, P), dim=1).numpy()
    assert np.isfinite(dyt).all() and np.isfinite(cut).all()
    np.testing.assert_allclose(dyt, dyj, rtol=1e-12, atol=1e-12 * np.abs(dyj).max())
    np.testing.assert_allclose(cut, cuj, rtol=1e-12, atol=1e-12 * np.abs(cuj).max())


@pytest.mark.parametrize("name,h", [("calibration", 0.02), ("hh_fixture", 4e-4)])
def test_one_rk4_step_matches_jax(name, h):
    y, p = _inputs(name)
    oj, ot = jget(name), get_model(name)
    t = TIMES[name][1]
    yj = np.asarray(jax.vmap(lambda yy, pp: jrk4(oj.rhs, jnp.asarray(t, jnp.float64), yy, pp,
                                                 h))(jnp.asarray(y), jnp.asarray(p)))
    yt = rk4_step(ot.rhs, torch.tensor(t, dtype=torch.float64), torch.as_tensor(y),
                  torch.as_tensor(p), h).numpy()
    np.testing.assert_allclose(yt, yj, rtol=1e-12, atol=1e-12 * np.abs(yj).max())


def test_calibrated_state_is_steady():
    y0 = get_model("calibration").init_states()
    y = RC.run(n_steps=500, dt=0.1, device="cpu", verbose=False)
    rel = np.abs((y - y0) / np.maximum(np.abs(y0), 1e-3)).max()
    assert rel < 1e-3, f"the steady state drifted by {rel}"


def test_stimulated_neuron_fires_in_calibration_model():
    model = get_model("calibration")
    y = torch.as_tensor(model.init_states()[None, :])
    p = torch.as_tensor(model.init_params(stim_amplitude=20.0)[None, :])
    h, t, V_max = 0.02, 0.0, -100.0
    for _ in range(500):  # 10 ms
        y = rk4_step(model.rhs, torch.tensor(t, dtype=torch.float64), y, p, h)
        t += h
        V_max = max(V_max, float(y[0, 3]))
    assert V_max > 0.0, "a stimulated neuron must fire"


def test_hh_fixture_step_matches_lsoda():
    model = get_model("hh_fixture")
    y0 = model.init_states()
    p = torch.as_tensor(model.init_params(stim_amplitude=10.0)[None, :])

    def f(t, y):
        return model.rhs(torch.tensor(t, dtype=torch.float64),
                         torch.as_tensor(y)[None, :], p)[0].numpy()

    ref = solve_ivp(f, (0.0, 0.01), y0, method="LSODA", rtol=1e-8, atol=1e-10).y[:, -1]
    # one PDE step of 25 substeps; the stimulus decays on 0.002
    y, t, h = torch.as_tensor(y0[None, :]), 0.0, 0.01 / 25
    for _ in range(25):
        y = rk4_step(model.rhs, torch.tensor(t, dtype=torch.float64), y, p, h)
        t += h
    np.testing.assert_allclose(y[0].numpy(), ref, rtol=1e-6, atol=1e-7)
