"""The multigrid options of ``SolverOptions`` against the JAX package.

For two steps of the 2-D res-1 scenario in float64 against the JAX
package's XLA path (``use_pallas=False``, ``mg_banded=False``,
``mg_coarse_max=100``, so that the hierarchies have levels), the port
per ion and ion-batched: equal iteration counts, phi_M and the
concentrations within 1e-10, for

* ``mg_smoother='cheby'`` (Chebyshev-Richardson, ``mg_degree`` 3);
* ``mg_nu=2`` (two smoothing sweeps a side);
* ``knp_post_smooth=False`` (the KNP hierarchies' V(1,0) cycle);
* the W-cycle (``gamma=2``, set on every built hierarchy of both
  packages).

Also: the Chebyshev hierarchy's host arrays equal the JAX package's, its
refresh recomputes the steps from the new lam_max as JAX's does, and the
fused AP post-residual is taken only by the plain V(1,1) Jacobi cycle.
"""

import numpy as np
import pytest
import torch

from knpemi_tpu_torch.sim import SolverOptions, build_idealized
from knpemi_tpu_torch.solvers import mg as tmg

from test_torch_solver_options import BRANCHES, N_STEPS, assert_option_step

CASES = {
    "cheby": dict(mg_smoother="cheby"),
    "nu2": dict(mg_nu=2),
    "knp_v10": dict(knp_post_smooth=False),
    "w_cycle": dict(gamma=2),
}


@pytest.mark.parametrize("step", range(N_STEPS))
@pytest.mark.parametrize("branch", BRANCHES)
@pytest.mark.parametrize("name", list(CASES))
def test_mg_option_step_matches_jax_xla(name, branch, step):
    assert_option_step(name, CASES[name], branch, step)


def _sim(**opts):
    return build_idealized(dim=2, resolution=1, g_syn_bar=10.0, dtype=torch.float64,
                           device="cpu", solver_options=SolverOptions(mg_coarse_max=100,
                                                                      **opts))


def test_cheby_hierarchy_and_refresh_match_jax():
    from knpemi_tpu.solvers import mg as jmg

    sim = _sim(mg_smoother="cheby", mg_degree=3)
    hier = sim._emi_hier
    assert hier.levels and all(len(lv.steps) == 3 for lv in hier.levels)
    c0 = {t: v.numpy() for t, v in sim.init_state().c.items()}
    A = sim._emi_operator(c0)
    s = 1.0 / np.sqrt(np.abs(sim._emi_diag0))[hier.perm]
    hj = jmg.build_hierarchy(A, B=1.0 / s, theta=sim.opts.mg_theta,
                             coarse_max=sim.opts.mg_coarse_max, banded=False,
                             smoother="cheby", degree=3)
    for lt, lj in zip(hier.levels, hj.levels):
        np.testing.assert_array_equal(lt.steps, lj.steps)
        assert lt.omega == lj.omega
    # a refresh from other concentrations: steps from the new lam_max
    c1 = {t: v * (1.0 + 0.05 * np.sin(np.arange(v.shape[1]))) for t, v in c0.items()}
    A1 = sim._emi_operator(c1)
    rt, rj = tmg.refresh_hierarchy(hier, A1), jmg.refresh_hierarchy(hj, A1)
    for lt, lj, l0 in zip(rt.levels, rj.levels, hier.levels):
        np.testing.assert_array_equal(lt.steps, lj.steps)
        assert len(lt.steps) == 3 and not np.array_equal(lt.steps, l0.steps)
    # the device cycle takes the refreshed steps in place
    mg = sim.emi_solver.mg
    before = [lv["steps"] for lv in mg.levels]
    pairs, _ = mg.refill_arrays(rt)
    mg.install(pairs)
    for t, lv, hl in zip(before, mg.levels, rt.levels):
        assert lv["steps"] is t
        np.testing.assert_array_equal(t.numpy(), hl.steps)


@pytest.mark.parametrize("opts,fused", [
    (dict(), True), (dict(mg_smoother="cheby"), False), (dict(mg_nu=2), False),
    (dict(knp_post_smooth=False), None)], ids=["v11_jacobi", "cheby", "nu2", "knp_v10"])
def test_fused_post_only_for_the_plain_cycle(opts, fused):
    """With banded layouts the EMI V(1,1) Jacobi cycle takes the AP
    post-residual on its stored levels; a Chebyshev or nu = 2 cycle never
    does, nor a V(1,0) cycle (which has no post-smoothing)."""
    sim = _sim(mg_banded=True, **opts)
    emi = [lv["AP"] is not None for lv in sim.emi_solver.mg.layout()]
    knp = [lv["AP"] is not None for m in sim.knp_solver.mg.values() for lv in m.layout()]
    if fused is None:  # V(1,0) only on the KNP hierarchies
        assert not any(knp) and any(emi)
        assert all(not m.post_smooth for m in sim.knp_solver.mg.values())
        assert sim.emi_solver.mg.post_smooth
    else:
        assert any(emi) == fused and (not any(knp) or fused)
