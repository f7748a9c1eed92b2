"""The port's host-built data is the JAX package's, array for array.

The port keeps its own copies of the JAX package's numpy setup code
(mesh, geometry, multigrid build), so the arrays the device code sees
must come out identical: the geometry with its dof numbering, the EMI
membrane gather index ``flat_idx``, and the EMI and KNP multigrid
hierarchies (P, ELL operators, diagonals, smoother weights, coarse
factors, global RCM permutation).  The device V-cycles then agree to
float64 roundoff on the same residuals.
"""

import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples" / "idealized"))

from knpemi_tpu import mesh as jmesh
from knpemi_tpu.ops.geometry import build_geometry as jbuild
from knpemi_tpu.solvers import mg as jmg
from knpemi_tpu.solvers import direct as jdirect

from knpemi_tpu_torch import mesh as tmesh
from knpemi_tpu_torch.ops.geometry import build_geometry as tbuild
from knpemi_tpu_torch.solvers import mg as tmg
from knpemi_tpu_torch.solvers import direct as tdirect
from knpemi_tpu_torch.sim import build_idealized

MESHES = [
    ("unit_square_mms_mesh", (12,), {}),
    ("idealized_2d_mesh", (1,), {}),
    ("idealized_3d_mesh", (0,), {"l": 1}),
]


@pytest.mark.parametrize("name,args,kw", MESHES)
def test_geometry_arrays_equal(name, args, kw):
    gj = jbuild(getattr(jmesh, name)(*args, **kw))
    gt = tbuild(getattr(tmesh, name)(*args, **kw))
    assert gj.sub_tags == gt.sub_tags and gj.emi_offsets() == gt.emi_offsets()
    for t in gj.subdomains:
        a, b = gj.subdomains[t], gt.subdomains[t]
        for f in ("vertices", "parent_cells", "cells", "coords", "grads", "vols"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    for m in gj.membranes:
        a, b = gj.membranes[m], gt.membranes[m]
        for f in ("facet_dofs", "facet_edofs", "facet_idofs", "areas",
                  "mem_to_ecs", "mem_to_ics", "vertices"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


@pytest.fixture(scope="module")
def sims():
    """The JAX Simulation (blocked assembly, ELL multigrid) and the port's,
    2-D res 1, float64."""
    from run_2d import build_simulation
    from knpemi_tpu.sim import SolverOptions

    simJ = build_simulation(resolution=1, dtype=jnp.float64,
                            solver_options=SolverOptions(mg_banded=False))
    simT = build_idealized(dim=2, resolution=1, g_syn_bar=10.0,
                           dtype=torch.float64, device="cpu")
    return simJ, simT


def test_flat_idx_equal(sims):
    """The EMI membrane-space gather index of emi.py:188-191."""
    simJ, simT = sims
    off = simJ.emi_sys.offsets
    for m, sp_ in simJ.geom.membranes.items():
        ref = np.concatenate([off[0] + sp_.mem_to_ecs,
                              off[sp_.cell_tag] + sp_.mem_to_ics])
        np.testing.assert_array_equal(simT.emi_sys.mem[m]["flat_idx"].numpy(), ref)


def _assert_hierarchy_equal(hj, ht):
    assert len(hj.levels) == len(ht.levels)
    np.testing.assert_array_equal(hj.perm, ht.perm)
    for lj, lt in zip(hj.levels, ht.levels):
        assert lj.n == lt.n and lj.omega == lt.omega
        np.testing.assert_array_equal(lj.diag, lt.diag)
        # the JAX damped-Jacobi smoother stores its one step as [omega]
        np.testing.assert_array_equal(lj.steps, [lt.omega])
        assert (lj.P_csr != lt.P_csr).nnz == 0
        for f in ("a_cols", "a_vals", "p_cols", "p_vals", "pt_cols", "pt_vals"):
            np.testing.assert_array_equal(getattr(lj, f), getattr(lt, f), err_msg=f)
    np.testing.assert_array_equal(hj.coarse_V, ht.coarse_V)
    np.testing.assert_array_equal(hj.coarse_ilam, ht.coarse_ilam)


def test_emi_hierarchy_equal(sims):
    simJ, simT = sims
    _assert_hierarchy_equal(simJ._emi_hier, simT._emi_hier)


def _knp_setup_operator(mod, sub, ions, dt, tag):
    Dbar = float(np.mean([ion.D[tag] for ion in ions[:-1]]))
    r1, c1, v1 = mod._mass_coo(sub.cells, sub.vols, 1.0 / dt)
    r2, c2, v2 = mod._stiffness_coo(sub.cells, sub.grads, sub.vols, coef_cell=Dbar)
    A0 = mod._coo_accumulate([r1, r2], [c1, c2], [v1, v2], sub.n_dofs)
    d = A0.diagonal()
    s = 1.0 / np.sqrt(np.abs(np.where(d != 0, d, 1.0)))
    return (sp.diags(s) @ A0 @ sp.diags(s)).tocsr(), s


@pytest.mark.parametrize("tag", [0, 1])
def test_knp_hierarchy_equal(sims, tag):
    """The KNP setup operator and its hierarchy, built by each package's
    own host code with the stepper's parameters."""
    simJ, simT = sims
    sub = simJ.geom.subdomains[tag]
    AJ, sJ = _knp_setup_operator(jdirect, sub, simJ.ions, simJ.params.dt, tag)
    AT, sT = _knp_setup_operator(tdirect, simT.geom.subdomains[tag], simT.ions,
                                 simT.params.dt, tag)
    assert (AJ != AT).nnz == 0
    np.testing.assert_array_equal(sJ, sT)
    kw = dict(theta=0.04, coarse_max=40, nu=1)
    hj = jmg.build_hierarchy(AJ, B=1.0 / sJ, banded=False, smoother="jacobi", **kw)
    ht = tmg.build_hierarchy(AT, B=1.0 / sT, **kw)
    hj.perm = ht.perm = np.arange(AJ.shape[0])[::-1].copy()
    _assert_hierarchy_equal(hj, ht)


def _emi_setup_operator(simT):
    """The equilibrated t=0 EMI operator of the port's setup path."""
    from knpemi_tpu_torch.systems.coupling import set_initial_conditions

    c0 = set_initial_conditions(simT.geom, simT.ions, device="cpu")
    kappa = {t: v.numpy() for t, v in simT.emi_sys.kappa(c0).items()}
    A0 = tdirect.assemble_emi_csr(simT.geom, simT.params, kappa)
    s = 1.0 / np.sqrt(np.abs(A0.diagonal()))
    return (sp.diags(s) @ A0 @ sp.diags(s)).tocsr(), s


def test_emi_multilevel_hierarchy_equal(sims):
    """At 2-D res 1 the default coarse_max leaves the EMI hierarchy a
    single coarse solve; a smaller one gives real levels to compare."""
    simJ, simT = sims
    A, s = _emi_setup_operator(simT)
    AJ = simJ._emi_Ahat(simJ.init_state().c)[0]
    assert (AJ != A).nnz == 0
    kw = dict(theta=0.04, coarse_max=40, nu=1)
    hj = jmg.build_hierarchy(A, B=1.0 / s, banded=False, smoother="jacobi", **kw)
    ht = tmg.build_hierarchy(A, B=1.0 / s, **kw)
    assert len(ht.levels) >= 2
    hj.perm = ht.perm = simJ._emi_hier.perm
    _assert_hierarchy_equal(hj, ht)


@pytest.mark.parametrize("batch", [False, True])
@pytest.mark.parametrize("fine_ell", [True, False])
def test_device_vcycle_equal(sims, fine_ell, batch):
    """DeviceMG.apply / apply_batch on the same residuals, with a global
    RCM permutation; fine_ell=False exercises the solver-layout fine
    cycle (level 0 smooths with the caller's operator)."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    simJ, simT = sims
    A_solver, s = _emi_setup_operator(simT)
    perm = np.asarray(reverse_cuthill_mckee(A_solver, symmetric_mode=True), np.int64)
    A = A_solver[perm][:, perm].tocsr()
    n = A.shape[0]
    kw = dict(theta=0.04, coarse_max=40, nu=1, fine_ell=fine_ell)
    hj = jmg.build_hierarchy(A, B=1.0 / s[perm], banded=False, smoother="jacobi", **kw)
    ht = tmg.build_hierarchy(A, B=1.0 / s[perm], **kw)
    hj.perm = ht.perm = perm
    dj, dt = hj.device(jnp.float64), ht.device(torch.float64, "cpu")
    R = np.random.default_rng(4).standard_normal((2, n))
    opJ = lambda v: jnp.asarray(A_solver @ np.asarray(v).T).T
    opT = lambda v: torch.as_tensor(np.asarray(A_solver @ v.numpy().T).T)
    if batch:
        yj = np.asarray(dj.apply_batch(opJ, jnp.asarray(R)))
        yt = dt.apply_batch(opT, torch.as_tensor(R)).numpy()
    else:
        yj = np.asarray(dj.apply(opJ, jnp.asarray(R[0])))
        yt = dt.apply(opT, torch.as_tensor(R[0])).numpy()
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-12 * np.abs(yj).max())


@pytest.mark.parametrize("tag", [0, 1])
def test_knp_diag_equal(sims, tag):
    """KNPSystem.diag, the batched Jacobi diagonal the KNP solve takes for
    a subdomain without a hierarchy, on the same phi."""
    simJ, simT = sims
    rng = np.random.default_rng(5)
    phi = {t: 1e-3 * rng.standard_normal(s.n_dofs)
           for t, s in simT.geom.subdomains.items()}
    gj = simJ.knp_sys.gradphi_cells({t: jnp.asarray(v) for t, v in phi.items()})
    gt = simT.knp_sys.gradphi_cells({t: torch.as_tensor(v) for t, v in phi.items()})
    dj = np.asarray(simJ.knp_sys.diag(tag, gj[tag]))
    dt = simT.knp_sys.diag(tag, gt[tag]).numpy()
    np.testing.assert_allclose(dt, dj, rtol=0, atol=1e-12 * np.abs(dj).max())
