"""The per-ion KNP solve of the port against the JAX package's.

* K11 ``knp_apply`` (``ops/p1op.py``: the ion's constant values P_b =
  dt_inv M + D K on the subdomain's P1 operator, the drift values K11f
  fills from grad(phi), and the apply): its plain version (what the
  wrapper runs on CPU tensors) in float32 against JAX
  ``knp_apply_blocked`` in interpret mode at 1e-5 max|y| (the JAX kernel
  gathers through bf16 split passes and sums in another order), and in
  float64 against the JAX XLA single-ion operator
  ``KNPSystem._one_matvec`` at 1e-12 max|y|; 2-D and 3-D; and equal, row
  by row, to K3 ``knp_apply_batch``.
* ``gmres`` against JAX ``gmres`` on a seeded nonsymmetric system, with
  and without a preconditioner, through restarts: equal iteration
  counts, x within 1e-10.
* ``KNPSolver(batched=False).solve`` against the JAX solve with
  ``use_pallas=False`` (its per-ion vmapped branch) on 2-D res 1,
  float64, on the state after one coupled step: equal iteration counts,
  concentrations within 1e-9 relative.
* the port's per-ion and batched branches agree to the solver tolerance.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from knpemi_tpu.mesh import unit_square_mms_mesh, idealized_3d_mesh
from knpemi_tpu.ops import kernels as JK
from knpemi_tpu.ops import pallas_assembly as PA
from knpemi_tpu.ops.geometry import build_geometry
from knpemi_tpu.solvers.gmres import gmres as jgmres

from knpemi_tpu_torch import ops
from knpemi_tpu_torch.ops import assembly as A
from knpemi_tpu_torch.ops import ell as E
from knpemi_tpu_torch.ops import p1op as P
from knpemi_tpu_torch.sim import SolverOptions, build_idealized
from knpemi_tpu_torch.solvers import direct
from knpemi_tpu_torch.solvers.gmres import gmres as tgmres
from knpemi_tpu_torch.systems.knp import ion_operator_values

from test_torch_slice import jax_simulation

MESHES = {
    "square12": lambda: unit_square_mms_mesh(12),
    "box3d0": lambda: idealized_3d_mesh(0, l=1),
}
_GEOMS = {}


def geometry(name):
    if name not in _GEOMS:
        _GEOMS[name] = build_geometry(MESHES[name]())
    return _GEOMS[name]


def t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def k11(x, sub, w, dt_inv, D, zpsiD):
    """K11 as the per-ion solve applies it: P_b assembled on the
    subdomain's P1 operator, the drift values filled by K11f from w."""
    op = P.P1Operator(sub.cells, sub.n_dofs, "cpu")
    dtype = x.dtype
    Pb, = ion_operator_values(op, sub.cells, sub.grads, sub.vols, dt_inv, [D], dtype)
    Dr = P.drift_fill(op, t(sub.grads, dtype), t(sub.vols, dtype), w)
    return P.knp_apply(x, op, Pb, Dr, zpsiD)


def close(y, y_ref, tol):
    y, y_ref = np.asarray(y, np.float64), np.asarray(y_ref, np.float64)
    scale = np.abs(y_ref).max()
    assert scale > 0
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=tol * scale)


# ---------------------------------------------------------------------------
# K11
# ---------------------------------------------------------------------------
SCALARS = [(10.0, 1.3, 1.0 * 38.7 * 1.3), (10.0, 2.0, -1.0 * 38.7 * 2.0)]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_k11_knp_apply_vs_pallas(mesh):
    """float32, the blocking of tests/test_pallas.py (S=256)."""
    geom = geometry(mesh)
    for tag, sub in geom.subdomains.items():
        rng = np.random.default_rng(7 + tag)
        x = rng.standard_normal(sub.n_dofs)
        phi = rng.standard_normal(sub.n_dofs)
        bk = PA.build_blocking(sub.cells, sub.grads, sub.vols, sub.n_dofs, S=256)
        g32 = jnp.asarray(bk.grads_lane, jnp.float32)
        v32 = jnp.asarray(bk.vols_lane, jnp.float32)
        drift = PA.prepare_knp_drift(jnp.asarray(phi, jnp.float32), bk, g32)
        grad = E.cell_gradient_ell(sub.cells, sub.grads, sub.n_dofs, torch.float32, "cpu")
        w = E.ellw_matvec(grad, t(phi)).reshape(sub.n_cells, geom.dim)
        for dt_inv, D, zpsiD in SCALARS:
            y_jax = PA.knp_apply_blocked(jnp.asarray(x, jnp.float32), bk, g32, v32,
                                         drift, dt_inv, D, zpsiD, interpret=True)
            close(k11(t(x), sub, w, dt_inv, D, zpsiD), y_jax, 1e-5)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_k11_knp_apply_f64_vs_xla_one_matvec(mesh):
    """float64 against the operator the JAX per-ion solve applies
    (mass + stiffness + drift of knpemi_tpu/ops/kernels.py)."""
    geom = geometry(mesh)
    f64 = lambda a: t(a, torch.float64)
    J = lambda a: jnp.asarray(np.asarray(a), jnp.float64)
    for tag, sub in geom.subdomains.items():
        rng = np.random.default_rng(3 + tag)
        n, cells = sub.n_dofs, jnp.asarray(sub.cells)
        x, phi = rng.standard_normal(n), rng.standard_normal(n)
        grad = E.cell_gradient_ell(sub.cells, sub.grads, n, torch.float64, "cpu")
        w = E.ellw_matvec(grad, f64(phi)).reshape(sub.n_cells, -1)
        w_ref = JK.cell_gradients(J(phi), cells, J(sub.grads))
        for dt_inv, D, zpsiD in SCALARS:
            y = k11(f64(x), sub, w, dt_inv, D, zpsiD)
            y_ref = (JK.mass_apply(n, J(x), cells, J(sub.vols), dt_inv)
                     + JK.stiffness_apply(n, J(x), cells, J(sub.grads), J(sub.vols),
                                          coef_cell=D)
                     + JK.drift_apply(n, J(x), cells, J(sub.grads), J(sub.vols),
                                      w_ref, coef=zpsiD))
            close(y, y_ref, 1e-12)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6), (torch.float64, 1e-14)])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_k11_equals_k3_row_by_row(mesh, dtype, tol):
    sub = geometry(mesh).subdomains[0]
    rng = np.random.default_rng(5)
    X = t(rng.standard_normal((2, sub.n_dofs)), dtype)
    w = t(rng.standard_normal((sub.n_cells, sub.grads.shape[-1])), dtype)
    op = P.P1Operator(sub.cells, sub.n_dofs, "cpu")
    Kst = t(op.assemble(direct._stiffness_coo(sub.cells, sub.grads, sub.vols)[2])[0], dtype)
    Dr = P.drift_fill(op, t(sub.grads, dtype), t(sub.vols, dtype), w)
    Y = P.knp_apply_batch(X, op, t(SCALARS, dtype),
                          P.mass_values(op, sub.cells, sub.vols, dtype), Kst, Dr)
    for b, scal in enumerate(SCALARS):
        close(k11(X[b].contiguous(), sub, w, *scal), Y[b], tol)


def test_k11_wrapper_checks_inputs_and_counts_no_cpu_launch():
    sub = geometry("square12").subdomains[0]
    op = P.P1Operator(sub.cells, sub.n_dofs, "cpu")
    x = t(np.ones(sub.n_dofs))
    Pb, = ion_operator_values(op, sub.cells, sub.grads, sub.vols, 10.0, [1.0], torch.float32)
    w = t(np.zeros((sub.n_cells, 2)))
    ops.reset_launch_counts()
    Dr = P.drift_fill(op, t(sub.grads), t(sub.vols), w)
    assert torch.equal(Dr, P.drift_fill_plain(op, t(sub.grads), t(sub.vols), w))
    y = P.knp_apply(x, op, Pb, Dr, 0.5)
    assert torch.equal(y, P.knp_apply_plain(x, op, Pb, Dr, 0.5))
    assert ops.launch_counts()["K11 knp_apply"] == 0
    assert ops.launch_counts()["K11f drift_fill"] == 0
    with pytest.raises(ValueError):
        P.knp_apply(torch.stack([x, x]), op, Pb, Dr, 0.5)
    with pytest.raises(ValueError):
        P.knp_apply(x, op, Pb, Dr[:-1], 0.5)
    with pytest.raises(ValueError):
        P.drift_fill(op, t(sub.grads), t(sub.vols), w[:-1])
    with pytest.raises(TypeError):
        P.knp_apply(x.double(), op, Pb, Dr, 0.5)


# ---------------------------------------------------------------------------
# gmres
# ---------------------------------------------------------------------------
def _nonsymmetric_system(n=120, seed=0):
    rng = np.random.default_rng(seed)
    A_ = np.diag(rng.uniform(1.0, 3.0, n)) + 0.25 * rng.standard_normal((n, n)) / np.sqrt(n)
    A_ += np.triu(0.3 * rng.standard_normal((n, n)) / np.sqrt(n), 1)
    Minv = np.diag(1.0 / np.diag(A_)) + 0.01 * rng.standard_normal((n, n)) / n
    return A_, Minv, rng.standard_normal(n), rng.standard_normal(n)


@pytest.mark.parametrize("precond", [False, True])
@pytest.mark.parametrize("restart,min_iter", [(30, 0), (5, 0), (30, 25), (3, 7)])
def test_gmres_matches_jax(restart, min_iter, precond):
    A_, Minv, b, x0 = _nonsymmetric_system()
    kw = dict(rtol=1e-10, atol=1e-40, maxiter=200, restart=restart, min_iter=min_iter)
    Aj, Mj = jnp.asarray(A_), jnp.asarray(Minv)
    rj = jgmres(lambda v: Aj @ v, jnp.asarray(b), x0=jnp.asarray(x0),
                M=(lambda v: Mj @ v) if precond else None, **kw)
    At, Mt = torch.as_tensor(A_), torch.as_tensor(Minv)
    rt = tgmres(lambda v: At @ v, torch.as_tensor(b), x0=torch.as_tensor(x0),
                M=(lambda v: Mt @ v) if precond else None, **kw)
    assert rt.iters == int(rj.iters) and rt.iters >= max(min_iter, 1)
    assert rt.converged and bool(rj.converged)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0,
                               atol=1e-10 * np.abs(np.asarray(rj.x)).max())
    np.testing.assert_allclose(A_ @ rt.x.numpy(), b, rtol=0, atol=1e-8)


def test_gmres_edge_cases_match_jax():
    """x0 already converged: no iteration; maxiter caps a stagnating run."""
    A_, _, b, _ = _nonsymmetric_system()
    x_star = np.linalg.solve(A_, b)
    At, Aj = torch.as_tensor(A_), jnp.asarray(A_)
    rt = tgmres(lambda v: At @ v, torch.as_tensor(b), x0=torch.as_tensor(x_star))
    rj = jgmres(lambda v: Aj @ v, jnp.asarray(b), x0=jnp.asarray(x_star))
    assert rt.iters == int(rj.iters) == 0 and rt.converged
    rt = tgmres(lambda v: At @ v, torch.as_tensor(b), rtol=1e-14, maxiter=4, restart=2)
    rj = jgmres(lambda v: Aj @ v, jnp.asarray(b), rtol=1e-14, maxiter=4, restart=2)
    assert rt.iters == int(rj.iters) == 4 and not rt.converged
    assert bool(rj.converged) is False
    np.testing.assert_allclose(float(rt.resnorm), float(rj.resnorm), rtol=1e-9)


def test_gmres_compensated_dot_in_float32():
    from knpemi_tpu_torch.solvers.precision import dot2

    A_, Minv, b, _ = _nonsymmetric_system()
    At, Mt = torch.as_tensor(A_, dtype=torch.float32), torch.as_tensor(Minv, dtype=torch.float32)
    r = tgmres(lambda v: At @ v, torch.as_tensor(b, dtype=torch.float32),
               M=lambda v: Mt @ v, rtol=1e-5, dot=dot2)
    assert r.converged and r.x.dtype == torch.float32
    np.testing.assert_allclose(A_ @ r.x.double().numpy(), b, rtol=0,
                               atol=1e-4 * np.abs(b).max())


# ---------------------------------------------------------------------------
# the per-ion KNP solve
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def solves():
    """One coupled step of each package on 2-D res 1 (float64; a small
    mg_coarse_max gives the hierarchies levels), then the KNP solve alone
    on that state's inputs: JAX per-ion, port per-ion, port batched."""
    simJ = jax_simulation(jnp.float64, use_pallas=False, mg_coarse_max=100)
    mk = lambda batched: build_idealized(
        dim=2, resolution=1, g_syn_bar=10.0, dtype=torch.float64, device="cpu",
        solver_options=SolverOptions(mg_coarse_max=100, knp_batched=batched))
    simP, simB = mk(False), mk(True)
    assert not simJ.knp_sys.use_pallas and not simP.knp_solver.batched
    stepJ = jax.jit(simJ.step)
    sJ = stepJ(simJ.init_state())
    sP = simP.step(simP.init_state())
    sB = simB.step(simB.init_state())
    # the second step's KNP solve, from each package's own first step
    out = {}
    for key, sim, s in (("port", simP, sP), ("batched", simB, sB)):
        _, _, phi_M, I_ch = sim._membrane_odes(s)
        phi, _ = sim.emi_solver.solve(s.c, phi_M, I_ch, x0=s.phi)
        out[key] = sim.knp_solver.solve(s.c, phi, phi_M, I_ch, x0=s.c)
    s2 = stepJ(sJ)
    return dict(first=(sJ, sP, sB), jax_second=s2, **out)


def test_per_ion_first_step_matches_jax(solves):
    sJ, sP, _ = solves["first"]
    assert int(sP.knp_iters) == int(sJ.knp_iters)
    assert int(sP.emi_iters) == int(sJ.emi_iters)
    assert bool(sP.knp_ok)
    for tag in sJ.c:
        np.testing.assert_allclose(sP.c[tag].numpy(), np.asarray(sJ.c[tag]),
                                   rtol=1e-9, atol=0)


def test_per_ion_solve_matches_jax(solves):
    (c_solved, info), s2 = solves["port"], solves["jax_second"]
    assert info.iters == int(s2.knp_iters) and info.converged
    for tag in s2.c:
        np.testing.assert_allclose(c_solved[tag].numpy(), np.asarray(s2.c[tag])[:-1],
                                   rtol=1e-9, atol=0)


def test_per_ion_and_batched_agree_to_solver_tolerance(solves):
    """Both branches solve the same systems to rtol 1e-7 of the right-hand
    side; the solutions (O(1)-O(100) mM) then agree far inside 1e-6."""
    (cP, iP), (cB, iB) = solves["port"], solves["batched"]
    assert iP.converged and iB.converged
    assert abs(iP.iters - iB.iters) <= 1
    for tag in cP:
        np.testing.assert_allclose(cP[tag].numpy(), cB[tag].numpy(), rtol=1e-6, atol=0)
    _, sP, sB = solves["first"]
    for tag in sP.c:
        np.testing.assert_allclose(sP.c[tag].numpy(), sB.c[tag].numpy(), rtol=1e-6, atol=0)
