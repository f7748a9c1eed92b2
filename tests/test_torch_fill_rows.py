"""The per-solve fills K1f and K11f (``knpemi_tpu_torch/ops/p1op.py``) as a
row-parallel walk of each P1 operator's incidence list, on the CPU.

On every subdomain of the idealized 2-D and 3-D res-1 meshes and of the
astrocyte tissue mesh at ``mesh_n=10``:

* the incidence list holds every (cell, local vertex) pair once, in the
  row of that vertex, cells ascending within a row, padding -1 after a
  row's last entry, in the 32-row slices of the operator's ``slot_ptr``;
* the plain fills, which walk the list, equal the CSR built from the COO
  helpers of ``solvers/direct.py`` in float64 to 1e-13 of max|A|;
* only the fills, which read the incidence list, check it: a list of
  the wrong dtype is refused by both fills and ignored by the applies;
* in float32, the fill then the plain apply equal the JAX package's
  ``prepare_emi_weight`` + ``emi_stiffness_blocked`` (K1) and
  ``prepare_knp_drift`` + ``knp_apply_blocked_batch`` (K3), its Pallas
  kernels run in interpret mode, at ``test_torch_kernels.py``'s 5e-6 of
  max|y| (the JAX kernels gather through bf16 split passes).

Also: the list is built once per operator (counted in ``nbytes``, timed
in ``Simulation.setup_seconds``) and an EMI hierarchy refresh leaves it
in place.  Inputs are made from a seed with numpy; float32 is passed to
JAX explicitly (the test configuration turns on x64).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from knpemi_tpu.mesh import idealized_2d_mesh, idealized_3d_mesh
from knpemi_tpu.mesh import tissue as jtissue
from knpemi_tpu.ops import pallas_assembly as PA
from knpemi_tpu.ops.geometry import build_geometry

from knpemi_tpu_torch.ops import assembly as A
from knpemi_tpu_torch.ops import ell as E
from knpemi_tpu_torch.ops import p1op as P
from knpemi_tpu_torch.solvers import direct as D

MESHES = {
    "2d_res1": lambda: idealized_2d_mesh(1),
    "3d_res1": lambda: idealized_3d_mesh(1),
    "tissue10": lambda: jtissue.astrocyte_tissue_mesh(n=10),
}
TAGS = {"2d_res1": (0, 1), "3d_res1": (0, 1), "tissue10": (0, 1, 2)}
CASES = [(m, t) for m in MESHES for t in TAGS[m]]
TOL64 = 1e-13
TOL32 = 5e-6

_GEOMS, _OPS = {}, {}


def geometry(mesh):
    if mesh not in _GEOMS:
        _GEOMS[mesh] = build_geometry(MESHES[mesh]())
    return _GEOMS[mesh]


def case(mesh, tag):
    """(subdomain, its P1Operator on the CPU), built once per module."""
    if (mesh, tag) not in _OPS:
        sub = geometry(mesh).subdomains[tag]
        _OPS[mesh, tag] = sub, P.P1Operator(sub.cells, sub.n_dofs, "cpu")
    return _OPS[mesh, tag]


def t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def close(y, y_ref, tol):
    y, y_ref = np.asarray(y, np.float64), np.asarray(y_ref, np.float64)
    scale = np.abs(y_ref).max()
    assert scale > 0
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=tol * scale)


def close_matrix(A_, A_ref):
    A_ref = A_ref.tocsr()
    scale = abs(A_ref).max()
    assert scale > 0
    assert abs(A_ - A_ref).max() <= TOL64 * scale


@pytest.mark.parametrize("mesh,tag", CASES)
def test_incidence_list_invariants(mesh, tag):
    sub, op = case(mesh, tag)
    nc, k = sub.cells.shape
    inc_ptr, inc = op.inc_ptr.numpy().astype(np.int64), op.inc.numpy()
    assert op.inc_ptr.dtype == torch.int32 and op.inc.dtype == torch.int32
    # the slices of slot_ptr: as many, each L[s] = its longest list x 32 rows
    NS = op.slot_ptr.shape[0] - 1
    assert inc_ptr.shape[0] == NS + 1 and inc_ptr[0] == 0 and inc_ptr[-1] == inc.shape[0]
    deg = np.zeros(NS * 32, np.int64)
    deg[: op.n] = np.bincount(sub.cells.ravel(), minlength=op.n)
    L = deg.reshape(NS, 32).max(axis=1)
    np.testing.assert_array_equal(np.diff(inc_ptr), 32 * L)
    # every (c, i) once, in the row of its vertex at entry e < deg(row)
    s = np.repeat(np.arange(NS), np.diff(inc_ptr))
    q = np.arange(inc.shape[0]) - inc_ptr[s]
    row, e = 32 * s + q % 32, q // 32
    real = inc >= 0
    assert np.all(inc[~real] == -1)
    np.testing.assert_array_equal(real, e < deg[row])
    c, i = inc[real] >> 2, inc[real] & 3
    np.testing.assert_array_equal(np.sort(c * k + i), np.arange(nc * k))
    np.testing.assert_array_equal(sub.cells[c, i], row[real])
    # cells ascending along each row's entries
    order = np.lexsort((e[real], row[real]))
    same_row = np.diff(row[real][order]) == 0
    assert np.all(np.diff(c[order])[same_row] > 0)


@pytest.mark.parametrize("mesh,tag", CASES)
def test_plain_fills_equal_the_coo_csr_f64(mesh, tag):
    """K1f with wv = vol * mean-vertex kappa against the kappa-weighted
    stiffness of the COO helper; K11f against the P1 drift element
    vol (w . g_i) / k; both through the incidence list."""
    sub, op = case(mesh, tag)
    rng = np.random.default_rng(tag)
    kap = rng.uniform(1.0, 2.0, sub.n_dofs)
    w = rng.standard_normal((sub.n_cells, sub.grads.shape[-1]))
    wv = sub.vols * kap[sub.cells].mean(axis=1)
    r, c, Ke = D._stiffness_coo(sub.cells, sub.grads, sub.vols, coef_vertex=kap)
    V = P.emi_fill(op, t(sub.grads), t(wv))
    close_matrix(op.scipy_csr(V), D._coo_accumulate([r], [c], [Ke], op.n))
    assert torch.equal(V[op.diag_slot], torch.zeros(op.n, dtype=V.dtype))
    k = sub.cells.shape[1]
    De = np.repeat((sub.vols[:, None] * np.einsum("cd,ckd->ck", w, sub.grads) / k)[:, :, None],
                   k, axis=2)
    Dr = P.drift_fill(op, t(sub.grads), t(sub.vols), t(w))
    close_matrix(op.scipy_csr(Dr), D._coo_accumulate([r], [c], [De], op.n))


@pytest.mark.parametrize("mesh,tag", CASES)
def test_only_the_fills_check_the_list(mesh, tag):
    """The fills refuse an incidence list their kernels cannot read (int64
    entries); the applies K1, K11 and K3, which never read it, do not
    check it and give the same values."""
    import copy

    sub, op = case(mesh, tag)
    rng = np.random.default_rng(11 + tag)
    g, vols = t(sub.grads), t(sub.vols)
    wv, w = t(sub.vols * rng.uniform(1.0, 2.0, sub.n_cells)), t(rng.normal(size=(sub.n_cells, g.shape[-1])))
    x, X = t(rng.normal(size=op.n)), t(rng.normal(size=(2, op.n)))
    coef = t(np.array([[10.0, 1.0, 0.5], [10.0, 2.0, -1.0]]))
    bad = copy.copy(op)
    bad.inc = op.inc.long()
    for fill, args in ((P.emi_fill, (g, wv)), (P.drift_fill, (g, vols, w))):
        with pytest.raises(TypeError):
            fill(bad, *args)
    V, Dr = P.emi_fill(op, g, wv), P.drift_fill(op, g, vols, w)
    assert torch.equal(P.emi_stiffness(x, bad, V), P.emi_stiffness(x, op, V))
    assert torch.equal(P.knp_apply(x, bad, V, Dr, 0.3), P.knp_apply(x, op, V, Dr, 0.3))
    assert torch.equal(P.knp_apply_batch(X, bad, coef, V, V, Dr),
                       P.knp_apply_batch(X, op, coef, V, V, Dr))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_fill_then_k1_vs_pallas(mesh):
    f32 = torch.float32
    for tag in TAGS[mesh]:
        sub, op = case(mesh, tag)
        rng = np.random.default_rng(tag)
        x = rng.standard_normal(sub.n_dofs)
        kap = rng.uniform(1, 2, sub.n_dofs)
        bk = PA.build_blocking(sub.cells, sub.grads, sub.vols, sub.n_dofs)
        g32 = jnp.asarray(bk.grads_lane, jnp.float32)
        v32 = jnp.asarray(bk.vols_lane, jnp.float32)
        prep = PA.prepare_emi_weight(jnp.asarray(kap, jnp.float32), bk, v32)
        y_jax = PA.emi_stiffness_blocked(jnp.asarray(x, jnp.float32), prep, bk, g32,
                                         interpret=True)
        kbar = E.cell_mean_ell(sub.cells, sub.n_dofs, f32, "cpu")
        wv = t(sub.vols, f32) * E.ellw_matvec(kbar, t(kap, f32))
        V = P.emi_fill(op, t(sub.grads, f32), wv)
        close(P.emi_stiffness_plain(t(x, f32), op, V), y_jax, TOL32)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_fill_then_k3_vs_pallas(mesh):
    f32 = torch.float32
    dt_inv, psi = 10.0, 38.7
    Dc, z = np.array([1.3, 2.0]), np.array([1.0, -1.0])
    geom = geometry(mesh)
    for tag in TAGS[mesh]:
        sub, op = case(mesh, tag)
        rng = np.random.default_rng(7 + tag)
        X = rng.standard_normal((2, sub.n_dofs))
        phi = rng.standard_normal(sub.n_dofs)
        bk = PA.build_blocking(sub.cells, sub.grads, sub.vols, sub.n_dofs)
        g32 = jnp.asarray(bk.grads_lane, jnp.float32)
        v32 = jnp.asarray(bk.vols_lane, jnp.float32)
        drift = PA.prepare_knp_drift(jnp.asarray(phi, jnp.float32), bk, g32)
        Y_jax = PA.knp_apply_blocked_batch(
            jnp.asarray(X, jnp.float32), bk, g32, v32, drift, dt_inv,
            jnp.asarray(Dc, jnp.float32), jnp.asarray(z, jnp.float32), psi, interpret=True)
        grad = E.cell_gradient_ell(sub.cells, sub.grads, sub.n_dofs, f32, "cpu")
        w = E.ellw_matvec(grad, t(phi, f32)).reshape(sub.n_cells, geom.dim)
        Dr = P.drift_fill(op, t(sub.grads, f32), t(sub.vols, f32), w)
        M = P.mass_values(op, sub.cells, sub.vols, f32)
        Kst = t(op.assemble(D._stiffness_coo(sub.cells, sub.grads, sub.vols)[2])[0], f32)
        coef = t(np.stack([np.full(2, dt_inv), Dc, z * psi * Dc], axis=1), f32)
        Y = P.knp_apply_batch_plain(t(X, f32), op, coef, M, Kst, Dr)
        for b in range(2):
            close(Y[b], Y_jax[b], TOL32)


def test_list_is_built_once_and_counted():
    """nbytes counts the list; the set-up times it as its own part."""
    from knpemi_tpu_torch.sim import build_idealized

    sim = build_idealized(dim=2, resolution=1, dtype=torch.float64, device="cpu")
    assert "p1_incidence" in sim.setup_seconds
    assert sim.setup_seconds["p1_incidence"] >= 0.0 and sim.setup_seconds["p1_operators"] >= 0.0
    for s in sim.emi_sys.sub.values():
        op = s["op"]
        pattern = sum(x.numel() * x.element_size()
                      for x in (op.slot_ptr, op.col, op.cells, op.pos))
        assert op.nbytes == pattern + 4 * (op.inc_ptr.numel() + op.inc.numel())


def test_refresh_leaves_the_list_in_place():
    """The pattern is frozen, so an EMI hierarchy refresh never touches the
    incidence list: same tensors, same storage, same values."""
    from knpemi_tpu_torch.sim import build_idealized

    sim = build_idealized(dim=2, resolution=1, dtype=torch.float64, device="cpu")
    ops = {t: s["op"] for t, s in sim.emi_sys.sub.items()}
    before = {t: (op.inc, op.inc.data_ptr(), op.inc.clone(), op.inc_ptr.data_ptr(),
                  op.inc_ptr.clone()) for t, op in ops.items()}
    state, *_ = sim.run(sim.init_state(), 2)
    sim.refresh_mg(state)
    assert sim.refresh_counts["installed"] == 1
    for tag, (inc, ptr, vals, pptr, pvals) in before.items():
        op = sim.emi_sys.sub[tag]["op"]
        assert op is ops[tag] and sim.knp_sys.sub[tag]["op"] is op and op.inc is inc
        assert op.inc.data_ptr() == ptr and op.inc_ptr.data_ptr() == pptr
        assert torch.equal(op.inc, vals) and torch.equal(op.inc_ptr, pvals)


def test_operator_refuses_what_the_list_cannot_pack():
    """c << 2 | i in an int32: at most 4 vertices a cell, fewer than 2^29
    cells; refused before any work."""
    with pytest.raises(ValueError):
        P.P1Operator(np.arange(10).reshape(2, 5), 10, "cpu")
    with pytest.raises(ValueError):
        P.P1Operator(np.broadcast_to(np.arange(4), (1 << 29, 4)), 4, "cpu")
