"""The port's assembly kernel functions against the JAX package's.

For each kernel of ``knpemi_tpu_torch/ops/assembly.py`` (K9, and K10 on
the membrane's P1 operator), K4 of ``ops/ell.py`` on the coefficient
maps, and K1, K2 and K3 of ``ops/p1op.py`` (the EMI
stiffness, the membrane surface mass and the ion-batched KNP operator
as an assembled P1 operator: K1 the values K1f fills, K2 the surface
mass summed at setup, K3 the unit mass, the unit stiffness and the
drift K11f fills, then the apply), the plain PyTorch version (what the
wrapper runs on CPU tensors) is held

* in float32 against the JAX Pallas wrapper in interpret mode, at
  5e-6 max|y| — the JAX kernels gather through bf16 split passes and
  sum in another order;
* in float64 against ``knpemi_tpu.ops.kernels`` (the XLA path), at
  1e-12 max|y|.

The JAX kernels work on a blocked cell layout (lane j*C + c = cell c of
a chunk, vertex slot j); lanes are mapped back to cells by their vertex
tuple.  Same inputs on both sides, made from a seed with numpy.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from knpemi_tpu.mesh import unit_square_mms_mesh, idealized_3d_mesh
from knpemi_tpu.ops import kernels as JK
from knpemi_tpu.ops import pallas_assembly as PA
from knpemi_tpu.ops.geometry import build_geometry
from knpemi_tpu.ops.pallas_ell import ellw_matvec

from knpemi_tpu_torch import ops
from knpemi_tpu_torch.ops import assembly as A
from knpemi_tpu_torch.ops import ell as E
from knpemi_tpu_torch.ops import p1op as P
from knpemi_tpu_torch.solvers import direct

MESHES = {
    "square12": lambda: unit_square_mms_mesh(12),
    "box3d0": lambda: idealized_3d_mesh(0, l=1),
}
TOL32 = 5e-6
TOL64 = 1e-12

_GEOMS = {}


def geometry(name):
    if name not in _GEOMS:
        _GEOMS[name] = build_geometry(MESHES[name]())
    return _GEOMS[name]


def t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def ti(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.int32)


def k1(x, sub, wv):
    """K1 as the EMI system applies it: K1f fills the subdomain's P1
    operator from wv, K1 applies it."""
    op = P.P1Operator(sub.cells, sub.n_dofs, "cpu")
    return P.emi_stiffness(x, op, P.emi_fill(op, t(sub.grads, x.dtype), wv))


def k2(x, sp, scale=1.0):
    """K2 as the EMI system applies it: the membrane's surface mass summed
    on its P1 operator at setup, then the apply."""
    op = P.P1Operator(sp.facet_dofs, sp.n_dofs, "cpu")
    return P.surface_mass(x, op, P.mass_values(op, sp.facet_dofs, sp.areas, x.dtype), scale)


def k10(V, sp):
    """K10 as the KNP system applies it: the row walk of the membrane
    operator's incidence list."""
    return A.facet_scatter(V, P.P1Operator(sp.facet_dofs, sp.n_dofs, "cpu"))


def k3(X, sub, w, coef, mass_only=False):
    """K3 as the KNP system applies it on the subdomain's P1 operator: the
    unit mass and unit stiffness assembled on the host, the drift filled
    by K11f from w = grad(phi) per cell; ``mass_only``: the right-hand
    side's apply, which reads the mass alone."""
    dtype = X.dtype
    op = P.P1Operator(sub.cells, sub.n_dofs, "cpu")
    M = P.mass_values(op, sub.cells, sub.vols, dtype)
    if mass_only:
        return P.knp_apply_batch(X, op, coef, M)
    Kst = t(op.assemble(direct._stiffness_coo(sub.cells, sub.grads, sub.vols)[2])[0], dtype)
    Dr = P.drift_fill(op, t(sub.grads, dtype), t(sub.vols, dtype), w)
    return P.knp_apply_batch(X, op, coef, M, Kst, Dr)


# K3's ions: diffusion coefficients and valences of up to three
K3_D, K3_Z = np.array([1.3, 2.0, 0.7]), np.array([1.0, -1.0, 2.0])


def close(y, y_ref, tol):
    y, y_ref = np.asarray(y, np.float64), np.asarray(y_ref, np.float64)
    scale = np.abs(y_ref).max()
    assert scale > 0
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=tol * scale)


def lanes(bk, rows):
    """Non-padding lanes of a blocking as (block, chunk, c, row index), the
    row found by its vertex tuple in ``rows`` (cells or facet dofs)."""
    lookup = {tuple(r): i for i, r in enumerate(np.asarray(rows))}
    real = np.asarray(bk.vols_lane)[:, :, 0, : bk.C] != 0
    b, h, c = np.nonzero(real)
    idx = np.array([lookup[tuple(r)] for r in bk.cells_chunk[b, h, c]])
    return b, h, c, idx


# ---------------------------------------------------------------------------
# float32 against the JAX Pallas kernels in interpret mode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh", list(MESHES))
def test_k1_emi_stiffness_vs_pallas(mesh):
    geom = geometry(mesh)
    for tag, sub in geom.subdomains.items():
        rng = np.random.default_rng(tag)
        x = rng.standard_normal(sub.n_dofs)
        kap = rng.uniform(1, 2, sub.n_dofs)
        bk = PA.build_blocking(sub.cells, sub.grads, sub.vols, sub.n_dofs)
        g32 = jnp.asarray(bk.grads_lane, jnp.float32)
        v32 = jnp.asarray(bk.vols_lane, jnp.float32)
        prep = PA.prepare_emi_weight(jnp.asarray(kap, jnp.float32), bk, v32)
        y_jax = PA.emi_stiffness_blocked(jnp.asarray(x, jnp.float32), prep, bk,
                                         g32, interpret=True)
        kbar = E.cell_mean_ell(sub.cells, sub.n_dofs, torch.float32, "cpu")
        wv = t(sub.vols) * E.ellw_matvec(kbar, t(kap))
        close(k1(t(x), sub, wv), y_jax, TOL32)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_k2_facet_mass_vs_pallas(mesh):
    geom = geometry(mesh)
    for m, sp in geom.membranes.items():
        g = np.random.default_rng(m).standard_normal(sp.n_dofs)
        kf = sp.facet_dofs.shape[1]
        bkm = PA.build_facet_blocking(sp.facet_dofs, sp.areas, sp.n_dofs)
        wv_lane = jnp.asarray(bkm.vols_lane / (kf * (kf + 1)), jnp.float32)
        y_jax = PA.facet_mass_blocked(jnp.asarray(g, jnp.float32), bkm, wv_lane,
                                      interpret=True)
        close(k2(t(g), sp), y_jax, TOL32)


def _k3_vs_pallas(mesh, B, mass_only):
    geom = geometry(mesh)
    dt_inv, psi = 10.0, 38.7
    D, z = (np.zeros(B), np.zeros(B)) if mass_only else (K3_D[:B], K3_Z[:B])
    for tag, sub in geom.subdomains.items():
        rng = np.random.default_rng(7 + tag)
        X = rng.standard_normal((B, sub.n_dofs))
        phi = rng.standard_normal(sub.n_dofs)
        bk = PA.build_blocking(sub.cells, sub.grads, sub.vols, sub.n_dofs)
        g32 = jnp.asarray(bk.grads_lane, jnp.float32)
        v32 = jnp.asarray(bk.vols_lane, jnp.float32)
        drift = PA.prepare_knp_drift(jnp.asarray(phi, jnp.float32), bk, g32)
        Y_jax = PA.knp_apply_blocked_batch(
            jnp.asarray(X, jnp.float32), bk, g32, v32, drift, dt_inv,
            jnp.asarray(D, jnp.float32), jnp.asarray(z, jnp.float32), psi,
            interpret=True)
        grad = E.cell_gradient_ell(sub.cells, sub.grads, sub.n_dofs, torch.float32, "cpu")
        w = E.ellw_matvec(grad, t(phi)).reshape(sub.n_cells, geom.dim)
        coef = t(np.stack([np.full(B, dt_inv), D, z * psi * D], axis=1))
        Y = k3(t(X), sub, w, coef, mass_only)
        for b in range(B):
            close(Y[b], Y_jax[b], TOL32)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_k3_knp_apply_batch_vs_pallas(mesh):
    _k3_vs_pallas(mesh, 2, mass_only=False)


@pytest.mark.parametrize("mass_only", [False, True], ids=["apply", "mass_only"])
@pytest.mark.parametrize("B", [1, 2, 3])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_k3_batch_sizes_vs_pallas(mesh, B, mass_only):
    """B = 1, 2, 3 ions, and the right-hand side's mass-only apply against
    the JAX kernel with D = z = 0."""
    _k3_vs_pallas(mesh, B, mass_only)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_k3_constant_field_float32(mesh):
    """The row-sum form in float32: on a constant field the stiffness adds
    exactly nothing (its off-diagonal slots meet x_j - x_i = 0, its
    diagonal slots hold an exact 0), whatever the rounding of its stored
    values; with grad(phi) = 0 the field maps to (1/dt) M 1, bit for bit
    the mass-only apply, and that to the scipy mass times the field."""
    geom = geometry(mesh)
    for tag, sub in geom.subdomains.items():
        rng = np.random.default_rng(40 + tag)
        op = P.P1Operator(sub.cells, sub.n_dofs, "cpu")
        M = P.mass_values(op, sub.cells, sub.vols, torch.float32)
        Kst = t(op.assemble(direct._stiffness_coo(sub.cells, sub.grads, sub.vols)[2])[0])
        X = torch.full((3, sub.n_dofs), 97.25)
        coef = t(np.stack([np.full(3, 10.0), K3_D, K3_Z * 38.7 * K3_D], axis=1))
        w = t(rng.standard_normal((sub.n_cells, geom.dim)) * 1e3)
        Dr = P.drift_fill(op, t(sub.grads), t(sub.vols), w)
        assert torch.equal(P.knp_apply_batch(X, op, coef, M, Kst, Dr),
                           P.knp_apply_batch(X, op, coef, M, torch.zeros_like(Kst), Dr))
        Y0 = k3(X, sub, torch.zeros_like(w), coef)
        Ym = k3(X, sub, w, coef, mass_only=True)
        assert torch.equal(Y0, Ym)
        M1 = direct._coo_accumulate(*[[a] for a in direct._mass_coo(
            sub.cells, sub.vols, 10.0)], sub.n_dofs) @ np.full(sub.n_dofs, 97.25)
        for b in range(3):
            close(Ym[b], M1, 1e-6)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_k4_ell_matvec_vs_pallas(mesh):
    """Both frozen coefficient maps: mean-vertex kappa and grad(phi) per
    cell, against ellw_matvec on build_interp_ellw's layout."""
    geom = geometry(mesh)
    for tag, sub in geom.subdomains.items():
        rng = np.random.default_rng(10 + tag)
        kap = rng.uniform(1, 2, sub.n_dofs)
        phi = rng.standard_normal(sub.n_dofs)
        bk = PA.build_blocking(sub.cells, sub.grads, sub.vols, sub.n_dofs)
        b, h, c, cell = lanes(bk, sub.cells)
        k_c = bk.k
        pad = (bk.vols_lane[:, :, 0, : bk.C] != 0)[:, :, None, None, :]
        kbar_e = PA.build_interp_ellw(bk, np.broadcast_to(
            pad / k_c, (bk.n_blocks, bk.n_chunks, 1, k_c, bk.C)))
        kbar_jax = np.asarray(ellw_matvec(
            kbar_e.device(jnp.float32), jnp.asarray(kap, jnp.float32), True
        )).reshape(bk.n_blocks, bk.n_chunks, bk.C)[b, h, c]
        kmap = E.cell_mean_ell(sub.cells, sub.n_dofs, torch.float32, "cpu")
        kbar = E.ellw_matvec(kmap, t(kap)).numpy()[cell]
        close(kbar, kbar_jax, TOL32)

        drift_e = PA.build_interp_ellw(bk, bk.grads_lane.reshape(
            bk.n_blocks, bk.n_chunks, bk.dim, bk.k, bk.C))
        w_jax = np.asarray(ellw_matvec(
            drift_e.device(jnp.float32), jnp.asarray(phi, jnp.float32), True
        )).reshape(bk.n_blocks, bk.n_chunks, bk.dim, bk.C)[b, h, :, c]
        grad = E.cell_gradient_ell(sub.cells, sub.grads, sub.n_dofs, torch.float32, "cpu")
        w = E.ellw_matvec(grad, t(phi)).reshape(sub.n_cells, -1).numpy()
        close(w[cell], w_jax, TOL32)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_k9_facet_gather_vs_pallas(mesh):
    geom = geometry(mesh)
    for m, sp in geom.membranes.items():
        X = np.random.default_rng(20 + m).standard_normal((5, sp.n_dofs))
        bkm = PA.build_facet_blocking(sp.facet_dofs, sp.areas, sp.n_dofs)
        G_jax = np.asarray(PA.facet_gather_blocked(
            jnp.asarray(X, jnp.float32), bkm, interpret=True))
        G = A.facet_gather(t(X), ti(sp.facet_dofs)).numpy()
        b, h, c, f = lanes(bkm, sp.facet_dofs)
        for j in range(bkm.k):
            close(G[:, f, j].T, G_jax[b, h, :, j * bkm.C + c], 0.0)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_k10_facet_scatter_vs_pallas(mesh):
    geom = geometry(mesh)
    for m, sp in geom.membranes.items():
        bkm = PA.build_facet_blocking(sp.facet_dofs, sp.areas, sp.n_dofs)
        b, h, c, f = lanes(bkm, sp.facet_dofs)
        F, k = 4, bkm.k
        V = np.zeros((F, sp.n_facets, k))
        V[:, f] = np.random.default_rng(30 + m).standard_normal((F, len(f), k))
        Vb = np.zeros((bkm.n_blocks, bkm.n_chunks, F, k * bkm.C))
        for j in range(k):
            Vb[b, h, :, j * bkm.C + c] = V[:, f, j].T
        Y_jax = PA.facet_scatter_blocked(jnp.asarray(Vb, jnp.float32), bkm,
                                         interpret=True)
        close(k10(t(V), sp), Y_jax, TOL32)


# ---------------------------------------------------------------------------
# float64 against the JAX package's XLA element kernels
# ---------------------------------------------------------------------------
def _f64_case(kernel, geom):
    rng = np.random.default_rng(3)
    f64 = lambda a: t(a, torch.float64)
    J = lambda a: jnp.asarray(np.asarray(a), jnp.float64)
    Ji = lambda a: jnp.asarray(np.asarray(a))
    if kernel in ("K1", "K3", "K4"):
        sub = geom.subdomains[0]
        cells, n = sub.cells, sub.n_dofs
        x, kap, phi = rng.standard_normal(n), rng.uniform(1, 2, n), rng.standard_normal(n)
        if kernel == "K1":
            kmap = E.cell_mean_ell(cells, n, torch.float64, "cpu")
            wv = f64(sub.vols) * E.ellw_matvec(kmap, f64(kap))
            y = k1(f64(x), sub, wv)
            y_ref = JK.stiffness_apply(n, J(x), Ji(cells), J(sub.grads), J(sub.vols),
                                       coef_vertex=J(kap))
            return [(y, y_ref)]
        grad = E.cell_gradient_ell(cells, sub.grads, n, torch.float64, "cpu")
        w = E.ellw_matvec(grad, f64(phi)).reshape(sub.n_cells, -1)
        w_ref = JK.cell_gradients(J(phi), Ji(cells), J(sub.grads))
        if kernel == "K4":
            kmap = E.cell_mean_ell(cells, n, torch.float64, "cpu")
            kbar = E.ellw_matvec(kmap, f64(kap))
            return [(w, w_ref), (kbar, J(kap)[Ji(cells)].mean(axis=1))]
        return _k3_f64(rng, sub, w, w_ref, 2, mass_only=False)
    sp = geom.membranes[1]
    fd, n_m = sp.facet_dofs, sp.n_dofs
    kf = fd.shape[1]
    X = rng.standard_normal((3, n_m))
    if kernel == "K2":
        y = k2(f64(X[0]), sp)
        y_ref = JK.scatter_add(n_m, Ji(fd), JK.facet_mass_values(J(X[0])[Ji(fd)], J(sp.areas)))
        return [(y, y_ref)]
    if kernel == "K9":
        return [(A.facet_gather(f64(X), ti(fd)), J(X)[:, Ji(fd)])]
    V = rng.standard_normal((3, sp.n_facets, kf))
    Y = k10(f64(V), sp)
    return [(Y[i], JK.scatter_add(n_m, Ji(fd), J(V[i]))) for i in range(3)]


def _k3_f64(rng, sub, w, w_ref, B, mass_only):
    f64 = lambda a: t(a, torch.float64)
    J = lambda a: jnp.asarray(np.asarray(a), jnp.float64)
    cells, n = jnp.asarray(sub.cells), sub.n_dofs
    X = rng.standard_normal((B, n))
    dt_inv, psi = 10.0, 38.7
    D, z = (np.zeros(B), np.zeros(B)) if mass_only else (K3_D[:B], K3_Z[:B])
    coef = f64(np.stack([np.full(B, dt_inv), D, z * psi * D], axis=1))
    Y = k3(f64(X), sub, w, coef, mass_only)
    out = []
    for b in range(B):
        y_ref = (dt_inv * JK.mass_apply(n, J(X[b]), cells, J(sub.vols))
                 + D[b] * JK.stiffness_apply(n, J(X[b]), cells, J(sub.grads),
                                             J(sub.vols))
                 + z[b] * psi * D[b] * JK.drift_apply(
                     n, J(X[b]), cells, J(sub.grads), J(sub.vols), w_ref))
        out.append((Y[b], y_ref))
    return out


@pytest.mark.parametrize("mass_only", [False, True], ids=["apply", "mass_only"])
@pytest.mark.parametrize("B", [1, 2, 3])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_k3_batch_sizes_f64_vs_xla(mesh, B, mass_only):
    geom = geometry(mesh)
    rng = np.random.default_rng(9)
    for tag, sub in geom.subdomains.items():
        phi = rng.standard_normal(sub.n_dofs)
        grad = E.cell_gradient_ell(sub.cells, sub.grads, sub.n_dofs, torch.float64, "cpu")
        w = E.ellw_matvec(grad, t(phi, torch.float64))
        w_ref = JK.cell_gradients(jnp.asarray(phi), jnp.asarray(sub.cells),
                                  jnp.asarray(sub.grads))
        for y, y_ref in _k3_f64(rng, sub, w.reshape(sub.n_cells, -1), w_ref, B, mass_only):
            close(y, y_ref, TOL64)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K4", "K9", "K10"])
def test_kernel_f64_vs_xla(kernel, mesh):
    for y, y_ref in _f64_case(kernel, geometry(mesh)):
        close(y, y_ref, TOL64)


def test_wrappers_take_plain_path_on_cpu_and_check_inputs():
    """CPU tensors go to the plain version without a launch; bad inputs
    raise before anything runs."""
    geom = geometry("square12")
    sub = geom.subdomains[0]
    op = P.P1Operator(sub.cells, sub.n_dofs, "cpu")
    ops.reset_launch_counts()
    x = t(np.ones(sub.n_dofs))
    vals = P.emi_fill(op, t(sub.grads), t(sub.vols))
    assert torch.equal(vals, P.emi_fill_plain(op, t(sub.grads), t(sub.vols)))
    y = P.emi_stiffness(x, op, vals)
    assert torch.allclose(y, P.emi_stiffness_plain(x, op, vals))
    assert all(v == 0 for v in ops.launch_counts().values())
    with pytest.raises(TypeError):
        P.emi_fill(op, t(sub.grads, torch.float64), t(sub.vols))
    with pytest.raises(ValueError):
        P.emi_fill(op, t(sub.grads), t(sub.vols)[:-1])
    with pytest.raises(TypeError):
        P.emi_stiffness(x, op, vals.double())
    with pytest.raises(ValueError):
        P.emi_stiffness(x, op, vals[:-1])
    sp = geom.membranes[1]
    mop = P.P1Operator(sp.facet_dofs, sp.n_dofs, "cpu")
    mvals = P.mass_values(mop, sp.facet_dofs, sp.areas, torch.float32)
    with pytest.raises(ValueError):
        P.surface_mass(t(np.ones(2 * sp.n_dofs))[::2], mop, mvals)
    with pytest.raises(ValueError):
        A.facet_scatter(t(np.ones((2, sp.n_facets + 1, 2))), mop)
