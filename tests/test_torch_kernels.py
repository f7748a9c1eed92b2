"""The port's six kernel functions against the JAX package's.

For each kernel of ``knpemi_tpu_torch/ops/assembly.py`` the plain
PyTorch version (what the wrapper runs on CPU tensors) is held

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
        kc, kv = A.cell_mean_ell(sub.cells, sub.n_dofs)
        wv = t(sub.vols) * A.ell_matvec(ti(kc), t(kv), t(kap))
        y = A.emi_stiffness(t(x), ti(sub.cells), t(sub.grads), wv)
        close(y, y_jax, TOL32)


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
        y = A.facet_mass(t(g), ti(sp.facet_dofs), t(sp.areas / (kf * (kf + 1))))
        close(y, y_jax, TOL32)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_k3_knp_apply_batch_vs_pallas(mesh):
    geom = geometry(mesh)
    dt_inv, psi = 10.0, 38.7
    D, z = np.array([1.3, 2.0]), np.array([1.0, -1.0])
    for tag, sub in geom.subdomains.items():
        rng = np.random.default_rng(7 + tag)
        X = rng.standard_normal((2, sub.n_dofs))
        phi = rng.standard_normal(sub.n_dofs)
        bk = PA.build_blocking(sub.cells, sub.grads, sub.vols, sub.n_dofs)
        g32 = jnp.asarray(bk.grads_lane, jnp.float32)
        v32 = jnp.asarray(bk.vols_lane, jnp.float32)
        drift = PA.prepare_knp_drift(jnp.asarray(phi, jnp.float32), bk, g32)
        Y_jax = PA.knp_apply_blocked_batch(
            jnp.asarray(X, jnp.float32), bk, g32, v32, drift, dt_inv,
            jnp.asarray(D, jnp.float32), jnp.asarray(z, jnp.float32), psi,
            interpret=True)
        gc, gv = A.cell_gradient_ell(sub.cells, sub.grads, sub.n_dofs)
        w = A.ell_matvec(ti(gc), t(gv), t(phi)).reshape(sub.n_cells, geom.dim)
        coef = t(np.stack([np.full(2, dt_inv), D, z * psi * D], axis=1))
        Y = A.knp_apply_batch(t(X), ti(sub.cells), t(sub.grads), t(sub.vols), w, coef)
        for b in range(2):
            close(Y[b], Y_jax[b], TOL32)


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
        kc, kv = A.cell_mean_ell(sub.cells, sub.n_dofs)
        kbar = A.ell_matvec(ti(kc), t(kv), t(kap)).numpy()[cell]
        close(kbar, kbar_jax, TOL32)

        drift_e = PA.build_interp_ellw(bk, bk.grads_lane.reshape(
            bk.n_blocks, bk.n_chunks, bk.dim, bk.k, bk.C))
        w_jax = np.asarray(ellw_matvec(
            drift_e.device(jnp.float32), jnp.asarray(phi, jnp.float32), True
        )).reshape(bk.n_blocks, bk.n_chunks, bk.dim, bk.C)[b, h, :, c]
        gc, gv = A.cell_gradient_ell(sub.cells, sub.grads, sub.n_dofs)
        w = A.ell_matvec(ti(gc), t(gv), t(phi)).reshape(sub.n_cells, -1).numpy()
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
        Y = A.facet_scatter(t(V), ti(sp.facet_dofs), sp.n_dofs)
        close(Y, Y_jax, TOL32)


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
            kc, kv = A.cell_mean_ell(cells, n)
            wv = f64(sub.vols) * A.ell_matvec(ti(kc), f64(kv), f64(kap))
            y = A.emi_stiffness(f64(x), ti(cells), f64(sub.grads), wv)
            y_ref = JK.stiffness_apply(n, J(x), Ji(cells), J(sub.grads), J(sub.vols),
                                       coef_vertex=J(kap))
            return [(y, y_ref)]
        gc, gv = A.cell_gradient_ell(cells, sub.grads, n)
        w = A.ell_matvec(ti(gc), f64(gv), f64(phi)).reshape(sub.n_cells, -1)
        w_ref = JK.cell_gradients(J(phi), Ji(cells), J(sub.grads))
        if kernel == "K4":
            kc, kv = A.cell_mean_ell(cells, n)
            kbar = A.ell_matvec(ti(kc), f64(kv), f64(kap))
            return [(w, w_ref), (kbar, J(kap)[Ji(cells)].mean(axis=1))]
        X = rng.standard_normal((2, n))
        dt_inv, psi, D, z = 10.0, 38.7, [1.3, 2.0], [1.0, -1.0]
        coef = f64([[dt_inv, D[b], z[b] * psi * D[b]] for b in range(2)])
        Y = A.knp_apply_batch(f64(X), ti(cells), f64(sub.grads), f64(sub.vols), w, coef)
        out = []
        for b in range(2):
            y_ref = (dt_inv * JK.mass_apply(n, J(X[b]), Ji(cells), J(sub.vols))
                     + D[b] * JK.stiffness_apply(n, J(X[b]), Ji(cells), J(sub.grads),
                                                 J(sub.vols))
                     + z[b] * psi * D[b] * JK.drift_apply(
                         n, J(X[b]), Ji(cells), J(sub.grads), J(sub.vols), w_ref))
            out.append((Y[b], y_ref))
        return out
    sp = geom.membranes[1]
    fd, n_m = sp.facet_dofs, sp.n_dofs
    kf = fd.shape[1]
    X = rng.standard_normal((3, n_m))
    if kernel == "K2":
        y = A.facet_mass(f64(X[0]), ti(fd), f64(sp.areas / (kf * (kf + 1))))
        y_ref = JK.scatter_add(n_m, Ji(fd), JK.facet_mass_values(J(X[0])[Ji(fd)], J(sp.areas)))
        return [(y, y_ref)]
    if kernel == "K9":
        return [(A.facet_gather(f64(X), ti(fd)), J(X)[:, Ji(fd)])]
    V = rng.standard_normal((3, sp.n_facets, kf))
    Y = A.facet_scatter(f64(V), ti(fd), n_m)
    return [(Y[i], JK.scatter_add(n_m, Ji(fd), J(V[i]))) for i in range(3)]


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
    ops.reset_launch_counts()
    x = t(np.ones(sub.n_dofs))
    y = A.emi_stiffness(x, ti(sub.cells), t(sub.grads), t(sub.vols))
    assert torch.allclose(y, A.emi_stiffness_plain(x, ti(sub.cells), t(sub.grads),
                                                   t(sub.vols)))
    assert all(v == 0 for v in ops.launch_counts().values())
    with pytest.raises(TypeError):
        A.emi_stiffness(x, ti(sub.cells), t(sub.grads, torch.float64), t(sub.vols))
    with pytest.raises(ValueError):
        A.emi_stiffness(x, ti(sub.cells), t(sub.grads), t(sub.vols)[:-1])
    with pytest.raises(ValueError):
        A.facet_mass(x[::2], ti(geom.membranes[1].facet_dofs),
                     t(geom.membranes[1].areas))
