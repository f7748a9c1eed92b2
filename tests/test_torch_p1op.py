"""The assembled P1 operator of ``knpemi_tpu_torch/ops/p1op.py`` on the CPU.

Each subdomain of the idealized res-1 meshes (2-D and 3-D: the ECS and
the cells) is held against scipy:

* the sliced-ELL pattern is the CSR of the P1 graph of the cells, its
  padding at column = the row with value 0;
* its slots per nonzero stay near 1 (a slice pads each row to the
  longest of its 32);
* every cell's vertex-pair position locates the slot of (v_i, v_j);
* in float64 the constant values (unit stiffness ``Kst``, the KNP ions'
  P_b = dt_inv M + D_b K) and the plain fills (K1f: the kappa-weighted
  stiffness; K11f: the drift along a cellwise w) equal the CSR built
  from the COO helpers of ``solvers/direct.py`` to 1e-14 of max|A|
  (bincount and scipy sum the duplicates in other orders);
* the plain apply, with one value stream and with two, equals the scipy
  CSR product to 1e-14 of max|y| on a nearly uniform field (the values
  are stored in the row-sum form: a row's diagonal slot holds its sum,
  and the apply sums V_ij (x_j - x_i));
* in float32 the stiffness maps a constant to exactly 0.

Against the JAX package the operators are held in
``test_torch_kernels.py`` (K1) and ``test_torch_per_ion.py`` (K11).
Inputs are made from a seed with numpy.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from knpemi_tpu_torch import ops
from knpemi_tpu_torch.mesh import idealized_2d_mesh, idealized_3d_mesh
from knpemi_tpu_torch.ops import p1op as P
from knpemi_tpu_torch.ops.geometry import build_geometry
from knpemi_tpu_torch.solvers import direct as D
from knpemi_tpu_torch.systems.knp import ion_operator_values

MESHES = {"2d_res1": lambda: idealized_2d_mesh(1), "3d_res1": lambda: idealized_3d_mesh(1)}
CASES = [(m, t) for m in MESHES for t in (0, 1)]
TOL = 1e-14
# slots per nonzero: the ECS, and the thin cell subdomains (a few thousand
# dofs whose 32-row slices mix short and long rows)
MAX_SLOTS_PER_NNZ = {0: 1.11, 1: 1.35}

_SUBS = {}


def case(mesh, tag):
    """(subdomain, its P1Operator on the CPU), built once per module."""
    if (mesh, tag) not in _SUBS:
        sub = build_geometry(MESHES[mesh]()).subdomains[tag]
        _SUBS[mesh, tag] = sub, P.P1Operator(sub.cells, sub.n_dofs, "cpu")
    return _SUBS[mesh, tag]


def csr(rows, cols, vals, n):
    return D._coo_accumulate([rows], [cols], [vals], n)


def close_matrix(A, A_ref):
    A_ref = A_ref.tocsr()
    scale = abs(A_ref).max()
    assert scale > 0
    assert abs(A - A_ref).max() <= TOL * scale


def f64(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


@pytest.mark.parametrize("mesh,tag", CASES)
def test_pattern_is_the_p1_graph(mesh, tag):
    sub, op = case(mesh, tag)
    k = sub.cells.shape[1]
    G = csr(np.repeat(sub.cells, k, axis=1).ravel(), np.tile(sub.cells, (1, k)).ravel(),
            np.ones(sub.cells.size * k), sub.n_dofs)
    G.sort_indices()
    sl = op.csr_slots()
    assert op.nnz == G.nnz
    np.testing.assert_array_equal(op.scipy_csr(torch.zeros(op.slots)).indptr, G.indptr)
    np.testing.assert_array_equal(op.col.numpy()[sl], G.indices)
    # every other slot is padding: column = its row (the last dof past n)
    pad = np.ones(op.slots, bool)
    pad[sl] = False
    rows = op._plain("slot_rows").numpy()
    np.testing.assert_array_equal(op.col.numpy()[pad], np.minimum(rows[pad], op.n - 1))
    assert op.slot_ptr.dtype == torch.int32 and op.pos.dtype == torch.uint8
    assert int(op.slot_ptr[-1]) == op.slots and op.slot_ptr.shape[0] == -(-op.n // 32) + 1


@pytest.mark.parametrize("mesh,tag", CASES)
def test_slots_per_nonzero(mesh, tag):
    _, op = case(mesh, tag)
    assert 1.0 <= op.slots / op.nnz <= MAX_SLOTS_PER_NNZ[tag]


@pytest.mark.parametrize("mesh,tag", CASES)
def test_pair_positions_locate_their_slots(mesh, tag):
    sub, op = case(mesh, tag)
    slots = op.pair_slots_host()
    rows = op._plain("slot_rows").numpy()
    np.testing.assert_array_equal(rows[slots], np.broadcast_to(sub.cells[:, :, None], slots.shape))
    np.testing.assert_array_equal(op.col.numpy()[slots],
                                  np.broadcast_to(sub.cells[:, None, :], slots.shape))
    # the device form of the positions is the host one
    v = op.cells.long()[:, :, None]
    dev = op.slot_ptr.long()[v // 32] + 32 * op.pos.long() + v % 32
    np.testing.assert_array_equal(dev.numpy(), slots)


@pytest.mark.parametrize("mesh,tag", CASES)
def test_constant_values_equal_the_coo_csr_f64(mesh, tag):
    sub, op = case(mesh, tag)
    r, c, Ke = D._stiffness_coo(sub.cells, sub.grads, sub.vols)
    _, _, Me = D._mass_coo(sub.cells, sub.vols, 10.0)
    close_matrix(op.scipy_csr(op.assemble(Ke)[0]), csr(r, c, Ke, op.n))
    Ds = [1.3e-9, 2.0e-9]
    for Dc, Pb in zip(Ds, ion_operator_values(op, sub.cells, sub.grads, sub.vols, 10.0, Ds,
                                              torch.float64)):
        close_matrix(op.scipy_csr(Pb), csr(r, c, Me + Dc * Ke, op.n))


@pytest.mark.parametrize("mesh,tag", CASES)
def test_fills_equal_the_coo_csr_f64(mesh, tag):
    """K1f with wv = vol * mean-vertex kappa against the kappa-weighted
    stiffness of the COO helper; K11f against the P1 drift element
    vol (w . g_i) / k."""
    sub, op = case(mesh, tag)
    rng = np.random.default_rng(tag)
    kap = rng.uniform(1.0, 2.0, sub.n_dofs)
    w = rng.standard_normal((sub.n_cells, sub.grads.shape[-1]))
    wv = sub.vols * kap[sub.cells].mean(axis=1)
    V = P.emi_fill(op, f64(sub.grads), f64(wv))
    r, c, Ke = D._stiffness_coo(sub.cells, sub.grads, sub.vols, coef_vertex=kap)
    close_matrix(op.scipy_csr(V), csr(r, c, Ke, op.n))
    k = sub.cells.shape[1]
    De = np.repeat((sub.vols[:, None] * np.einsum("cd,ckd->ck", w, sub.grads) / k)[:, :, None],
                   k, axis=2)
    Dr = P.drift_fill(op, f64(sub.grads), f64(sub.vols), f64(w))
    close_matrix(op.scipy_csr(Dr), csr(r, c, De, op.n))


@pytest.mark.parametrize("mesh,tag", CASES)
def test_plain_apply_equals_the_csr_product(mesh, tag):
    sub, op = case(mesh, tag)
    rng = np.random.default_rng(10 + tag)
    V1, V2 = (f64(rng.standard_normal(op.slots)) for _ in range(2))
    pad = torch.ones(op.slots, dtype=torch.bool)
    pad[op.csr_slots()] = False
    V1[pad], V2[pad] = 0.0, 0.0  # what the pattern's padding holds
    # a nearly uniform x, as the fields are: the row-sum form keeps it exact
    x = 100.0 + 1e-3 * rng.standard_normal(op.n)
    A1, A2 = op.scipy_csr(V1), op.scipy_csr(V2)
    for y, y_ref in ((P.emi_stiffness(f64(x), op, V1, -0.5), -0.5 * (A1 @ x)),
                     (P.knp_apply(f64(x), op, V1, V2, 3.0), A1 @ x + 3.0 * (A2 @ x))):
        np.testing.assert_allclose(y.numpy(), y_ref, rtol=0, atol=TOL * np.abs(y_ref).max())


def test_wrappers_take_plain_path_on_cpu_and_check_inputs():
    sub, op = case("2d_res1", 0)
    ops.reset_launch_counts()
    x = torch.ones(op.n)
    grads, vols = torch.as_tensor(sub.grads, dtype=torch.float32), \
        torch.as_tensor(sub.vols, dtype=torch.float32)
    V = P.emi_fill(op, grads, vols)
    Dr = P.drift_fill(op, grads, vols, torch.zeros(sub.n_cells, 2))
    P.emi_stiffness(x, op, V), P.knp_apply(x, op, V, Dr, 1.0)
    assert all(v == 0 for v in ops.launch_counts().values())
    with pytest.raises(ValueError):
        P.emi_stiffness(x[:-1], op, V)
    with pytest.raises(ValueError):
        P.emi_stiffness(x, op, torch.stack([V, V]).T)
    with pytest.raises(TypeError):
        P.knp_apply(x, op, V, Dr.double(), 1.0)
    with pytest.raises(ValueError):
        P.drift_fill(op, grads, vols, torch.zeros(sub.n_cells, 3))
    with pytest.raises(TypeError):
        P.emi_fill(op, grads.long(), vols)


def test_simulation_shares_one_operator_per_subdomain():
    """EMISystem and KNPSystem hold the same P1Operator of each subdomain;
    the batched KNP branch never assembles the per-ion values."""
    from knpemi_tpu_torch.sim import build_idealized

    sim = build_idealized(dim=2, resolution=1, dtype=torch.float64, device="cpu")
    for t in sim.geom.sub_tags:
        assert sim.emi_sys.sub[t]["op"] is sim.knp_sys.sub[t]["op"]
        assert sim.knp_sys.sub[t]["cells"] is sim.knp_sys.sub[t]["op"].cells
    sim.run(sim.init_state(), 1)
    assert sim.knp_solver.batched and not sim.knp_sys.ion_vals


@pytest.mark.parametrize("mesh,tag", CASES)
def test_stiffness_maps_a_constant_to_zero_in_float32(mesh, tag):
    """The zero row sums survive float32 rounding exactly: a resting
    potential is no source of residual noise."""
    sub, op = case(mesh, tag)
    Kst = op.assemble(D._stiffness_coo(sub.cells, sub.grads, sub.vols)[2])[0]
    y = P.emi_stiffness(torch.full((op.n,), -70.0), op, torch.as_tensor(Kst, dtype=torch.float32))
    assert torch.equal(y, torch.zeros_like(y))
