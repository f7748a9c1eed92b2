"""The membrane's P1 operator (``knpemi_tpu_torch/ops/p1op.py::
membrane_operators``) and the two kernels built on it, K2 (the surface
mass M_Gamma as the operator's apply) and K10 (the facet scatter as a
row walk of its incidence list), on the CPU.

On the membrane of the idealized 2-D res-1 mesh (edges, k = 2), of the
3-D res-1 mesh (triangles, k = 3) and on both membranes of the astrocyte
tissue mesh at ``mesh_n=10``:

* the pattern and M_Gamma's values (``p1op.mass_values`` of the facets
  and their areas) equal the scipy CSR of ``solvers/direct.py``'s
  ``_facet_mass_coo`` to 1e-13 of max|M| in float64;
* the incidence list holds every (facet, vertex) slot exactly once, in
  the row of that vertex, facets ascending along a row;
* the plain K2 and K10 equal the JAX package's ``facet_mass_blocked`` and
  ``facet_scatter_blocked`` (Pallas, interpret mode) in float32 at 5e-6
  of max|y| (the JAX kernels gather through bf16 split passes), and its
  XLA path (``facet_mass_values`` / ``scatter_add``) in float64 at 1e-13;
  K10's plain version sums in the list's order and gives the bits of a
  facet-ordered ``index_add_``.

Also: ``P1Operator`` needs no geometry and refuses a membrane with a dof
in no facet; ``Simulation`` builds one operator per membrane, times it,
hands the same object to ``EMISystem`` and ``KNPSystem``, and an EMI
hierarchy refresh leaves it in place; K10 checks V's shape and the
list's dtype.  Inputs are made from a seed with numpy.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from knpemi_tpu.mesh import idealized_2d_mesh, idealized_3d_mesh
from knpemi_tpu.mesh import tissue as jtissue
from knpemi_tpu.ops import kernels as JK
from knpemi_tpu.ops import pallas_assembly as PA
from knpemi_tpu.ops.geometry import build_geometry

from knpemi_tpu_torch.ops import assembly as A
from knpemi_tpu_torch.ops import p1op as P
from knpemi_tpu_torch.solvers import direct as D

MESHES = {
    "2d_res1": lambda: idealized_2d_mesh(1),
    "3d_res1": lambda: idealized_3d_mesh(1),
    "tissue10": lambda: jtissue.astrocyte_tissue_mesh(n=10),
}
MEMBRANES = {"2d_res1": (1,), "3d_res1": (1,), "tissue10": (1, 2)}
CASES = [(m, t) for m in MESHES for t in MEMBRANES[m]]
TOL64 = 1e-13
TOL32 = 5e-6

_GEOMS, _OPS = {}, {}


def geometry(mesh):
    if mesh not in _GEOMS:
        _GEOMS[mesh] = build_geometry(MESHES[mesh]())
    return _GEOMS[mesh]


def case(mesh, tag):
    """(membrane space, its operator from ``membrane_operators`` on the
    CPU), built once per module."""
    if mesh not in _OPS:
        _OPS[mesh] = P.membrane_operators(geometry(mesh), "cpu")
    return geometry(mesh).membranes[tag], _OPS[mesh][tag]


def t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def close(y, y_ref, tol):
    y, y_ref = np.asarray(y, np.float64), np.asarray(y_ref, np.float64)
    scale = np.abs(y_ref).max()
    assert scale > 0
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=tol * scale)


def blocked(V, sp, bkm):
    """(F, nf, k) per-slot values in the JAX facet blocking's layout."""
    lookup = {tuple(r): i for i, r in enumerate(np.asarray(sp.facet_dofs))}
    real = np.asarray(bkm.vols_lane)[:, :, 0, : bkm.C] != 0
    b, h, c = np.nonzero(real)
    f = np.array([lookup[tuple(r)] for r in bkm.cells_chunk[b, h, c]])
    # every facet in exactly one lane
    np.testing.assert_array_equal(np.sort(f), np.arange(sp.n_facets))
    Vb = np.zeros((bkm.n_blocks, bkm.n_chunks, V.shape[0], bkm.k * bkm.C))
    for j in range(bkm.k):
        Vb[b, h, :, j * bkm.C + c] = V[:, f, j].T
    return Vb


def test_operator_takes_facets_and_refuses_a_dof_in_no_facet():
    """k = 2 and k = 3 facets, no geometry; a membrane numbering with a dof
    no facet touches is refused as a subdomain's would be."""
    for mesh, k in (("2d_res1", 2), ("3d_res1", 3)):
        sp, op = case(mesh, 1)
        assert (op.k, op.n) == (k, sp.n_dofs) and op.cells.shape == (sp.n_facets, k)
    sp, _ = case("2d_res1", 1)
    with pytest.raises(ValueError, match="no cell"):
        P.P1Operator(sp.facet_dofs, sp.n_dofs + 1, "cpu")


@pytest.mark.parametrize("mesh,tag", CASES)
def test_surface_mass_equals_the_facet_mass_csr_f64(mesh, tag):
    sp, op = case(mesh, tag)
    M = P.mass_values(op, sp.facet_dofs, sp.areas, torch.float64)
    ref = D._coo_accumulate(*[[a] for a in D._facet_mass_coo(
        sp.facet_dofs, sp.facet_dofs, sp.areas)], sp.n_dofs).tocsr()
    got = op.scipy_csr(M)
    # the pattern: the graph of M_Gamma, columns ascending
    ref.sort_indices()
    np.testing.assert_array_equal(got.indptr, ref.indptr)
    np.testing.assert_array_equal(got.indices, ref.indices)
    assert abs(got - ref).max() <= TOL64 * abs(ref).max()
    x = np.random.default_rng(tag).standard_normal(sp.n_dofs)
    close(P.surface_mass(t(x), op, M, 2.5), 2.5 * (ref @ x), TOL64)


@pytest.mark.parametrize("mesh,tag", CASES)
def test_incidence_list_holds_every_facet_slot_once(mesh, tag):
    sp, op = case(mesh, tag)
    nf, k = sp.facet_dofs.shape
    inc_ptr, inc = op.inc_ptr.numpy().astype(np.int64), op.inc.numpy()
    s = np.repeat(np.arange(inc_ptr.shape[0] - 1), np.diff(inc_ptr))
    q = np.arange(inc.shape[0]) - inc_ptr[s]
    row, e = 32 * s + q % 32, q // 32
    real = inc >= 0
    assert np.all(inc[~real] == -1)
    f, j = inc[real] >> 2, inc[real] & 3
    np.testing.assert_array_equal(np.sort(f * k + j), np.arange(nf * k))
    np.testing.assert_array_equal(sp.facet_dofs[f, j], row[real])
    order = np.lexsort((e[real], row[real]))
    same_row = np.diff(row[real][order]) == 0
    assert np.all(np.diff(f[order])[same_row] > 0)


@pytest.mark.parametrize("mesh,tag", CASES)
def test_k2_and_k10_vs_pallas_f32(mesh, tag):
    f32 = torch.float32
    sp, op = case(mesh, tag)
    rng = np.random.default_rng(20 + tag)
    kf = sp.facet_dofs.shape[1]
    bkm = PA.build_facet_blocking(sp.facet_dofs, sp.areas, sp.n_dofs)
    x = rng.standard_normal(sp.n_dofs)
    y_jax = PA.facet_mass_blocked(jnp.asarray(x, jnp.float32), bkm,
                                  jnp.asarray(bkm.vols_lane / (kf * (kf + 1)), jnp.float32),
                                  interpret=True)
    M = P.mass_values(op, sp.facet_dofs, sp.areas, f32)
    close(P.surface_mass_plain(t(x, f32), op, M), y_jax, TOL32)
    V = rng.standard_normal((4, sp.n_facets, kf))
    Y_jax = PA.facet_scatter_blocked(jnp.asarray(blocked(V, sp, bkm), jnp.float32), bkm,
                                     interpret=True)
    close(A.facet_scatter_plain(t(V, f32), op), Y_jax, TOL32)


@pytest.mark.parametrize("mesh,tag", CASES)
def test_k2_and_k10_vs_xla_f64(mesh, tag):
    sp, op = case(mesh, tag)
    rng = np.random.default_rng(30 + tag)
    fd = jnp.asarray(sp.facet_dofs)
    x = rng.standard_normal(sp.n_dofs)
    M = P.mass_values(op, sp.facet_dofs, sp.areas, torch.float64)
    y_ref = JK.scatter_add(sp.n_dofs, fd, JK.facet_mass_values(jnp.asarray(x)[fd],
                                                               jnp.asarray(sp.areas)))
    close(P.surface_mass_plain(t(x), op, M), y_ref, TOL64)
    V = rng.standard_normal((3, sp.n_facets, sp.facet_dofs.shape[1]))
    Y = A.facet_scatter_plain(t(V), op)
    for c in range(3):
        close(Y[c], JK.scatter_add(sp.n_dofs, fd, jnp.asarray(V[c])), TOL64)
    # the list's order (facets ascending in each row) is a facet-ordered scatter
    flat = torch.as_tensor(sp.facet_dofs.reshape(-1), dtype=torch.int64)
    assert torch.equal(Y, torch.zeros(3, sp.n_dofs, dtype=torch.float64).index_add_(
        1, flat, t(V).reshape(3, -1)))


def test_k10_checks_its_inputs():
    import copy

    sp, op = case("3d_res1", 1)
    V = torch.zeros(2, sp.n_facets, 3)
    assert A.facet_scatter(V, op).shape == (2, sp.n_dofs)
    with pytest.raises(ValueError):
        A.facet_scatter(torch.zeros(2, sp.n_facets, 2), op)
    with pytest.raises(ValueError):
        A.facet_scatter(V[:, :-1], op)
    bad = copy.copy(op)
    bad.inc = op.inc.long()
    with pytest.raises(TypeError):
        A.facet_scatter(V, bad)


def test_simulation_shares_one_operator_per_membrane():
    """Built once, timed as its own setup parts, the same object in both
    systems, untouched by an EMI hierarchy refresh."""
    from knpemi_tpu_torch.sim import ASTROCYTE_BASELINE, build_astrocyte

    sim = build_astrocyte({**ASTROCYTE_BASELINE, "mesh_n": 10}, dtype=torch.float64,
                          device="cpu")
    assert sorted(sim.emi_sys.mem) == [1, 2]
    assert {"membrane_operators", "membrane_incidence"} <= set(sim.setup_seconds)
    ops = {}
    for m, mb in sim.emi_sys.mem.items():
        op = mb["op"]
        assert sim.knp_sys.mem[m]["op"] is op and op.n == mb["n_mem"]
        assert mb["M"].shape == (op.slots,) and mb["M"].dtype == torch.float64
        ops[m] = (op, op.inc.data_ptr(), op.inc.clone(), mb["M"].clone())
    state, *_ = sim.run(sim.init_state(), 1)
    sim.refresh_mg(state)
    assert sim.refresh_counts["installed"] == 1
    for m, (op, ptr, inc, M) in ops.items():
        assert sim.emi_sys.mem[m]["op"] is op and op.inc.data_ptr() == ptr
        assert torch.equal(op.inc, inc) and torch.equal(sim.emi_sys.mem[m]["M"], M)
