"""K4 on the sliced form, in every single-vector apply of the port.

All on the CPU, at small sizes, inputs made from a seed with numpy.  K4
(``knpemi_tpu_torch/ops/ell.py::ellw_matvec``) reads one device form for
every operator it applies, the 32-row sliced ELL of ``sliced_ell``: the
multigrid level operators A, prolongators P and products A P of a
single-vector V-cycle, and the step's frozen dof -> cell coefficient
maps (``cell_mean_ell``, ``cell_gradient_ell``).  Its plain version
(what the wrapper runs on CPU tensors) is held

(a) on each A / P / AP windowed-ELL layout of a small banded hierarchy
    (banding refused, as in ``test_torch_restrict.py``), against the JAX
    Pallas wrapper ``ellw_matvec(interpret=True)`` on the JAX package's
    layout of the same matrix in float32, at 1e-5 max|y| (the JAX kernel
    gathers through bf16 split passes), and against its XLA path in
    float64, at 1e-14 max|y|;
(b) on both coefficient maps of the 2-D and 3-D test meshes against
    ``ellw_matvec`` on ``build_interp_ellw``'s layouts, with the same
    tolerances;
(c) on ragged slices (a row count that is not a multiple of 32, empty
    rows, a slice of width 0) against scipy in float64;
(d) in the single-vector V-cycle against JAX's in float64, 1e-13 of
    max|y|;
(e) across a refresh of a single-vector hierarchy: a refreshed nonzero
    without a slot in its frozen slice is dropped and counted, every
    tensor kept in place, when it is small; a large one is refused.

The kernel itself (``csrc/mg.cu``) is held against this plain version
on the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

from knpemi_tpu.ops import pallas_assembly as PA
from knpemi_tpu.ops import pallas_ell as JE
from knpemi_tpu.solvers import mg as jmg

from knpemi_tpu_torch import ops
from knpemi_tpu_torch.ops import ell as TE
from knpemi_tpu_torch.solvers import mg as tmg

from test_torch_kernels import MESHES, geometry, lanes
from test_torch_mg_banded import spd_banded

TOL32 = 1e-5
TOL64 = 1e-14
ROLES = ("a", "p", "ap")


def close(y, y_ref, tol):
    y, y_ref = np.asarray(y, np.float64), np.asarray(y_ref, np.float64)
    scale = np.abs(y_ref).max()
    assert scale > 0 and y.shape == y_ref.shape
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=tol * scale)


@pytest.fixture(scope="module")
def hierarchies():
    """JAX's and the port's windowed-ELL hierarchy of one SPD banded
    matrix (banding refused in both), and the port's upload of it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmg, "_csr_to_banded", lambda *a, **k: None)
        mp.setattr(tmg, "_csr_to_banded", lambda *a, **k: None)
        A = spd_banded()
        hj = jmg.build_hierarchy(A, coarse_max=80, banded=True, smoother="jacobi")
        ht = tmg.build_hierarchy(A, coarse_max=80, banded=True)
    return A, hj, ht


def _layouts(hj, ht, role):
    out = [(i, getattr(lj, role + "_ellw"), getattr(lt, role + "_ellw"))
           for i, (lj, lt) in enumerate(zip(hj.levels, ht.levels))]
    out = [(i, ej, et) for i, ej, et in out if et is not None]
    assert out and all(ej is not None for _, ej, _ in out)
    return out


# ---------------------------------------------------------------------------
# (a) the V-cycle's layouts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("role", ROLES)
def test_k4_plain_f32_vs_pallas_interpret_on_hierarchy_layouts(hierarchies, role):
    _, hj, ht = hierarchies
    for i, ej, et in _layouts(hj, ht, role):
        x = np.random.default_rng(i).standard_normal(et.n_cols).astype(np.float32)
        e = et.device(torch.float32, "cpu", sliced=True)
        assert e.trow_ptr is None and e.scol.dtype == torch.int64
        y = TE.ellw_matvec(e, torch.as_tensor(x))
        y_jax = JE.ellw_matvec(ej.device(jnp.float32), jnp.asarray(x, jnp.float32), True)
        close(y, y_jax, TOL32)


@pytest.mark.parametrize("role", ROLES)
def test_k4_plain_f64_vs_xla_on_hierarchy_layouts(hierarchies, role):
    _, hj, ht = hierarchies
    for i, ej, et in _layouts(hj, ht, role):
        x = np.random.default_rng(10 + i).standard_normal(et.n_cols)
        y = TE.ellw_matvec(et.device(torch.float64, "cpu", sliced=True), torch.as_tensor(x))
        y_xla = JE.ellw_matvec(ej.device(jnp.float64), jnp.asarray(x, jnp.float64))
        close(y, y_xla, TOL64)


@pytest.mark.parametrize("role", ROLES)
def test_sliced_form_reads_fewer_slots_than_the_padded_ell(hierarchies, role):
    """The sliced form of a layout holds its nonzeros (far entries folded
    in) in at most the slots of the (n_rows, K) ELL that K was rounded
    up for, and is exactly the layout's matrix."""
    _, _, ht = hierarchies
    for _, _, et in _layouts(ht, ht, role):
        cols, vals = et.to_ell()
        e = et.device(torch.float64, "cpu", sliced=True)
        assert e.nnz == int((vals != 0).sum()) <= e.scol.numel() <= et.n_rows * et.K
        x = np.random.default_rng(3).standard_normal(et.n_cols)
        rows = np.repeat(np.arange(et.n_rows), et.K)
        M = sp.csr_matrix((vals.ravel(), (rows, cols.ravel())), shape=(et.n_rows, et.n_cols))
        close(TE.ellw_matvec(e, torch.as_tensor(x)), M @ x, TOL64)


# ---------------------------------------------------------------------------
# (b) the coefficient maps
# ---------------------------------------------------------------------------
def _maps(mesh, tag):
    """(port map, JAX layout, lanes -> cells) of both coefficient maps of
    subdomain ``tag`` of ``mesh``, as ``test_torch_kernels.py`` builds the
    JAX side."""
    geom = geometry(mesh)
    sub = geom.subdomains[tag]
    bk = PA.build_blocking(sub.cells, sub.grads, sub.vols, sub.n_dofs)
    b, h, c, cell = lanes(bk, sub.cells)
    k_c = bk.k
    pad = (bk.vols_lane[:, :, 0, : bk.C] != 0)[:, :, None, None, :]
    kbar_j = PA.build_interp_ellw(bk, np.broadcast_to(
        pad / k_c, (bk.n_blocks, bk.n_chunks, 1, k_c, bk.C)))
    grad_j = PA.build_interp_ellw(bk, bk.grads_lane.reshape(
        bk.n_blocks, bk.n_chunks, bk.dim, bk.k, bk.C))
    unlane_k = lambda y: np.asarray(y).reshape(bk.n_blocks, bk.n_chunks, bk.C)[b, h, c]
    unlane_g = lambda y: np.asarray(y).reshape(
        bk.n_blocks, bk.n_chunks, bk.dim, bk.C)[b, h, :, c]
    return sub, [
        (lambda dt: TE.cell_mean_ell(sub.cells, sub.n_dofs, dt, "cpu"), kbar_j, unlane_k,
         lambda y: np.asarray(y)[cell]),
        (lambda dt: TE.cell_gradient_ell(sub.cells, sub.grads, sub.n_dofs, dt, "cpu"),
         grad_j, unlane_g, lambda y: np.asarray(y).reshape(sub.n_cells, -1)[cell]),
    ]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_k4_coefficient_maps_vs_jax(mesh, dtype):
    """Mean-vertex kappa and grad(phi) per cell: float32 against the Pallas
    kernel in interpret mode, float64 against its XLA path."""
    tdt, jdt, tol = ((torch.float32, jnp.float32, TOL32) if dtype == "float32"
                     else (torch.float64, jnp.float64, TOL64))
    for tag in geometry(mesh).subdomains:
        sub, maps = _maps(mesh, tag)
        x = np.random.default_rng(30 + tag).standard_normal(sub.n_dofs)
        for make, ej, unlane, to_cells in maps:
            m = make(tdt)
            assert m.sval.dtype == tdt and m.slot_ptr.dtype == torch.int32
            y = TE.ellw_matvec(m, torch.as_tensor(x, dtype=tdt))
            y_j = JE.ellw_matvec(ej.device(jdt), jnp.asarray(x, jdt), True)
            close(to_cells(y), unlane(y_j), tol)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_coefficient_maps_store_their_rows_in_32_row_slices(mesh):
    """Each map row holds the cell's nonzero weights (k for the mean, up
    to k for a gradient component), every slice as wide as its longest
    row: at most k slots a row."""
    geom = geometry(mesh)
    sub = geom.subdomains[0]
    k = sub.cells.shape[1]
    for m, rows in ((TE.cell_mean_ell(sub.cells, sub.n_dofs, torch.float64, "cpu"),
                     sub.n_cells),
                    (TE.cell_gradient_ell(sub.cells, sub.grads, sub.n_dofs, torch.float64,
                                          "cpu"), sub.n_cells * geom.dim)):
        assert m.n_rows == rows and m.n_cols == sub.n_dofs and m.K <= k
        width = np.diff(m.slot_ptr.numpy()) // TE.SLICE
        assert width.max() <= k and m.scol.numel() == TE.SLICE * width.sum()
        count = torch.bincount(TE._sliced_rows(m)[m.sval != 0],
                               minlength=len(width) * TE.SLICE)
        assert np.array_equal(width, count.reshape(-1, TE.SLICE).amax(1).numpy())


# ---------------------------------------------------------------------------
# (c) ragged slices
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_rows", [1, 31, 70, 97])
def test_k4_plain_on_ragged_slices_vs_scipy(n_rows):
    """A row count that is not a multiple of 32, empty rows, and (from 64
    rows) a whole slice of empty rows, whose width is 0."""
    rng = np.random.default_rng(n_rows)
    n_cols = 50
    M = sp.random(n_rows, n_cols, density=0.15, random_state=n_rows, format="lil")
    M[n_rows // 2, :] = 0.0
    if n_rows >= 64:
        M[32:64, :] = 0.0
    M = M.tocsr()
    M.eliminate_zeros()
    nnz = np.diff(M.indptr)
    K = max(int(nnz.max()), 1)
    cols = np.zeros((n_rows, K), np.int32)
    vals = np.zeros((n_rows, K))
    r = np.repeat(np.arange(n_rows), nnz)
    pos = np.arange(M.nnz) - np.repeat(M.indptr[:-1], nnz)
    cols[r, pos], vals[r, pos] = M.indices, M.data
    e = TE._upload_sliced(TE.DeviceELLW(n_rows, n_cols, K=K), cols, vals, torch.float64,
                          "cpu")
    width = np.diff(e.slot_ptr_host) // TE.SLICE
    if n_rows >= 64:
        assert width[1] == 0
    x = rng.standard_normal(n_cols)
    y = TE.ellw_matvec(e, torch.as_tensor(x))
    np.testing.assert_allclose(y.numpy(), M @ x, rtol=0, atol=1e-14 * max(1.0, abs(M @ x).max()))
    assert float(y[n_rows // 2]) == 0.0


# ---------------------------------------------------------------------------
# (d) the single-vector V-cycle
# ---------------------------------------------------------------------------
def test_single_vector_vcycle_f64_vs_jax(hierarchies):
    A, hj, ht = hierarchies
    dj, dt = hj.device(jnp.float64), ht.device(torch.float64, "cpu")
    assert all(lv[w] == "ellw" for lv in dt.layout() for w in ("A", "P", "Pt"))
    ops.reset_launch_counts()
    ident = lambda v: v  # unused: level 0 stores its operator
    for seed in range(2):
        r = np.random.default_rng(40 + seed).standard_normal(A.shape[0])
        yj = np.asarray(dj.apply(ident, jnp.asarray(r)))
        close(dt.apply(ident, torch.as_tensor(r)).numpy(), yj, 1e-13)
    assert all(v == 0 for v in ops.launch_counts().values())  # CPU: the plain path


# ---------------------------------------------------------------------------
# (e) a refresh that finds no slot for a new nonzero
# ---------------------------------------------------------------------------
def _drift(A, ht, dev):
    """A symmetric pair (r, c), (c, r) absent from A, with r a row of level
    0 whose slice of the sliced A is full, that the host refresh takes at
    a tiny and at a large value (windows, K and far capacity hold), so
    that only the sliced form has no slot for it; searched in a fixed
    order."""
    cols, vals = ht.levels[0].a_ellw.to_ell()
    e = dev.levels[0]["a_ellw"]
    hold = np.repeat(np.diff(e.slot_ptr_host) // TE.SLICE, TE.SLICE)[: e.n_rows]
    for r in np.flatnonzero((vals != 0).sum(axis=1) == hold):
        have = set(A.indices[A.indptr[r]: A.indptr[r + 1]])
        for r2 in (r + 1, r - 1):
            for c in A.indices[A.indptr[r2]: A.indptr[r2 + 1]]:
                if c in have:
                    continue
                E = lambda v: sp.csr_matrix(([v, v], ([r, c], [c, r])), shape=A.shape)
                try:
                    for v in (1e-9, 1.0):
                        tmg.refresh_hierarchy(ht, (A + E(v)).tocsr())
                except ValueError:
                    continue
                return E
    raise AssertionError("no candidate pair")


def test_sliced_refill_drops_and_counts_a_small_nonzero_in_place(hierarchies):
    A, _, ht = hierarchies
    dev = ht.device(torch.float32, "cpu")
    E = _drift(A, ht, dev)
    ptrs = [t.data_ptr() for t in dev.tensors()]
    shapes = [tuple(t.shape) for t in dev.tensors()]
    new = tmg.refresh_hierarchy(ht, (A + E(1e-9)).tocsr())
    pairs, stats = dev.refill_arrays(new)
    dev.install(pairs)
    assert stats["ellw_dropped"] >= 1 and 0 < stats["ellw_dropped_frac"] <= 1e-5
    assert stats["band_dropped"] == 0
    assert [t.data_ptr() for t in dev.tensors()] == ptrs
    assert [tuple(t.shape) for t in dev.tensors()] == shapes
    # the cycle applies the refreshed hierarchy up to the dropped values
    fresh = new.device(torch.float64, "cpu")
    r = torch.as_tensor(np.random.default_rng(5).standard_normal(A.shape[0]))
    ident = lambda v: v
    close(dev.apply(ident, r.float()).double(), fresh.apply(ident, r), 1e-5)


def test_sliced_refill_refuses_a_large_nonzero_without_a_slot(hierarchies):
    """A row that gains a nonzero its slice has no slot for keeps its
    largest entries: what goes is the row's smallest, here an old entry
    of A, whose share of the |A| mass the guard weighs; above the guard
    the refill raises."""
    A, _, ht = hierarchies
    dev = ht.device(torch.float32, "cpu")
    E = _drift(A, ht, dev)
    new = tmg.refresh_hierarchy(ht, (A + E(1.0)).tocsr())
    lt, et = new.levels[0].a_ellw, dev.levels[0]["a_ellw"]
    cols, vals = lt.to_ell()
    _, dropped, frac = lt.refill_arrays(et, 1.0)
    r = int(np.flatnonzero((vals != 0).sum(axis=1) > np.repeat(
        np.diff(et.slot_ptr_host) // TE.SLICE, TE.SLICE)[: et.n_rows])[0])
    smallest = np.abs(vals[r][vals[r] != 0]).min()
    assert dropped == 1 and smallest < 1.0
    assert frac == pytest.approx(smallest / np.abs(vals).sum(), rel=1e-12)
    with pytest.raises(ValueError, match="sparsity pattern drifted"):
        lt.refill_arrays(et, 0.5 * frac)
    with pytest.raises(ValueError, match="sparsity pattern drifted"):
        dev.refill_arrays(new, max_drop_frac=0.5 * frac)
