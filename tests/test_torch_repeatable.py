"""What makes a step, and a build, give the same bits every time.

The far remainder of a block-banded multigrid operator:
``solvers/mg.py::_banded_mv`` adds the entries a banded layout's windows
do not cover.  The JAX package adds them by a scatter
(``y.at[far_rows].add``); the port keeps them as a CSR by row
(``ops/ell.py::far_csr``, built once at upload, refilled in place by a
hierarchy refresh) and adds each row's sum in a fixed order
(``ell.csr_add``, K5/K6b's kernel on the card, ``csr_add_plain`` here),
so that a banded step gives the same bits every time.  Held here:

* the plain row sum against ``index_add_`` in float64 (1e-13 relative)
  on every banded layout of the 2-D res-1 EMI hierarchy, all their
  entries taken as far entries in a shuffled order with padding, and on
  the true far list of the 3-D res-1 EMI hierarchy;
* the plain twin against a scalar loop that adds each row's entries in
  their stored order (float64, 1e-13), and the row form keeping a row's
  entries in their listed order;
* a refresh whose far list shrinks (padding) or grows (the smallest
  dropped) rebuilds the row form in the tensors it had.

And the ECS source's load vector, summed on the host in float64 and
cast, so that two builds of the tissue scenario hold the same bits.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from knpemi_tpu_torch.ops import ell as TE
from knpemi_tpu_torch.sim import SolverOptions, build_idealized
from knpemi_tpu_torch.solvers import mg as tmg

from test_torch_mg_banded import tridiag_far

ROLES = ("a", "ap", "p", "pt")


def band_coo(band):
    """(rows, cols, vals) of every entry of a host banded layout: the
    windows' slab nonzeros, then the far list."""
    windows, fr, fc, fv, n, m = band
    rows, cols, vals = [], [], []
    for slabT, w0, W in windows:
        R = slabT.shape[1]
        i, r = np.nonzero(slabT)
        blk, w = i // W, i % W
        rows.append(blk * R + r)
        cols.append(w0[blk].astype(np.int64) + w)
        vals.append(slabT[i, r])
    rows.append(fr)
    cols.append(fc)
    vals.append(fv)
    return (np.concatenate(rows).astype(np.int64), np.concatenate(cols).astype(np.int64),
            np.concatenate(vals).astype(np.float64))


def _host_bands(hier):
    return [(f"level {i} {w}", getattr(lv, w + "_band"))
            for i, lv in enumerate(hier.levels) for w in ROLES
            if getattr(lv, w + "_band") is not None]


@pytest.fixture(scope="module")
def sim2():
    return build_idealized(dim=2, resolution=1, dtype=torch.float64, device="cpu",
                           solver_options=SolverOptions(mg_banded=True, mg_coarse_max=100))


@pytest.fixture(scope="module")
def sim3():
    return build_idealized(dim=3, resolution=1, dtype=torch.float64, device="cpu",
                           solver_options=SolverOptions(mg_banded=True))


def _index_add(rows, cols, vals, X, n):
    Y = torch.zeros(X.shape[0], n, dtype=X.dtype)
    return Y.index_add_(1, torch.as_tensor(rows), torch.as_tensor(vals) * X[:, cols])


@pytest.mark.parametrize("B", [1, 3])
def test_row_sum_matches_index_add_on_every_banded_layout_2d(sim2, B):
    bands = _host_bands(sim2._emi_hier)
    assert len(bands) >= 4
    rng = np.random.default_rng(7)
    for what, band in bands:
        n, m = band[4], band[5]
        rows, cols, vals = band_coo(band)
        perm = rng.permutation(len(rows))
        pad = 5  # a refill's padding: row 0, column 0, value 0
        rows = np.concatenate([rows[perm], np.zeros(pad, np.int64)])
        cols = np.concatenate([cols[perm], np.zeros(pad, np.int64)])
        vals = np.concatenate([vals[perm], np.zeros(pad)])
        f = TE.device_far(rows, cols, vals, n, m, torch.float64, "cpu")
        assert int(f.row_ptr[-1]) == len(rows) - pad and f.col.shape[0] == len(rows)
        X = torch.as_tensor(rng.standard_normal((B, m)))
        Y0 = torch.as_tensor(rng.standard_normal((B, n)))
        got = TE.csr_add(f, X if B > 1 else X[0], (Y0 if B > 1 else Y0[0]).clone())
        want = Y0 + _index_add(rows, cols, vals, X, n)
        np.testing.assert_allclose(got.reshape(B, n).numpy(), want.numpy(), rtol=1e-13,
                                   atol=1e-13 * float(want.abs().max()), err_msg=what)


def test_row_sum_matches_index_add_on_the_far_lists_3d(sim3):
    """The far lists the 3-D res-1 EMI hierarchy really has, through the
    cycle's own apply (``_banded_mv``), against scipy of the layout."""
    rng = np.random.default_rng(3)
    seen = 0
    for what, band in _host_bands(sim3._emi_hier):
        if len(band[1]) == 0:
            continue
        seen += 1
        i, w = int(what.split()[1]), what.split()[2]
        dev = sim3.emi_solver.mg.levels[i][w + "_band"]
        assert dev["far"] is not None
        rows, cols, vals = band_coo(band)
        A = sp.csr_matrix((vals, (rows, cols)), shape=(band[4], band[5]))
        X = rng.standard_normal((2, band[5]))
        for batch in (False, True):
            x = torch.as_tensor(X if batch else X[0])
            y = tmg._banded_mv(dev, x, batch).reshape(-1, band[4]).numpy()
            want = (A @ X.T).T[: y.shape[0]]
            np.testing.assert_allclose(y, want, rtol=1e-13,
                                       atol=1e-13 * np.abs(want).max(), err_msg=what)
        # the far part alone against index_add_
        fr, fc, fv = band[1:4]
        f = dev["far"]
        Xt = torch.as_tensor(X)
        got = TE.csr_add(f, Xt, torch.zeros(2, band[4], dtype=torch.float64))
        want = _index_add(fr.astype(np.int64), fc.astype(np.int64), fv, Xt, band[4])
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-13,
                                   atol=1e-13 * float(want.abs().max()))
    assert seen >= 1


def _row_loop(ptr, col, val, x, y):
    """Y += F x, each row's entries in their stored order, scalar by scalar."""
    y = y.copy()
    for r in range(len(ptr) - 1):
        for s in range(int(ptr[r]), int(ptr[r + 1])):
            y[r] += val[s] * x[col[s]]
    return y


@pytest.mark.parametrize("G", [4, 8, 32])
def test_plain_twin_adds_each_row_in_its_stored_order(G):
    rng = np.random.default_rng(G)
    n, m = 60, 90
    counts = rng.integers(0, 3 * G, n)
    counts[::7] = 0
    rows = np.repeat(np.arange(n), counts)
    cols = rng.integers(0, m, len(rows))
    vals = rng.standard_normal(len(rows))
    perm = rng.permutation(len(rows))
    ptr, col, val = TE.far_csr(rows[perm], cols[perm], vals[perm], n, len(rows) + 3)
    f = TE.DeviceCSR(n, m, torch.as_tensor(ptr), torch.as_tensor(col),
                     torch.as_tensor(val), G)
    x = rng.standard_normal(m)
    y = rng.standard_normal(n)
    got = TE.csr_add(f, torch.as_tensor(x), torch.as_tensor(y.copy())).numpy()
    want = _row_loop(ptr, col, val, x, y)
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13 * np.abs(want).max())
    # rows keep their listed order: a stable sort by row
    for r in range(n):
        idx = np.flatnonzero(rows[perm] == r)
        np.testing.assert_array_equal(col[ptr[r]:ptr[r + 1]], cols[perm][idx])


def test_far_csr_refuses_more_entries_than_its_capacity():
    with pytest.raises(ValueError):
        TE.far_csr(np.array([0, 1]), np.array([0, 0]), np.array([1.0, 2.0]), 2, 1)


@pytest.fixture(scope="module")
def far_hierarchy():
    A = tridiag_far()
    hier = tmg.build_hierarchy(A, B=np.ones(A.shape[0]), theta=0.04, coarse_max=100,
                               banded=True)
    band = hier.levels[0].a_band
    assert band is not None and len(band[1]) > 0
    return A, hier


@pytest.mark.parametrize("change", ["fewer far entries: padded",
                                    "more far entries: the smallest dropped"])
def test_refresh_rebuilds_the_row_form_in_place(far_hierarchy, change):
    A, hier = far_hierarchy
    dmg = hier.device(torch.float64, "cpu")
    far = dmg.levels[0]["a_band"]["far"]
    cap = far.col.shape[0]
    ptrs = [t.data_ptr() for t in dmg.tensors()]
    _, fr, fc, fv, n, _ = hier.levels[0].a_band
    if change.startswith("fewer"):
        # four far pairs vanish
        keep = np.ones(len(fr), bool)
        keep[:4] = False
        drop = sp.csr_matrix((fv[~keep], (fr[~keep], fc[~keep])), shape=A.shape)
        A2 = (A - drop).tocsr()
        A2.eliminate_zeros()
    else:
        # three tiny entries appear far from the diagonal
        rows = np.array([10, 1500, 2900])
        cols = np.array([2500, 20, 400])
        A2 = (A + sp.csr_matrix((np.full(3, 1e-12), (rows, cols)), shape=A.shape)).tocsr()
    hier2 = tmg.refresh_hierarchy(hier, A2)
    band2 = hier2.levels[0].a_band
    assert len(band2[1]) == cap
    n_nz = int((band2[3] != 0).sum())
    if change.startswith("fewer"):
        assert n_nz == cap - 4
    else:
        assert n_nz == cap and not (np.abs(band2[3]) == 1e-12).any()
    pairs, _ = dmg.refill_arrays(hier2)
    dmg.install(pairs)
    assert [t.data_ptr() for t in dmg.tensors()] == ptrs
    ptr, col, val = TE.far_csr(*band2[1:4], n, cap)
    np.testing.assert_array_equal(far.row_ptr.numpy(), ptr)
    np.testing.assert_array_equal(far.col.numpy(), col)
    np.testing.assert_array_equal(far.val.numpy(), val)
    assert int(far.row_ptr[-1]) == n_nz
    # the cycle's apply is the refreshed layout
    rows, cols, vals = band_coo(band2)
    A_layout = sp.csr_matrix((vals, (rows, cols)), shape=A.shape)
    x = np.random.default_rng(1).standard_normal(A.shape[1])
    y = tmg._banded_mv(dmg.levels[0]["a_band"], torch.as_tensor(x), False).numpy()
    want = A_layout @ x
    np.testing.assert_allclose(y, want, rtol=1e-13, atol=1e-13 * np.abs(want).max())


def test_source_vector_is_the_float64_host_sum_cast():
    """The ECS source's load vector of a float32 build: the float64 host
    sum rounded once (a scatter on the card adds with atomics in a
    varying order; the host sum is the same every build)."""
    from knpemi_tpu_torch.sim import ASTROCYTE_BASELINE, build_astrocyte

    cfg = {**ASTROCYTE_BASELINE, "mesh_n": 8}
    v32 = build_astrocyte(cfg, dtype=torch.float32, device="cpu").knp_sys._src_vec
    v64 = build_astrocyte(cfg, dtype=torch.float64, device="cpu").knp_sys._src_vec
    assert sorted(t for t, v in v32.items() if v is not None) == [0]
    assert v32[0].dtype == torch.float32 and v32[0].abs().max() > 0
    assert torch.equal(v32[0], v64[0].to(torch.float32))
