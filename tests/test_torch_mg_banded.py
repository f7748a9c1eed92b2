"""The port's block-banded / windowed-ELL multigrid against the JAX package's.

All on the CPU, at small sizes, inputs made from a seed with numpy.

(a) host layouts: ``_csr_to_banded``, ``build_ellw`` and whole
    ``build_hierarchy(banded=True)`` hierarchies of the port equal the JAX
    package's array for array (exact), refusals included;
(b) the plain versions of the five kernel wrappers (what a wrapper runs
    on CPU tensors): in float32 against the JAX Pallas function in
    interpret mode, at 1e-5 max|y| (the JAX kernels gather through bf16
    split passes and both sides sum in their own order); in float64
    against scipy, at 1e-12 max|y|; with far-COO spill, B in {1, 2, 8},
    and a bfloat16 slab for K7/K8;
(c) ``DeviceMG.apply`` / ``apply_batch`` of a ``banded=True`` hierarchy
    against JAX's on the same residuals, as built (all banded) and with
    banding refused in both packages (all windowed ELL): float64, 1e-10
    of max|y|; the fused post-smooth equals the unfused cycle to 1e-10;
(d) the slice: 2 steps of 2-D res 1 in float64 (``mg_coarse_max=100``
    gives the hierarchies real levels), port ``mg_banded=True`` against
    JAX ``use_pallas=False, mg_banded=True``: equal EMI and KNP iteration
    counts, phi_M and every concentration within 1e-9 relative; and
    against the port's ELL path: equal counts.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

from knpemi_tpu.ops import pallas_banded as JB
from knpemi_tpu.ops import pallas_ell as JE
from knpemi_tpu.solvers import mg as jmg

from knpemi_tpu_torch import ops
from knpemi_tpu_torch.interop import (
    band_to_numpy, ellw_to_numpy, hierarchy_to_numpy,
)
from knpemi_tpu_torch.ops import banded as TB
from knpemi_tpu_torch.ops import ell as TE
from knpemi_tpu_torch.sim import SolverOptions, build_idealized
from knpemi_tpu_torch.solvers import mg as tmg

from test_torch_slice import jax_simulation, run_jax, run_port

TOL32 = 1e-5
TOL64 = 1e-12


# ---------------------------------------------------------------------------
# matrices (those of tests/test_pallas_ell.py and tests/test_pallas.py)
# ---------------------------------------------------------------------------
def banded_random(n, m, k_per_row, bw, seed=0, shuffle_frac=0.0):
    """Random CSR with ~k entries/row within +-bw of the diagonal ray;
    ``shuffle_frac`` of the entries land anywhere (far-COO spill)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), k_per_row)
    center = (rows * (m / n)).astype(np.int64)
    cols = np.clip(center + rng.integers(-bw, bw + 1, len(rows)), 0, m - 1)
    if shuffle_frac:
        nf = int(shuffle_frac * len(cols))
        idx = rng.choice(len(cols), nf, replace=False)
        cols[idx] = rng.integers(0, m, nf)
    A = sp.coo_matrix((rng.standard_normal(len(rows)), (rows, cols)),
                      shape=(n, m)).tocsr()
    A.sum_duplicates()
    return A


def tridiag_far(n=3000):
    """Tridiagonal plus 40 symmetric stray pairs: a banded layout with a
    COO remainder."""
    rng = np.random.default_rng(3)
    A = sp.diags([-1, 2.1, -1], [-1, 0, 1], shape=(n, n)).tocsr()
    rr, cc = rng.integers(0, n, 40), rng.integers(0, n, 40)
    F = sp.csr_matrix((rng.standard_normal(40) * 0.01, (rr, cc)), shape=(n, n))
    return (A + F + F.T).tocsr()


def spd_banded(n=3000, seed=21):
    A = banded_random(n, n, 9, 50, seed=seed)
    A = (A + A.T).tocsr()
    return (A + sp.diags(np.asarray(abs(A).sum(axis=1)).ravel() + 1.0)).tocsr()


# name: (matrix, build_ellw keywords)
ELL_CASES = {
    "square": (lambda: banded_random(1000, 1000, 7, 40, seed=2000), {}),
    "tall": (lambda: banded_random(2000, 233, 4, 30, seed=2233), {}),
    "wide": (lambda: banded_random(233, 2000, 20, 150, seed=2233), {}),
    "spill": (lambda: banded_random(6000, 6000, 6, 25, seed=9, shuffle_frac=0.02),
              dict(Wr_cap=24)),
}
BAND_CASES = {
    "tridiag_far": tridiag_far,
    "tall": lambda: banded_random(2000, 233, 4, 30, seed=2233),
    "wide": lambda: banded_random(233, 2000, 20, 150, seed=2233),
    "two_windows": lambda: (tridiag_far(4000) + sp.diags(
        [0.3], [2000], shape=(4000, 4000))).tocsr(),
}


def assert_tree_equal(a, b, path="hier"):
    """Nested dicts / lists of arrays and numbers: same structure, same
    dtypes, equal values."""
    if a is None or b is None:
        assert a is None and b is None, path
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_tree_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_tree_equal(x, y, f"{path}[{i}]")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)


def close(y, y_ref, tol):
    y, y_ref = np.asarray(y, np.float64), np.asarray(y_ref, np.float64)
    scale = np.abs(y_ref).max()
    assert scale > 0 and y.shape == y_ref.shape
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=tol * scale)


# ---------------------------------------------------------------------------
# (a) host layouts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", list(ELL_CASES))
def test_build_ellw_equals_jax(case):
    make, kw = ELL_CASES[case]
    A = make()
    ej, et = JE.build_ellw(A, **kw), TE.build_ellw(A, **kw)
    assert et is not None
    if case == "spill":
        assert et.far_cap > 0
    assert_tree_equal(ellw_to_numpy(ej), ellw_to_numpy(et))


def test_build_ellw_refuses_what_jax_refuses():
    """A bandwidth-free pattern, and a row wider than 256 slots."""
    A = sp.random(4000, 4000, density=0.002, random_state=0).tocsr()
    assert JE.build_ellw(A, Wr_cap=16) is None
    assert TE.build_ellw(A, Wr_cap=16) is None
    B = tridiag_far(800).tolil()
    B[0, :300] = 1.0
    assert JE.build_ellw(B.tocsr()) is None and TE.build_ellw(B.tocsr()) is None


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", list(BAND_CASES))
def test_csr_to_banded_equals_jax(case, dtype):
    A = BAND_CASES[case]()
    bj = jmg._csr_to_banded(A, R=256, dtype=dtype)
    bt = tmg._csr_to_banded(A, R=256, dtype=dtype)
    assert bt is not None
    if case == "tridiag_far":
        assert len(bt[1]) > 0  # a COO remainder
    if case == "two_windows":
        assert len(bt[0]) == 2
    assert_tree_equal(band_to_numpy(bj), band_to_numpy(bt))


def test_csr_to_banded_refuses_what_jax_refuses():
    A = sp.random(4000, 4000, density=0.002, random_state=0).tocsr()
    assert jmg._csr_to_banded(A, W_cap=512) is None
    assert tmg._csr_to_banded(A, W_cap=512) is None
    # a byte budget below the narrowest slab
    T = tridiag_far()
    assert jmg._csr_to_banded(T, mem_cap=1 << 10) is None
    assert tmg._csr_to_banded(T, mem_cap=1 << 10) is None


def _hierarchies(monkeypatch, all_ellw: bool, **kw):
    A = spd_banded()
    if all_ellw:
        monkeypatch.setattr(jmg, "_csr_to_banded", lambda *a, **k: None)
        monkeypatch.setattr(tmg, "_csr_to_banded", lambda *a, **k: None)
    hj = jmg.build_hierarchy(A, coarse_max=80, banded=True, smoother="jacobi", **kw)
    ht = tmg.build_hierarchy(A, coarse_max=80, banded=True, **kw)
    return A, hj, ht


@pytest.mark.parametrize("all_ellw", [False, True], ids=["banded", "all_ellw"])
def test_banded_hierarchy_equals_jax(monkeypatch, all_ellw):
    _, hj, ht = _hierarchies(monkeypatch, all_ellw, slab_dtype=np.float32)
    lv0 = ht.levels[0]
    if all_ellw:
        assert lv0.a_band is None and lv0.a_ellw is not None
        assert lv0.p_ellw is not None and lv0.pt_ellw is lv0.p_ellw
        assert lv0.ap_ellw is not None
    else:
        assert None not in (lv0.a_band, lv0.p_band, lv0.pt_band, lv0.ap_band)
        assert lv0.a_band[0][0][0].dtype == np.float32
    assert_tree_equal(hierarchy_to_numpy(hj), hierarchy_to_numpy(ht))


def test_unstorable_fine_level_is_dropped_as_in_jax(monkeypatch):
    """fine_ell='auto': a level 0 that takes neither layout smooths with
    the caller's operator."""
    A = spd_banded(1500, seed=5)
    for mod, ell_mod in ((jmg, JE), (tmg, TE)):
        monkeypatch.setattr(mod, "_csr_to_banded", lambda *a, **k: None)
        monkeypatch.setattr(ell_mod, "build_ellw", lambda *a, **k: None)
    hj = jmg.build_hierarchy(A, coarse_max=80, banded=True, smoother="jacobi")
    ht = tmg.build_hierarchy(A, coarse_max=80, banded=True)
    assert ht.levels[0].a_cols is None and ht.levels[1].a_cols is not None
    assert_tree_equal(hierarchy_to_numpy(hj), hierarchy_to_numpy(ht))
    assert ht.device(torch.float64, "cpu").layout()[0]["A"] == "caller"


# ---------------------------------------------------------------------------
# (b) the wrappers' plain versions
# ---------------------------------------------------------------------------
def _ell_apply_port(e, V, transpose):
    """V (B, len): B = 1 goes through the single-vector wrapper."""
    if V.shape[0] == 1:
        fn = TE.ellw_rmatvec if transpose else TE.ellw_matvec
        return fn(e, V[0])[None]
    fn = TE.ellw_rmatvec_batch if transpose else TE.ellw_matvec_batch
    return fn(e, V)


def _ell_apply_jax(e, V, transpose):
    if V.shape[0] == 1:
        fn = JE.ellw_rmatvec if transpose else JE.ellw_matvec
        return np.asarray(fn(e, V[0], True))[None]
    fn = JE.ellw_rmatvec_batch if transpose else JE.ellw_matvec_batch
    return np.asarray(fn(e, V, True))


@pytest.mark.parametrize("B", [1, 2, 8])
@pytest.mark.parametrize("transpose", [False, True], ids=["Ax", "ATr"])
@pytest.mark.parametrize("case", ["tall", "spill"])
def test_ellw_plain_f32_vs_jax_interpret(case, transpose, B):
    """K4 / K6a (A x) and K5 / K6b (A^T r)."""
    make, kw = ELL_CASES[case]
    A = make()
    host = TE.build_ellw(A, **kw)
    V = np.random.default_rng(B).standard_normal(
        (B, A.shape[0] if transpose else A.shape[1])).astype(np.float32)
    y = _ell_apply_port(host.device(torch.float32, "cpu"), torch.as_tensor(V),
                        transpose)
    y_jax = _ell_apply_jax(JE.build_ellw(A, **kw).device(jnp.float32),
                           jnp.asarray(V), transpose)
    close(y, y_jax, TOL32)


@pytest.mark.parametrize("B", [1, 2, 8])
@pytest.mark.parametrize("transpose", [False, True], ids=["Ax", "ATr"])
@pytest.mark.parametrize("case", list(ELL_CASES))
def test_ellw_plain_f64_vs_scipy(case, transpose, B):
    make, kw = ELL_CASES[case]
    A = make()
    e = TE.build_ellw(A, **kw).device(torch.float64, "cpu")
    V = np.random.default_rng(10 + B).standard_normal(
        (B, A.shape[0] if transpose else A.shape[1]))
    y = _ell_apply_port(e, torch.as_tensor(V), transpose)
    close(y, (A.T @ V.T).T if transpose else (A @ V.T).T, TOL64)


def test_ellw_device_form_is_the_matrix():
    """to_ell folds the far entries into free slots: the ELL is exactly A."""
    make, kw = ELL_CASES["spill"]
    A = make()
    host = TE.build_ellw(A, **kw)
    cols, vals = host.to_ell()
    assert cols.shape == (A.shape[0], host.K) and cols.dtype == np.int32
    rows = np.repeat(np.arange(A.shape[0]), host.K)
    back = sp.coo_matrix((vals.ravel(), (rows, cols.ravel())), shape=A.shape).tocsr()
    assert abs(back - A).max() == 0.0


@pytest.mark.parametrize("B", [1, 2, 8])
@pytest.mark.parametrize("slab", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["tridiag_far", "tall", "two_windows"])
def test_banded_plain_f32_vs_jax_interpret(case, slab, B):
    """K7 (B = 1, the single wrapper) and K8, window by window."""
    A = BAND_CASES[case]()
    windows, _, _, _, n, m = tmg._csr_to_banded(A, R=256, dtype=np.float32)
    X = np.random.default_rng(B).standard_normal((B, m)).astype(np.float32)
    st, sj = getattr(torch, slab), getattr(jnp, slab)
    for sT, w0, W in windows:
        slabT, w0t = torch.as_tensor(sT).to(st), torch.as_tensor(w0)
        slabJ, w0r = jnp.asarray(sT, sj), jnp.asarray(w0 // 128, jnp.int32)
        if B == 1:
            y = TB.banded_matvec(slabT, w0t, torch.as_tensor(X[0]), n, W)[None]
            y_jax = JB.banded_matvec(slabJ, w0r, jnp.asarray(X[0]), n, W,
                                     interpret=True)[None]
        else:
            y = TB.banded_matvec_batch(slabT, w0t, torch.as_tensor(X), n, W)
            y_jax = JB.banded_matvec_batch(slabJ, w0r, jnp.asarray(X), n, W,
                                           interpret=True)
        close(y, y_jax, TOL32)


@pytest.mark.parametrize("B", [1, 2, 8])
@pytest.mark.parametrize("case", list(BAND_CASES))
def test_banded_mv_f64_vs_scipy(case, B):
    """The windows summed plus the COO remainder (mg._banded_mv) is A."""
    A = BAND_CASES[case]()
    band = tmg._csr_to_banded(A, R=256)
    dev = tmg._device_band(band, torch.float64, "cpu")
    X = np.random.default_rng(20 + B).standard_normal((B, A.shape[1]))
    if B == 1:
        y = tmg._banded_mv(dev, torch.as_tensor(X[0]), batch=False)[None]
    else:
        y = tmg._banded_mv(dev, torch.as_tensor(X), batch=True)
    close(y, (A @ X.T).T, TOL64)


def test_bf16_slab_is_storage_only():
    """A bfloat16 slab is upcast after the read and x is never rounded: the
    result is the float64 product with the ROUNDED matrix, to 1e-12."""
    A = BAND_CASES["tridiag_far"]()
    (sT, w0, W), = tmg._csr_to_banded(A, R=256, dtype=np.float32)[0][:1]
    x = np.random.default_rng(0).standard_normal(A.shape[1])
    slab16 = torch.as_tensor(sT).to(torch.bfloat16)
    y = TB.banded_matvec(slab16, torch.as_tensor(w0), torch.as_tensor(x),
                         A.shape[0], W)
    y_ref = TB.banded_matvec(slab16.to(torch.float64), torch.as_tensor(w0),
                             torch.as_tensor(x), A.shape[0], W)
    assert y.dtype == torch.float64
    close(y, y_ref, TOL64)


def test_new_wrappers_take_plain_path_on_cpu_and_check_inputs():
    A = BAND_CASES["tridiag_far"]()
    n = A.shape[0]
    e = TE.build_ellw(A).device(torch.float32, "cpu")
    (sT, w0, W), = tmg._csr_to_banded(A, R=256, dtype=np.float32)[0][:1]
    slabT, w0 = torch.as_tensor(sT), torch.as_tensor(w0)
    x = torch.ones(n)
    ops.reset_launch_counts()
    TE.ellw_matvec(e, x), TE.ellw_rmatvec(e, x)
    TE.ellw_matvec_batch(e, x[None]), TE.ellw_rmatvec_batch(e, x[None])
    TB.banded_matvec(slabT, w0, x, n, W), TB.banded_matvec_batch(slabT, w0, x[None], n, W)
    assert len(ops.launch_counts()) == 11
    assert all(v == 0 for v in ops.launch_counts().values())
    with pytest.raises(ValueError):
        TE.ellw_matvec(e, x[:-1])
    with pytest.raises(ValueError):
        TE.ellw_rmatvec_batch(e, x)
    with pytest.raises(TypeError):
        TE.ellw_matvec(e, x.double())
    with pytest.raises(TypeError):
        TB.banded_matvec(slabT.double(), w0, x, n, W)
    with pytest.raises(ValueError):
        TB.banded_matvec(slabT, w0, x, n + 300, W)
    with pytest.raises(ValueError):
        TB.banded_matvec(slabT, w0[:-1], x, n, W)


# ---------------------------------------------------------------------------
# (c) the V-cycle
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("batch", [False, True], ids=["apply", "apply_batch"])
@pytest.mark.parametrize("all_ellw", [False, True], ids=["banded", "all_ellw"])
def test_banded_vcycle_equals_jax(monkeypatch, all_ellw, batch):
    A, hj, ht = _hierarchies(monkeypatch, all_ellw)
    dj, dt = hj.device(jnp.float64), ht.device(torch.float64, "cpu")
    want = "ellw" if all_ellw else "band"
    assert all(lv[w] == want for lv in dt.layout() for w in ("A", "P", "Pt"))
    R = np.random.default_rng(22).standard_normal((3, A.shape[0]))
    ident = lambda v: v  # unused: level 0 stores its operator
    if batch:
        yj = np.asarray(dj.apply_batch(ident, jnp.asarray(R)))
        yt = dt.apply_batch(ident, torch.as_tensor(R)).numpy()
    else:
        yj = np.asarray(dj.apply(ident, jnp.asarray(R[0])))
        yt = dt.apply(ident, torch.as_tensor(R[0])).numpy()
    close(yt, yj, 1e-10)


@pytest.mark.parametrize("batch", [False, True], ids=["apply", "apply_batch"])
@pytest.mark.parametrize("all_ellw", [False, True], ids=["banded", "all_ellw"])
def test_fused_post_smooth_equals_unfused(monkeypatch, all_ellw, batch):
    A, _, ht = _hierarchies(monkeypatch, all_ellw)
    fused = ht.device(torch.float64, "cpu")
    assert any(lv["AP"] is not None for lv in fused.layout())
    plain = tmg.DeviceMG(
        [dict(lv, ap_band=None, ap_ellw=None) for lv in fused.levels],
        fused.coarse_V, fused.coarse_ilam, fused.nu)
    assert all(lv["AP"] is None for lv in plain.layout())
    R = torch.as_tensor(np.random.default_rng(1).standard_normal((3, A.shape[0])))
    ident = lambda v: v
    if batch:
        zf, zp = fused.apply_batch(ident, R), plain.apply_batch(ident, R)
    else:
        zf, zp = fused.apply(ident, R[0]), plain.apply(ident, R[0])
    assert float((zf - zp).norm() / zp.norm()) < 1e-10


# ---------------------------------------------------------------------------
# (d) the slice
# ---------------------------------------------------------------------------
N_STEPS = 2


@pytest.fixture(scope="module")
def slice_runs():
    simJ = jax_simulation(jnp.float64, use_pallas=False, mg_banded=True,
                          mg_coarse_max=100)
    opts = dict(rtol_emi=1e-5, rtol_knp=1e-7, mg_coarse_max=100)
    build = lambda banded: build_idealized(
        dim=2, resolution=1, g_syn_bar=10.0, dtype=torch.float64, device="cpu",
        solver_options=SolverOptions(mg_banded=banded, **opts))
    simB, simE = build(True), build(False)
    return simB, run_jax(simJ, N_STEPS), run_port(simB, N_STEPS), run_port(simE, N_STEPS)


def test_slice_hierarchies_are_banded(slice_runs):
    simB = slice_runs[0]
    lay = simB.emi_solver.mg.layout()
    assert len(lay) >= 1 and all(lv["A"] in ("band", "ellw") for lv in lay)
    for t, mg_t in simB.knp_solver.mg.items():
        assert len(mg_t.layout()) >= 1


@pytest.mark.parametrize("step", range(N_STEPS))
def test_banded_step_f64_matches_jax(slice_runs, step):
    _, statesJ, statesB, _ = slice_runs
    sJ, sT = statesJ[step], statesB[step]
    assert int(sT.emi_iters) == int(sJ.emi_iters)
    assert int(sT.knp_iters) == int(sJ.knp_iters)
    assert bool(sT.emi_ok) and bool(sT.knp_ok)
    for m in sJ.phi_M:
        np.testing.assert_allclose(sT.phi_M[m].numpy(), np.asarray(sJ.phi_M[m]),
                                   rtol=1e-9, atol=0)
    for t in sJ.c:
        np.testing.assert_allclose(sT.c[t].numpy(), np.asarray(sJ.c[t]),
                                   rtol=1e-9, atol=0)


@pytest.mark.parametrize("step", range(N_STEPS))
def test_banded_step_counts_equal_ell_path(slice_runs, step):
    _, _, statesB, statesE = slice_runs
    sB, sE = statesB[step], statesE[step]
    assert int(sB.emi_iters) == int(sE.emi_iters)
    assert int(sB.knp_iters) == int(sE.knp_iters)
    for m in sE.phi_M:
        np.testing.assert_allclose(sB.phi_M[m].numpy(), sE.phi_M[m].numpy(),
                                   rtol=1e-9, atol=0)


def test_bf16_fine_slab_option_runs():
    """mg_band_bf16 stores the fine smoothing slab in bfloat16 and the
    step still converges (the slab is preconditioner-internal)."""
    sim = build_idealized(
        dim=2, resolution=1, g_syn_bar=10.0, dtype=torch.float32, device="cpu",
        solver_options=SolverOptions(mg_banded=True, mg_band_bf16=True,
                                     mg_coarse_max=100))
    a_band = sim.emi_solver.mg.levels[0]["a_band"]
    assert a_band is not None
    assert a_band["windows"][0]["slabT"].dtype == torch.bfloat16
    p_band = sim.emi_solver.mg.levels[0]["p_band"]
    assert p_band is None or p_band["windows"][0]["slabT"].dtype == torch.float32
    (s,) = run_port(sim, 1)
    assert bool(s.emi_ok) and bool(s.knp_ok)
