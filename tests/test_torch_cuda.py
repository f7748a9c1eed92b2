"""Each Hopper kernel against its plain version, on a CUDA device.

Skipped where there is no CUDA device (the CPU test machines); on the
GPU run ``python -m pytest tests/test_torch_cuda.py -q --noconftest``.  Tolerances:
the kernels sum with fused multiply-adds or in another order than the
plain versions: 1e-5 max|y| in float32, 1e-12 max|y| in float64.  K7/K8
run on the packed band windows (``ops/banded.py``), K4 and K6a on the
sliced form of a windowed-ELL layout or coefficient map
(``ops/ell.py``); K9 is a copy, bitwise equal to its plain version; K1, K3 and
K11 apply a subdomain's assembled P1 operator (``ops/p1op.py``), whose
per-solve values K1f and K11f fill row by row from its incidence list;
K5/K6b gather from the transposed form of a transfer layout; K2 applies
a membrane's surface mass on the membrane's P1 operator and K10 walks
that operator's incidence list.  The fills, K2, K10 and K5/K6b use no
atomics: float64 to 1e-13 max|y|, and two launches give the same bits.
The verification path on the card: the 3-D manufactured solution at M =
8 against its CPU run and repeated bitwise, K3 and K11 on its
host-assembled exact drift against the plain quadrature drift, and the
Chebyshev and W-cycle applies against the CPU's.
"""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def sim():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from knpemi_tpu_torch.sim import build_idealized

    return build_idealized(dim=3, resolution=0, l=1, g_syn_bar=10.0,
                           dtype=torch.float32, device="cuda")


@pytest.fixture(scope="module")
def sim_banded():
    """The same scenario with block-banded / windowed-ELL multigrid; a small
    mg_coarse_max gives its hierarchies levels at this size."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from knpemi_tpu_torch.sim import SolverOptions, build_idealized

    return build_idealized(
        dim=3, resolution=0, l=1, g_syn_bar=10.0, dtype=torch.float32,
        device="cuda", solver_options=SolverOptions(mg_banded=True,
                                                    mg_coarse_max=100))


@pytest.fixture(scope="module")
def sim_astro():
    """The astrocyte tissue scenario at mesh_n 20 on its per-ion KNP branch
    (three subdomains, two membranes; K11 once per GMRES iteration)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from knpemi_tpu_torch.sim import ASTROCYTE_BASELINE, SolverOptions, build_astrocyte

    return build_astrocyte(
        {**ASTROCYTE_BASELINE, "mesh_n": 20}, dtype=torch.float32, device="cuda",
        solver_options=SolverOptions(rtol_emi=1e-5, rtol_knp=3e-6, knp_batched=False))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernels_match_plain_on_cuda(sim, sim_banded, sim_astro, dtype):
    """All fourteen: the seven assembly kernels of the batched step at the
    mesh's shapes and on every subdomain and membrane of the tissue mesh,
    the multigrid kernels at the shapes of the banded hierarchies'
    level 0 (float32 and float64 vectors, and a bfloat16 slab for
    K7/K8), and K11 and K11f on the two subdomains of the idealized mesh
    (phi in V) and on the three of the tissue mesh (phi in mV), K11 also
    against K3 row by row."""
    import chip_smoke

    rows = chip_smoke.check_kernels(sim, dtype, time_them=False)
    assert len(rows) == 8  # K9 twice: nf k a multiple of 4 or not
    rows = chip_smoke.check_k11(sim, dtype, time_them=False, phi_scale=1e-3)
    rows += chip_smoke.check_k11(sim_astro, dtype, time_them=False, phi_scale=1.0)
    names = [r["name"] for r in rows]
    assert names.count("K11 knp_apply") == 3 + 4 and names.count("K11f drift_fill") == 2 + 3
    rows = chip_smoke.check_mg_kernels(sim_banded, dtype, time_them=False)
    assert {r["name"].split()[0] for r in rows} == {"K4", "K5", "K6a", "K6b", "K7", "K8"}
    # every kernel of the batched step on each subdomain and membrane
    rows = chip_smoke.check_all_operators(sim_astro, dtype, time_them=False)
    assert len(rows) == 3 * 4 + 2 * 4


def test_step_launches_every_kernel(sim):
    from knpemi_tpu_torch import ops

    ops.reset_launch_counts()
    state, it_e, it_k, ok = sim.run(sim.init_state(), 1)
    assert ok.all()
    counts = ops.launch_counts()
    assert all(counts[k] for k in counts if k.split()[0] in
               ("K1", "K1f", "K2", "K3", "K4", "K9", "K10", "K11f"))
    # once per subdomain and solve: the EMI values, the KNP drift
    assert counts["K1f emi_fill"] == counts["K11f drift_fill"] == 2


def test_per_ion_step_launches_k11_and_k3_only_for_the_mass_term(sim_astro):
    from knpemi_tpu_torch import ops

    ops.reset_launch_counts()
    state, it_e, it_k, ok = sim_astro.run(sim_astro.init_state(), 2)
    assert ok.all()
    counts = ops.launch_counts()
    assert counts["K11 knp_apply"] > 0
    # steps x subdomains: K3 for the rhs mass term, K11f once per solve
    assert counts["K3 knp_apply_batch"] == counts["K11f drift_fill"] == 2 * 3
    assert all(bool(torch.isfinite(v).all()) for v in state.c.values())


def test_k11_raises_on_a_cuda_tensor_it_does_not_take(sim_astro):
    """On the card the wrapper launches or raises: no path to K3 or to the
    plain version."""
    from knpemi_tpu_torch.ops import p1op as P

    s = sim_astro.knp_sys.sub[1]
    op = s["op"]
    x = torch.ones(s["n_dofs"], device="cuda")
    Pb = sim_astro.knp_sys.ion_vals[1][0]
    Dr = torch.zeros(op.slots, device="cuda")
    with pytest.raises(TypeError):
        P.knp_apply(x, op, Pb, Dr.double(), 0.5)
    with pytest.raises(ValueError):
        P.knp_apply(x, op, Pb, Dr.cpu(), 0.5)
    with pytest.raises(ValueError):
        P.knp_apply(x[:-1], op, Pb, Dr, 0.5)
    before = P.knp_apply.launches
    P.knp_apply(x, op, Pb, Dr, 0.5)
    assert P.knp_apply.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_p1_apply_and_fills_match_plain_on_cuda(sim_astro, dtype):
    """K1, K11 and both fills on every subdomain of the tissue mesh, at
    the operator's own values: the fills against their plain versions
    (row by row, no atomics: 1e-5 / 1e-13 of max|value|, and the same
    bits on a second launch), the applies on the kernel fills' values
    against the plain applies on the same values (1e-5 / 1e-12)."""
    from knpemi_tpu_torch.ops import p1op as P

    tol = {torch.float32: 1e-5, torch.float64: 1e-12}[dtype]
    tol_fill = {torch.float32: 1e-5, torch.float64: 1e-13}[dtype]
    g = torch.Generator(device="cuda").manual_seed(0)
    for t, s in sim_astro.knp_sys.sub.items():
        op = s["op"]
        grads, vols = s["grads"].to(dtype), s["vols"].to(dtype)
        wv = vols * (1.0 + torch.rand(vols.shape, generator=g, device="cuda", dtype=dtype))
        w = torch.randn(s["n_cells"], 3, generator=g, device="cuda", dtype=dtype)
        x = torch.randn(s["n_dofs"], generator=g, device="cuda", dtype=dtype)
        for fill, plain, args in ((P.emi_fill, P.emi_fill_plain, (grads, wv)),
                                  (P.drift_fill, P.drift_fill_plain, (grads, vols, w))):
            v, v_ref = fill(op, *args), plain(op, *args)
            assert float((v - v_ref).abs().max()) <= tol_fill * float(v_ref.abs().max())
            assert torch.equal(fill(op, *args), v)
        V, Dr = P.emi_fill(op, grads, wv), P.drift_fill(op, grads, vols, w)
        for y, y_ref in ((P.emi_stiffness(x, op, V, -1.0), P.emi_stiffness_plain(x, op, V, -1.0)),
                         (P.knp_apply(x, op, V, Dr, 0.3), P.knp_apply_plain(x, op, V, Dr, 0.3))):
            torch.cuda.synchronize()
            assert float((y - y_ref).abs().max()) <= tol * float(y_ref.abs().max())


def test_p1_wrappers_raise_rather_than_fall_back(sim_astro):
    """The P1 operator's wrappers refuse on the card what their kernels do
    not take: int64 cells or columns, a CPU operand, a wrong shape."""
    import copy

    from knpemi_tpu_torch.ops import p1op as P

    s = sim_astro.emi_sys.sub[0]
    op = s["op"]
    x = torch.ones(s["n_dofs"], device="cuda")
    V = P.emi_fill(op, s["grads"], s["vols"])
    bad = copy.copy(op)
    bad.col = op.col.long()
    before = P.emi_stiffness.launches, P.emi_fill.launches
    with pytest.raises(TypeError):
        P.emi_stiffness(x, bad, V)
    with pytest.raises(ValueError):
        P.emi_stiffness(x, op, V.cpu())
    with pytest.raises(ValueError):
        P.emi_fill(op, s["grads"], s["vols"][:-1])
    with pytest.raises(TypeError):
        P.emi_fill(op, s["grads"], s["vols"].double())
    assert (P.emi_stiffness.launches, P.emi_fill.launches) == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k2_and_k10_match_plain_on_every_membrane(sim_astro, dtype):
    """K2 (the surface mass, scaled by C_phi) and K10 (F = 4 channels) on
    both membranes of the tissue mesh: against their plain versions on
    the same inputs to 1e-5 / 1e-13 of max|y|, and the same bits on a
    second launch."""
    from knpemi_tpu_torch.ops import assembly as A
    from knpemi_tpu_torch.ops import p1op as P

    tol = {torch.float32: 1e-5, torch.float64: 1e-13}[dtype]
    g = torch.Generator(device="cuda").manual_seed(1)
    C_phi = sim_astro.params.C_phi
    assert sorted(sim_astro.emi_sys.mem) == [1, 2]
    for m, mb in sim_astro.emi_sys.mem.items():
        op, M = mb["op"], mb["M"].to(dtype)
        x = torch.randn(op.n, generator=g, device="cuda", dtype=dtype)
        V = torch.randn(4, *op.cells.shape, generator=g, device="cuda", dtype=dtype)
        for kern, plain, args in ((P.surface_mass, P.surface_mass_plain, (x, op, M, C_phi)),
                                  (A.facet_scatter, A.facet_scatter_plain, (V, op))):
            before = kern.launches
            y, y_ref = kern(*args), plain(*args)
            torch.cuda.synchronize()
            assert kern.launches == before + 1
            assert float((y - y_ref).abs().max()) <= tol * float(y_ref.abs().max())
            assert torch.equal(kern(*args), y)


def test_k2_and_k10_raise_rather_than_fall_back(sim_astro):
    """On the card K2 and K10 launch or raise: a CPU or int64 incidence
    list, values of another dtype or length, V of another shape."""
    import copy

    from knpemi_tpu_torch.ops import assembly as A
    from knpemi_tpu_torch.ops import p1op as P

    mb = sim_astro.emi_sys.mem[1]
    op, M = mb["op"], mb["M"]
    x = torch.ones(op.n, device="cuda")
    V = torch.ones(4, *op.cells.shape, device="cuda")
    bad = copy.copy(op)
    bad.inc = op.inc.long()
    before = P.surface_mass.launches, A.facet_scatter.launches
    with pytest.raises(TypeError):
        P.surface_mass(x, op, M.double())
    with pytest.raises(ValueError):
        P.surface_mass(x, op, M[:-1])
    with pytest.raises(ValueError):
        P.surface_mass(x, op, M.cpu())
    with pytest.raises(TypeError):
        A.facet_scatter(V, bad)
    with pytest.raises(ValueError):
        A.facet_scatter(V[:, :-1].contiguous(), op)
    bad.inc = op.inc.cpu()
    with pytest.raises(ValueError):
        A.facet_scatter(V, bad)
    assert (P.surface_mass.launches, A.facet_scatter.launches) == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k3_matches_plain_on_every_subdomain(sim_astro, dtype):
    """K3 on the three tissue subdomains at B = 1, 2, 3: the full apply
    (mass, stiffness, drift) and the right-hand side's mass-only apply."""
    import chip_smoke

    rows = chip_smoke.check_cases(chip_smoke.k3_cases(sim_astro, dtype, 1.0), dtype,
                                  time_them=False)
    assert len(rows) == 3 * 3 * 2
    assert all(r["drift_share"] > 1e-3 for r in rows if "drift_share" in r)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k6a_matches_plain_and_scipy_with_far_entries(dtype):
    """K6a on the sliced form of a windowed-ELL layout with far entries
    folded in, B = 1, 2, 8 and 9 (two launches), against the plain
    version and the scipy product."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np
    import scipy.sparse as sp

    from knpemi_tpu_torch.ops import ell as TE

    rng = np.random.default_rng(0)
    n = 20000
    rows = np.repeat(np.arange(n), 6)
    cols = np.clip(rows + rng.integers(-200, 201, len(rows)), 0, n - 1)
    spill = rng.choice(len(cols), len(cols) // 50, replace=False)
    cols[spill] = rng.integers(0, n, len(spill))
    A = sp.coo_matrix((rng.standard_normal(len(rows)), (rows, cols)), shape=(n, n)).tocsr()
    host = TE.build_ellw(A)
    assert host.far_cap > 0
    e = host.device(dtype, "cuda", sliced=True)
    tol = {torch.float32: 1e-5, torch.float64: 1e-12}[dtype]
    before = TE.ellw_matvec_batch.launches
    for B in (1, 2, 8, 9):
        X = torch.as_tensor(rng.standard_normal((B, n)), dtype=dtype, device="cuda")
        Y, Y_ref = TE.ellw_matvec_batch(e, X), TE.ellw_matvec_batch_plain(e, X)
        Ys = torch.as_tensor((A @ X.double().cpu().numpy().T).T)
        torch.cuda.synchronize()
        scale = float(Y_ref.abs().max())
        assert float((Y - Y_ref).abs().max()) <= tol * scale
        assert float((Y.double().cpu() - Ys).abs().max()) <= 10 * tol * scale
    assert TE.ellw_matvec_batch.launches == before + 1 + 1 + 1 + 2


def test_k3_and_k6a_raise_rather_than_fall_back(sim_astro):
    """On the card K3 refuses a CPU operand, a wrong dtype or only one of
    the stiffness and drift streams; K6a a layout without its sliced form
    or a vector of the wrong length; neither launches then."""
    import dataclasses

    from knpemi_tpu_torch.ops import ell as TE
    from knpemi_tpu_torch.ops import p1op as P

    s = sim_astro.knp_sys.sub[0]
    op, M, Kst = s["op"], s["M"], s["kst"]
    X = torch.ones(2, s["n_dofs"], device="cuda")
    Dr = torch.zeros(op.slots, device="cuda")
    before = P.knp_apply_batch.launches
    with pytest.raises(ValueError):
        P.knp_apply_batch(X, op, s["coef"], M, Kst)
    with pytest.raises(ValueError):
        P.knp_apply_batch(X, op, s["coef"], M.cpu(), Kst, Dr)
    with pytest.raises(TypeError):
        P.knp_apply_batch(X, op, s["coef"], M, Kst, Dr.double())
    assert P.knp_apply_batch.launches == before
    import scipy.sparse as sp

    A = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(500, 500)).tocsr()
    e = TE.build_ellw(A).device(torch.float32, "cuda", sliced=True)
    before = TE.ellw_matvec_batch.launches
    with pytest.raises(ValueError):
        TE.ellw_matvec_batch(dataclasses.replace(e, slot_ptr=None),
                             torch.ones(2, 500, device="cuda"))
    with pytest.raises(ValueError):
        TE.ellw_matvec_batch(e, torch.ones(2, 499, device="cuda"))
    assert TE.ellw_matvec_batch.launches == before


def test_per_ion_banded_step_runs_the_knp_vcycle_on_single_vectors():
    """knp_batched=False with mg_banded=True: K7 and K11, no batch kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from knpemi_tpu_torch import ops
    from knpemi_tpu_torch.sim import SolverOptions, build_idealized

    sim = build_idealized(
        dim=3, resolution=0, l=1, g_syn_bar=10.0, dtype=torch.float32, device="cuda",
        solver_options=SolverOptions(mg_banded=True, mg_coarse_max=100,
                                     knp_batched=False))
    ops.reset_launch_counts()
    state, it_e, it_k, ok = sim.run(sim.init_state(), 2)
    assert ok.all() and it_k.max() > 0
    counts = ops.launch_counts()
    assert counts["K7 banded_matvec"] and counts["K11 knp_apply"]
    assert not (counts["K6a ellw_matvec_batch"] or counts["K6b ellw_rmatvec_batch"]
                or counts["K8 banded_matvec_batch"])


def test_banded_step_launches_the_multigrid_kernels(sim_banded):
    from knpemi_tpu_torch import ops

    ops.reset_launch_counts()
    state, it_e, it_k, ok = sim_banded.run(sim_banded.init_state(), 1)
    assert ok.all()
    counts = ops.launch_counts()
    assert counts["K7 banded_matvec"] and counts["K8 banded_matvec_batch"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_packed_band_kernels_match_plain_on_every_window(sim_banded, dtype):
    """K7 and K8 on every packed window of the banded hierarchies (EMI and
    KNP tag 0, every level and role), values in the run dtype and in
    bfloat16, each route of reading x held against the plain version."""
    import chip_smoke

    rows = chip_smoke.check_mg_kernels(sim_banded, dtype, time_them=False, all_bands=True)
    band = [r for r in rows if r["name"].split()[0] in ("K7", "K8")]
    assert band and all("max_abs_err_l2" in r for r in band)
    windows = sum(len(lv[f"{w}_band"]["windows"]) for lv in sim_banded.emi_solver.mg.levels
                  for w in ("a", "ap", "p", "pt") if lv[f"{w}_band"] is not None)
    # one case per window and value type
    assert sum(r["name"].startswith("K7") for r in band) == 2 * windows


def test_packed_band_wrappers_raise_rather_than_fall_back(sim_banded):
    import dataclasses

    from knpemi_tpu_torch.ops import banded as TB

    band = next(lv[f"{w}_band"] for lv in sim_banded.emi_solver.mg.levels
                for w in ("a", "ap", "p", "pt") if lv[f"{w}_band"] is not None)
    win, n, m = band["windows"][0], band["n"], band["m"]
    x = torch.ones(m, device="cuda")
    before = TB.banded_matvec.launches
    with pytest.raises(TypeError):
        TB.banded_matvec(win, x.double(), n)
    with pytest.raises(ValueError):
        TB.banded_matvec(win, x.cpu(), n)
    # eight float64 windows of 4,096 do not fit in shared memory: refused
    wide = dataclasses.replace(win, val=win.val.double(), W=4096)
    with pytest.raises(RuntimeError):
        TB.banded_matvec_batch(wide, torch.ones(8, m, device="cuda", dtype=torch.float64),
                               n, route="staged")
    assert TB.banded_matvec.launches == before
    TB.banded_matvec(win, x, n)
    assert TB.banded_matvec.launches == before + 1


@pytest.fixture(scope="module")
def sims_res2():
    """The 3-D res-2 scenario and its box of twice the length (l = 4) with
    mg_banded=True: the hierarchies whose transfers take windowed-ELL
    layouts at the main path's shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from knpemi_tpu_torch.sim import SolverOptions, build_idealized

    return {f"l={l}": build_idealized(dim=3, resolution=2, l=l, g_syn_bar=10.0,
                                      dtype=torch.float32, device="cuda",
                                      solver_options=SolverOptions(mg_banded=True))
            for l in (2, 4)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_restriction_matches_plain_on_every_transfer_layout(sims_res2, dtype):
    """K5 and K6b (B = 1, 2, 3, 8) on every layout the EMI and KNP cycles
    of both boxes restrict through, against their plain versions, each
    launched twice with the same bits."""
    import chip_smoke

    total = 0
    for name, sim in sims_res2.items():
        mgs = {"EMI": sim.emi_solver.mg,
               **{f"KNP tag {t}": mg for t, mg in sim.knp_solver.mg.items()}}
        layouts = chip_smoke._pt_layouts(mgs)
        assert layouts or name != "l=4"
        total += len(layouts)
        if not layouts:
            continue
        cases = chip_smoke.restrict_cases(layouts, dtype, (None, 1, 2, 3, 8), timed=False)
        rows = chip_smoke.check_cases(cases, dtype, time_them=False)
        assert len(rows) == 5 * len(layouts) and all(r["deterministic"] for r in rows)
        assert all(r["shape"]["G"] in (4, 8, 16, 32)
                   for r in rows if r["shape"]["source"].startswith("KNP"))
    assert total > 0


def test_restriction_raises_rather_than_fall_back():
    """On the card K5/K6b refuse a layout without its transposed form and
    a vector of the wrong length; nine vectors go through in two launches,
    each as bitwise repeatable as one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np
    import scipy.sparse as sp

    from knpemi_tpu_torch.ops import ell as TE

    rng = np.random.default_rng(1)
    n, nc = 30000, 4000
    rows = np.repeat(np.arange(n), 4)
    cols = np.clip(rows * nc // n + rng.integers(-20, 21, len(rows)), 0, nc - 1)
    P = sp.coo_matrix((rng.standard_normal(len(rows)), (rows, cols)), shape=(n, nc)).tocsr()
    host = TE.build_ellw(P)
    e = host.device(torch.float32, "cuda", transposed=True)
    bare = host.device(torch.float32, "cuda", sliced=True)
    R = torch.as_tensor(rng.standard_normal((9, n)), dtype=torch.float32, device="cuda")
    before = TE.ellw_rmatvec.launches, TE.ellw_rmatvec_batch.launches
    with pytest.raises(ValueError):
        TE.ellw_rmatvec(bare, R[0])
    with pytest.raises(ValueError):
        TE.ellw_rmatvec_batch(bare, R)
    with pytest.raises(ValueError):
        TE.ellw_rmatvec_batch(e, R[:, :-1].contiguous())
    assert (TE.ellw_rmatvec.launches, TE.ellw_rmatvec_batch.launches) == before
    Y = TE.ellw_rmatvec_batch(e, R)
    assert TE.ellw_rmatvec_batch.launches == before[1] + 2
    assert torch.equal(Y, TE.ellw_rmatvec_batch(e, R))
    Ys = torch.as_tensor((P.T @ R.double().cpu().numpy().T).T)
    assert float((Y.double().cpu() - Ys).abs().max()) <= 1e-5 * float(Ys.abs().max())


def _ragged_sliced(n_rows, n_cols, dtype, seed):
    """A sliced form with a row count that is not a multiple of 32, an
    empty row (from 2 rows), a slice of width 0 (from 64 rows) and a
    last row longer than eight slots, and its scipy matrix."""
    import numpy as np
    import scipy.sparse as sp

    from knpemi_tpu_torch.ops import ell as TE

    M = sp.random(n_rows, n_cols, density=0.05, random_state=seed, format="lil")
    M[n_rows // 2, :] = 0.0
    if n_rows >= 64:
        M[32:64, :] = 0.0
    M[n_rows - 1, : min(n_cols, 40)] = 1.0
    M = M.tocsr()
    M.eliminate_zeros()
    nnz = np.diff(M.indptr)
    K = max(int(nnz.max()), 1)
    cols = np.zeros((n_rows, K), np.int32)
    vals = np.zeros((n_rows, K))
    r = np.repeat(np.arange(n_rows), nnz)
    pos = np.arange(M.nnz) - np.repeat(M.indptr[:-1], nnz)
    cols[r, pos], vals[r, pos] = M.indices, M.data
    e = TE._upload_sliced(TE.DeviceELLW(n_rows, n_cols, K=K), cols, vals, dtype, "cuda")
    return e, M


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_rows", [1, 31, 70, 1000, 4097])
def test_k4_matches_plain_on_ragged_slices(n_rows, dtype):
    """K4 on a row count that is not a multiple of 32, with empty rows, a
    slice of width 0 and a row longer than eight slots in flight: against
    the plain version (1e-5 / 1e-13 of max|y|) and scipy, one launch each,
    the same bits on a second launch; an empty row gives an exact 0 (one
    row: that row is the long one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    from knpemi_tpu_torch.ops import ell as TE

    n_cols = 300
    e, M = _ragged_sliced(n_rows, n_cols, dtype, n_rows)
    if n_rows >= 64:
        assert int(e.slot_ptr_host[2] - e.slot_ptr_host[1]) == 0
    tol = {torch.float32: 1e-5, torch.float64: 1e-13}[dtype]
    x = torch.as_tensor(np.random.default_rng(n_rows).standard_normal(n_cols), dtype=dtype,
                        device="cuda")
    before = TE.ellw_matvec.launches
    y, y_ref = TE.ellw_matvec(e, x), TE.ellw_matvec_plain(e, x)
    torch.cuda.synchronize()
    assert TE.ellw_matvec.launches == before + 1
    scale = float(y_ref.abs().max())
    assert float((y - y_ref).abs().max()) <= tol * scale
    ys = torch.as_tensor(M @ x.double().cpu().numpy())
    assert float((y.double().cpu() - ys).abs().max()) <= 10 * tol * scale
    if n_rows > 1:
        assert float(y[n_rows // 2]) == 0.0
    assert torch.equal(TE.ellw_matvec(e, x), y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k4_matches_plain_on_the_coefficient_maps(sim_astro, dtype):
    """K4 on both frozen coefficient maps of every tissue subdomain."""
    from knpemi_tpu_torch.ops import ell as TE

    tol = {torch.float32: 1e-5, torch.float64: 1e-13}[dtype]
    g = torch.Generator(device="cuda").manual_seed(3)
    for t in sorted(sim_astro.knp_sys.sub):
        for m in (sim_astro.emi_sys.sub[t]["kbar"], sim_astro.knp_sys.sub[t]["grad"]):
            m = TE.DeviceELLW(m.n_rows, m.n_cols, K=m.K, slot_ptr=m.slot_ptr, scol=m.scol,
                              sval=m.sval.to(dtype), nnz=m.nnz)
            x = torch.randn(m.n_cols, generator=g, device="cuda", dtype=dtype)
            y, y_ref = TE.ellw_matvec(m, x), TE.ellw_matvec_plain(m, x)
            torch.cuda.synchronize()
            assert float((y - y_ref).abs().max()) <= tol * float(y_ref.abs().max())
            assert torch.equal(TE.ellw_matvec(m, x), y)


def test_k4_raises_rather_than_fall_back():
    """On the card K4 refuses a layout without its sliced form, int64
    columns, a CPU vector or one of the wrong length or dtype."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses

    from knpemi_tpu_torch.ops import ell as TE

    e, _ = _ragged_sliced(70, 300, torch.float32, 0)
    x = torch.ones(300, device="cuda")
    before = TE.ellw_matvec.launches
    with pytest.raises(ValueError):
        TE.ellw_matvec(dataclasses.replace(e, slot_ptr=None), x)
    with pytest.raises(TypeError):
        TE.ellw_matvec(dataclasses.replace(e, scol=e.scol.long()), x)
    with pytest.raises(ValueError):
        TE.ellw_matvec(e, x.cpu())
    with pytest.raises(ValueError):
        TE.ellw_matvec(e, x[:-1])
    with pytest.raises(TypeError):
        TE.ellw_matvec(e, x.double())
    assert TE.ellw_matvec.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("F", [1, 11])
@pytest.mark.parametrize("k, nf", [(2, 1000), (2, 999), (3, 1000), (3, 999), (3, 1001)])
@pytest.mark.parametrize("offset", [False, True], ids=["aligned", "offset"])
def test_k9_is_bitwise_its_plain_version(k, nf, F, dtype, offset):
    """K9 at F = 1 and 11 channels, k = 2 and 3 (nf k mod 4 in {0, 2} and
    {0, 1, 3}), with X and the facet map as aligned tensors and as views
    one element into their storage: the same bits as the plain gather."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from knpemi_tpu_torch.ops import assembly as A

    g = torch.Generator(device="cuda").manual_seed(nf + k)
    n_mem = 777
    o = 1 if offset else 0
    X = torch.randn(F * n_mem + o, generator=g, device="cuda", dtype=dtype)[o:].view(F, n_mem)
    fd = torch.randint(0, n_mem, (nf * k + o,), generator=g, device="cuda",
                       dtype=torch.int32)[o:].view(nf, k)
    assert (X.data_ptr() % 16 != 0) == offset and (fd.data_ptr() % 16 != 0) == offset
    before = A.facet_gather.launches
    G = A.facet_gather(X, fd)
    torch.cuda.synchronize()
    assert A.facet_gather.launches == before + 1 and G.shape == (F, nf, k)
    assert torch.equal(G, A.facet_gather_plain(X, fd))


def test_k9_raises_rather_than_fall_back():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from knpemi_tpu_torch.ops import assembly as A

    X = torch.ones(3, 50, device="cuda")
    fd = torch.zeros(20, 3, dtype=torch.int32, device="cuda")
    before = A.facet_gather.launches
    with pytest.raises(TypeError):
        A.facet_gather(X, fd.long())
    with pytest.raises(ValueError):
        A.facet_gather(X, fd.cpu())
    with pytest.raises(TypeError):
        A.facet_gather(X.half(), fd)
    with pytest.raises(ValueError):
        A.facet_gather(X.t(), fd)
    assert A.facet_gather.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("G", [4, 8, 32])
@pytest.mark.parametrize("B", [None, 1, 2, 3, 8, 9])
def test_far_sum_matches_its_plain_twin_and_repeats(G, B, dtype):
    """The far remainder of a banded operator on K5/K6b's kernel (its ADD
    form): its plain twin on the CPU to 1e-13 of max|y| in float64 (1e-5
    in float32), the same bits from two launches, rows without entries
    left alone, and the launches counted under K5 (one vector) or K6b (a
    batch, groups of 8), each also in ``csr_add.launches``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    from knpemi_tpu_torch.ops import ell as TE

    rng = np.random.default_rng(G + (B or 0))
    n, m = 5000, 7000
    counts = rng.integers(0, 3 * G, n)
    counts[rng.random(n) < 0.8] = 0
    rows = np.repeat(np.arange(n), counts)
    cols = rng.integers(0, m, len(rows))
    vals = rng.standard_normal(len(rows))
    perm = rng.permutation(len(rows))
    ptr, col, val = TE.far_csr(rows[perm], cols[perm], vals[perm], n, len(rows) + 11)
    dev = lambda d: TE.DeviceCSR(n, m, torch.as_tensor(ptr, device=d),
                                 torch.as_tensor(col, device=d),
                                 torch.as_tensor(val, dtype=dtype, device=d), G)
    fc, fh = dev("cuda"), dev("cpu")
    shape = (B, m) if B else (m,)
    X = torch.as_tensor(rng.standard_normal(shape), dtype=dtype)
    Y0 = torch.as_tensor(rng.standard_normal(shape[:-1] + (n,)), dtype=dtype)
    before = TE.ellw_rmatvec.launches, TE.ellw_rmatvec_batch.launches
    far_before = TE.csr_add.launches
    Xc = X.cuda()
    Y1 = TE.csr_add(fc, Xc, Y0.cuda())
    Y2 = TE.csr_add(fc, Xc, Y0.cuda())
    torch.cuda.synchronize()
    want = TE.csr_add(fh, X, Y0.clone())
    assert torch.equal(Y1, Y2)
    tol = 1e-13 if dtype == torch.float64 else 1e-5
    err = float((Y1.cpu() - want).abs().max())
    assert err <= tol * float(want.abs().max()), err
    empty = torch.as_tensor(np.diff(ptr) == 0)
    assert torch.equal(Y1.cpu()[..., empty], Y0[..., empty])
    after = TE.ellw_rmatvec.launches, TE.ellw_rmatvec_batch.launches
    if B:
        assert after == (before[0], before[1] + 2 * -(-B // 8))
    else:
        assert after == (before[0] + 2, before[1])
    assert TE.csr_add.launches - far_before == sum(after) - sum(before)


def test_two_banded_steps_from_one_state_are_bitwise_equal():
    """The 3-D res-1 scenario with mg_banded=True, whose EMI hierarchy has
    a far remainder: two steps from one state give the same bits in
    every tensor of the state."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses

    from knpemi_tpu_torch.sim import SolverOptions, build_idealized

    sim = build_idealized(dim=3, resolution=1, g_syn_bar=10.0, dtype=torch.float32,
                          device="cuda", solver_options=SolverOptions(mg_banded=True))
    assert any(lv[w + "_band"] is not None and lv[w + "_band"]["far"] is not None
               for lv in sim.emi_solver.mg.levels for w in ("a", "ap", "p", "pt"))
    state, _, _, _ = sim.run(sim.init_state(), 2)
    a, b = sim.step(state), sim.step(state)
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        for k in (x if isinstance(x, dict) else [None]):
            u, v = (x[k], y[k]) if k is not None else (x, y)
            assert torch.equal(u, v), (f.name, k)


def test_two_builds_give_the_same_source_vector():
    """The ECS source's load vector is summed on the host in float64 and
    cast: two float32 builds of the tissue scenario on the card hold the
    same bits, those of the float64 CPU build cast to float32 (a scatter
    on the card added with atomics, and two builds differed)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from knpemi_tpu_torch.sim import ASTROCYTE_BASELINE, build_astrocyte

    cfg = {**ASTROCYTE_BASELINE, "mesh_n": 20}
    a, b = (build_astrocyte(cfg, dtype=torch.float32, device="cuda") for _ in range(2))
    ref = build_astrocyte(cfg, dtype=torch.float64, device="cpu").knp_sys._src_vec[0]
    va, vb = a.knp_sys._src_vec[0], b.knp_sys._src_vec[0]
    assert va.abs().max() > 0
    assert torch.equal(va, vb)
    assert torch.equal(va.cpu(), ref.to(torch.float32))


@pytest.fixture(scope="module")
def mms_3d():
    """The 3-D manufactured solution at M = 8 on the card and on the CPU,
    float64, with per-ion operators (K11) besides the batched ones (K3)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import chip_smoke

    return chip_smoke._mms_data(3, 8)


def test_mms_iterative_solve_on_the_card_matches_the_cpu(mms_3d):
    """Deflated-Jacobi CG, Jacobi GMRES batched and per ion, rtol 1e-10:
    equal iteration counts, fields within 1e-9 of max|u|, and the L2
    errors equal to 1e-9 relative."""
    import chip_smoke

    eg, e1g, itg, _, _, fg = chip_smoke._mms_solve(mms_3d, "cuda", per_ion=True)
    ec, e1c, itc, _, _, fc = chip_smoke._mms_solve(mms_3d, "cpu", per_ion=True)
    assert itg == itc
    for key in ("phi", "c", "c_per_ion"):
        for t in fc[key]:
            assert chip_smoke._norm_rel(fg[key][t], fc[key][t]) <= 1e-9
    for f in chip_smoke.MMS_FIELDS:
        assert abs(eg[f] - ec[f]) <= 1e-9 * ec[f] and abs(e1g[f] - e1c[f]) <= 1e-9 * e1c[f]


def test_mms_solve_on_the_card_repeats_bitwise(mms_3d):
    """Two runs of the MMS solves on the card give the same bits: the
    Jacobi diagonals are summed by ``P1Operator.scatter_cells``, not by
    an atomic scatter."""
    import chip_smoke

    _, _, it1, _, _, f1 = chip_smoke._mms_solve(mms_3d, "cuda", per_ion=True)
    _, _, it2, _, _, f2 = chip_smoke._mms_solve(mms_3d, "cuda", per_ion=True)
    assert it1 == it2
    for key in ("phi", "c", "c_per_ion"):
        for t in f1[key]:
            assert torch.equal(f1[key][t], f2[key][t])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mms_drift_stream_under_k3_and_k11_matches_drift_apply_quad(mms_3d, dtype):
    """K3 (z = psi = D = 1, no mass or stiffness) and K11 (P = 0) on the
    host-assembled exact drift against the plain quadrature drift
    ``ops.kernels.drift_apply_quad``, per subdomain."""
    import numpy as np

    from knpemi_tpu_torch.ops import kernels as K
    from knpemi_tpu_torch.ops import p1op as P
    from knpemi_tpu_torch.ops.p1op import p1_operators
    from knpemi_tpu_torch.systems.knp import mms_drift_values

    geom, case, ions, ed, kd = mms_3d
    ops_ = p1_operators(geom, "cuda")
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    rng = np.random.default_rng(3)
    for t, s in geom.subdomains.items():
        op = ops_[t]
        Dr = mms_drift_values(op, s.cells, s.grads, s.vols, kd.gradphi_q[t], kd.cell_bary,
                              kd.cell_qw, dtype)
        X = torch.as_tensor(rng.standard_normal((2, s.n_dofs)), dtype=dtype, device="cuda")
        cpu = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)
        ref = torch.stack([K.drift_apply_quad(
            s.n_dofs, X[b].cpu().double(), cpu(s.cells).long(), cpu(s.grads), cpu(s.vols),
            cpu(kd.gradphi_q[t]), cpu(kd.cell_bary), cpu(kd.cell_qw)) for b in range(2)])
        zero = torch.zeros_like(Dr)
        coef = torch.tensor([[0.0, 0.0, 1.0]] * 2, dtype=dtype, device="cuda")
        y3 = P.knp_apply_batch(X, op, coef, zero, zero, Dr)
        y11 = torch.stack([P.knp_apply(X[b].contiguous(), op, zero, Dr, 1.0) for b in range(2)])
        for y in (y3, y11):
            assert float((y.cpu().double() - ref).abs().max()) <= tol * float(ref.abs().max())


@pytest.mark.parametrize("opts", [dict(mg_smoother="cheby", mg_degree=3), dict(gamma=2)],
                         ids=["cheby", "w_cycle"])
@pytest.mark.parametrize("banded", [False, True], ids=["ell", "banded"])
def test_cycle_options_apply_matches_the_cpu(opts, banded):
    """One Chebyshev and one W-cycle DeviceMG.apply (the EMI hierarchy, one
    vector) and apply_batch (a KNP hierarchy, B = 2) on the card against
    the same hierarchy's on the CPU, float64, on the 3-D res-0 l = 1 box
    (``chip_smoke.cycle_apply_readings``): within 1e-12 of max|y|, the
    W-cycle's EMI apply within 1e-10 (``chip_smoke.CYCLE_APPLY_TOL``: on
    the singular EMI operator the W-cycle amplifies roundoff, so the two
    devices' summation orders part by more)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import chip_smoke
    from knpemi_tpu_torch.sim import SolverOptions, build_idealized

    name = "W-cycle" if "gamma" in opts else "cheby"
    assert chip_smoke.CYCLE_APPLY_CASES[name] == opts
    path = "banded" if banded else "ell"
    # the CPU's leg in this process (the smoke run reads it from its CPU process)
    cpu = {f"cycle {path}: {name}": chip_smoke._cycle_leg(build_idealized, SolverOptions,
                                                          path, name, "cpu")}
    rec = chip_smoke.cycle_apply_readings(build_idealized, SolverOptions, path, name, cpu)
    gamma = opts.get("gamma", 1)
    assert rec["emi"] <= (1e-10 if gamma == 2 else 1e-12)
    assert rec["knp"] <= 1e-12


def test_native_sweep_in_a_cuda_build_matches_the_plain_sweep():
    """A CUDA build runs the native Vanek sweep (``utils/native.py``): on
    its EMI level-0 strength graph the aggregates equal the plain
    sweep's, and the build timed its sweeps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import chip_smoke
    from knpemi_tpu_torch.sim import build_idealized

    sim = build_idealized(dim=3, resolution=1, g_syn_bar=10.0, dtype=torch.float32,
                          device="cuda")
    rec = chip_smoke.native_sweep_check(sim)
    assert rec["identical"] and rec["aggregates"] > 0
    assert sim.setup_detail["emi_vanek_sweep"] > 0.0
    assert sim.setup_detail["emi_assembly_cache"] in ("hit", "miss")


def test_benchmark_scenario_on_the_card_matches_the_cpu():
    """The benchmark scenario (``sim.build_two_cell``: three membranes on
    one cell), 2 float64 steps on the card and on the CPU: equal
    iterations, phi_M within 1e-9 mV, c within 1e-9 relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import chip_smoke
    from knpemi_tpu_torch.sim import build_two_cell

    runs = {}
    for dev in ("cuda", "cpu"):
        sim = build_two_cell(dtype=torch.float64, device=dev)
        runs[dev] = sim.run(sim.init_state(), 2)
    (g, ge, gk, gok), (c, ce, ck, cok) = runs["cuda"], runs["cpu"]
    assert gok.all() and cok.all()
    assert ge.tolist() == ce.tolist() and gk.tolist() == ck.tolist()
    chip_smoke.gpu_vs_cpu(g, c, "benchmark", "mV")


def test_parallel_modes_on_the_card():
    """The multi-device modes on the card, 2-D res 1, float64, 2 ranks
    sharing it over gloo: the SPMD step bitwise the single-device GPU
    step; the distributed V-cycle's steps against the same 2 ranks on the
    CPU (equal iterations, phi_M within 1e-9 V, c 1e-9 relative)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import functools

    import numpy as np

    from knpemi_tpu_torch.parallel import launch, programs
    from knpemi_tpu_torch.sim import SolverOptions, build_idealized

    b = functools.partial(build_idealized, dim=2, resolution=1, g_syn_bar=10.0,
                          dtype=torch.float64, solver_options=SolverOptions(mg_coarse_max=100))
    res = launch(programs.run_cases, 2, "gloo", "cuda", deadline=600, args=(
        [("spmd", dict(build=b)), ("sharded", dict(build=b, distributed_mg=True))],))
    a, c = res[0]["results"]
    assert a["bitwise"] and c["totals"]["staged"] > 0
    cpu = launch(programs.run_cases, 2, "gloo", "cpu", deadline=600, threads=1, args=(
        [("sharded", dict(build=b, distributed_mg=True))],))[0]["results"][0]
    assert c["iters"] == cpu["iters"]
    for g, h in zip(c["states"], cpu["states"]):
        for m in g["phi_M"]:
            assert np.abs(g["phi_M"][m] - h["phi_M"][m]).max() <= 1e-9
        for t in g["c"]:
            assert np.abs(g["c"][t] - h["c"][t]).max() <= 1e-9 * np.abs(h["c"][t]).max()
