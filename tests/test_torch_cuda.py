"""Each Hopper kernel against its plain version, on a CUDA device.

Skipped where there is no CUDA device (the CPU test machines); on the
GPU run ``python -m pytest tests/test_torch_cuda.py -q --noconftest``.  Tolerances:
the kernels sum with atomics or with fused multiply-adds, in another
order than the plain versions: 1e-5 max|y| in float32, 1e-12 max|y| in
float64.  K7/K8 run on the packed band windows (``ops/banded.py``); K1
and K11 apply a subdomain's assembled P1 operator (``ops/p1op.py``),
whose values K1f and K11f fill.
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
    assert len(rows) == 7
    rows = chip_smoke.check_k11(sim, dtype, time_them=False, phi_scale=1e-3)
    rows += chip_smoke.check_k11(sim_astro, dtype, time_them=False, phi_scale=1.0)
    names = [r["name"] for r in rows]
    assert names.count("K11 knp_apply") == 3 + 4 and names.count("K11f drift_fill") == 2 + 3
    rows = chip_smoke.check_mg_kernels(sim_banded, dtype, time_them=False)
    assert {r["name"].split()[0] for r in rows} == {"K4", "K5", "K6a", "K6b", "K7", "K8"}
    # every kernel of the batched step on each subdomain and membrane
    rows = chip_smoke.check_all_operators(sim_astro, dtype, time_them=False)
    assert len(rows) == 3 * 4 + 3 * 2


def test_step_launches_every_kernel(sim):
    from knpemi_tpu_torch import ops

    ops.reset_launch_counts()
    state, it_e, it_k, ok = sim.run(sim.init_state(), 1)
    assert ok.all()
    counts = ops.launch_counts()
    assert all(counts[k] for k in counts if k.split()[0] in
               ("K1", "K1f", "K2", "K3", "K4", "K9", "K10"))
    assert counts["K1f emi_fill"] == 2  # once per subdomain and EMI solve


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
    (atomics: 1e-5 / 1e-12 of max|value|), the applies on the kernel
    fills' values against the plain applies on the same values."""
    from knpemi_tpu_torch.ops import p1op as P

    tol = {torch.float32: 1e-5, torch.float64: 1e-12}[dtype]
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
            assert float((v - v_ref).abs().max()) <= tol * float(v_ref.abs().max())
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
