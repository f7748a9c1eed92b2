"""Each Hopper kernel against its plain version, on a CUDA device.

Skipped where there is no CUDA device (the CPU test machines); on the
GPU run ``python -m pytest tests/test_torch_cuda.py -q --noconftest``.  Tolerances:
the kernels sum with atomics or with fused multiply-adds, in another
order than the plain versions: 1e-5 max|y| in float32, 1e-12 max|y| in
float64.  K7/K8 run on the packed band windows (``ops/banded.py``).
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
    """All twelve: the six assembly kernels of the batched step at the
    mesh's shapes and on every subdomain and membrane of the tissue mesh,
    the multigrid kernels at the shapes of the banded hierarchies'
    level 0 (float32 and float64 vectors, and a bfloat16 slab for
    K7/K8), and K11 on the idealized mesh (phi in V) and on the three
    subdomains of the tissue mesh (phi in mV), also against K3 row by row."""
    import chip_smoke

    rows = chip_smoke.check_kernels(sim, dtype, time_them=False)
    assert len(rows) == 6
    rows = chip_smoke.check_k11(sim, dtype, time_them=False, phi_scale=1e-3)
    rows += chip_smoke.check_k11(sim_astro, dtype, time_them=False, phi_scale=1.0)
    assert {r["name"] for r in rows} == {"K11 knp_apply"} and len(rows) == 3 + 4
    rows = chip_smoke.check_mg_kernels(sim_banded, dtype, time_them=False)
    assert {r["name"].split()[0] for r in rows} == {"K4", "K5", "K6a", "K6b", "K7", "K8"}
    # every kernel of the batched step on each subdomain and membrane
    rows = chip_smoke.check_all_operators(sim_astro, dtype, time_them=False)
    assert len(rows) == 3 * 3 + 3 * 2


def test_step_launches_every_kernel(sim):
    from knpemi_tpu_torch import ops

    ops.reset_launch_counts()
    state, it_e, it_k, ok = sim.run(sim.init_state(), 1)
    assert ok.all()
    counts = ops.launch_counts()
    assert all(counts[k] for k in counts if k.split()[0] in
               ("K1", "K2", "K3", "K4", "K9", "K10"))


def test_per_ion_step_launches_k11_and_k3_only_for_the_mass_term(sim_astro):
    from knpemi_tpu_torch import ops

    ops.reset_launch_counts()
    state, it_e, it_k, ok = sim_astro.run(sim_astro.init_state(), 2)
    assert ok.all()
    counts = ops.launch_counts()
    assert counts["K11 knp_apply"] > 0
    assert counts["K3 knp_apply_batch"] == 2 * 3  # steps x subdomains
    assert all(bool(torch.isfinite(v).all()) for v in state.c.values())


def test_k11_raises_on_a_cuda_tensor_it_does_not_take(sim_astro):
    """On the card the wrapper launches or raises: no path to K3 or to the
    plain version."""
    from knpemi_tpu_torch.ops import assembly as A

    s = sim_astro.knp_sys.sub[1]
    x = torch.ones(s["n_dofs"], device="cuda")
    w = torch.zeros(s["n_cells"], 3, device="cuda")
    with pytest.raises(TypeError):
        A.knp_apply(x, s["cells"].long(), s["grads"], s["vols"], w, 10.0, 1.0, 0.0)
    with pytest.raises(ValueError):
        A.knp_apply(x, s["cells"], s["grads"], s["vols"], w.cpu(), 10.0, 1.0, 0.0)
    before = A.knp_apply.launches
    A.knp_apply(x, s["cells"], s["grads"], s["vols"], w, 10.0, 1.0, 0.0)
    assert A.knp_apply.launches == before + 1


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
