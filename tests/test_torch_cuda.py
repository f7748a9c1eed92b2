"""Each Hopper kernel against its plain version, on a CUDA device.

Skipped where there is no CUDA device (the CPU test machines); on the
GPU run ``python -m pytest tests/test_torch_cuda.py -q``.  Tolerances:
the kernels sum with atomics, in another order than the plain versions:
1e-5 max|y| in float32, 1e-12 max|y| in float64.
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernels_match_plain_on_cuda(sim, sim_banded, dtype):
    """All eleven: the six assembly kernels at the mesh's shapes, the five
    multigrid kernels at the shapes of the banded hierarchies' level 0
    (float32 and float64 vectors, and a bfloat16 slab for K7/K8)."""
    import chip_smoke

    rows = chip_smoke.check_kernels(sim, dtype, time_them=False)
    assert len(rows) == 6
    rows = chip_smoke.check_mg_kernels(sim_banded, dtype, time_them=False)
    assert {r["name"].split()[0] for r in rows} == {"K5", "K6a", "K6b", "K7", "K8"}


def test_step_launches_every_kernel(sim):
    from knpemi_tpu_torch import ops

    ops.reset_launch_counts()
    state, it_e, it_k, ok = sim.run(sim.init_state(), 1)
    assert ok.all()
    counts = ops.launch_counts()
    assert all(counts[k] for k in counts if k.split()[0] in
               ("K1", "K2", "K3", "K4", "K9", "K10"))


def test_banded_step_launches_the_multigrid_kernels(sim_banded):
    from knpemi_tpu_torch import ops

    ops.reset_launch_counts()
    state, it_e, it_k, ok = sim_banded.run(sim_banded.init_state(), 1)
    assert ok.all()
    counts = ops.launch_counts()
    assert counts["K7 banded_matvec"] and counts["K8 banded_matvec_batch"]
