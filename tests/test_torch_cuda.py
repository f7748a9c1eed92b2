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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernels_match_plain_on_cuda(sim, dtype):
    import chip_smoke

    rows = chip_smoke.check_kernels(sim, dtype, time_them=False)
    assert len(rows) == 6


def test_step_launches_every_kernel(sim):
    from knpemi_tpu_torch.ops import assembly as A

    A.reset_launch_counts()
    state, it_e, it_k, ok = sim.run(sim.init_state(), 1)
    assert ok.all()
    assert all(A.launch_counts().values())
