"""``chip_smoke.py`` as a module: what can be said of it without a card.

The script needs a CUDA device to run.  Here it is only imported: the
import must touch neither ``torch`` nor the port, the flagship is fixed
at its full width (no argument makes it smaller), and ``main`` refuses
to run without CUDA.
"""

import inspect
import sys

import chip_smoke


def test_flagship_is_fixed_at_full_width():
    assert (chip_smoke.MESH_N, chip_smoke.FLAGSHIP_DOFS) == (64, 840_015)
    assert list(inspect.signature(chip_smoke.flagship).parameters) == [
        "build_astrocyte", "baseline", "SolverOptions"]


def test_every_kernel_has_a_source_and_a_tpu_origin():
    assert len(chip_smoke.KERNEL_SOURCES) == 14
    # K11f fills the drift of both KNP branches; K11 is the per-ion one's
    assert set(chip_smoke.BATCHED_PATH) == set(chip_smoke.KERNEL_SOURCES) - {"K11"}
    assert "K11f" in chip_smoke.ASSEMBLY
    assert set(chip_smoke.CELL_KERNELS) < set(chip_smoke.ASSEMBLY)


def test_main_refuses_without_cuda(capsys):
    assert chip_smoke.main() == 1
    out = capsys.readouterr()
    assert out.out == "" and "CUDA is not available" in out.err
