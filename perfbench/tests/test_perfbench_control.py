"""The control (the reference with each phase's output stored in
bfloat16, the precision below the configurations' float32) fails the
limits at a size a test run holds, where the program passes them."""

import pytest
import torch

from perfbench import check, spec
from perfbench.control import readings
from perfbench.tests import tiny


@pytest.mark.parametrize("workload", ["astrocyte_n64.baseline", "box3d_l4.stim"])
def test_control_fails_the_limits(workload):
    torch.set_num_threads(2)
    limits = spec.cell(workload, spec.benchmark())["limits"]
    recs = readings(workload, [2 ** 31 + 11], 1, 20, device="cpu",
                    config_override=tiny.shrink, emit=lambda s: None)
    prog, ctrl = recs[0]["worst_program"], recs[0]["least_control"]
    assert all(prog[k] <= limits[k] for k in check.NUMBERS), prog
    assert any(ctrl[k] > limits[k] for k in check.NUMBERS), ctrl
    assert recs[0]["program_correct"] and not recs[0]["control_correct"]
