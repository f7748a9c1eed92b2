"""The plain reference agrees with the port on a tiny mesh in float64 on
the CPU, step by step from the same state (this test imports both; the
reference imports nothing of the port)."""

import json

import pytest
import torch

from perfbench import check, spec
from perfbench.reference.step import Reference
from perfbench.tests import tiny


@pytest.mark.parametrize("workload", ["astrocyte_n64.baseline", "box3d_l4.stim"])
def test_reference_matches_the_port(workload):
    from knpemi_tpu_torch.sim.stepper import SolverOptions

    torch.set_num_threads(2)
    c = spec.cell(workload, spec.benchmark())
    tiny.shrink(c)
    cfg, traffic = c["config"], c["traffic"]
    cfg["solver"] = dict(cfg["solver"], rtol_emi=1e-12, rtol_knp=1e-12, maxiter=5000)
    if traffic["stimulus"].get("source"):
        traffic["stimulus"]["source"]["delay"] = 0.0   # the source on from step 1
    sim = spec.load_module("scenarios", cfg["scenario"]).build(cfg, traffic, torch.float64, "cpu")
    ref = Reference(cfg, traffic, "cpu")
    num = check.Numbering(sim.geom, ref.geom)
    st = sim.init_state()
    # the reference's own initial state is the port's
    assert max(check.numbers(num.state(st, "cpu"), ref.initial_state()).values()) == 0.0
    rs = num.state(st, "cpu")
    for _ in range(3):
        st = sim.step(st)
        nb = check.numbers(num.state(st, "cpu"), ref.step(rs))
        assert max(nb.values()) < 1e-8, nb
        rs = num.state(st, "cpu")
