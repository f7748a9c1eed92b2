"""A run with the timed path broken underneath comes out not correct;
the unbroken run at the same tiny size comes out correct.  Faults: a step
that returns its state unchanged; half of the ion batch left out of the
KNP solve; an answer (the EMI potential) altered where it is produced.
(One card: no exchange between chips to leave out.)  On a card, the
same faults at each cell's own size (``-m cuda``)."""

import dataclasses
import subprocess
import sys
import time

import pytest
import torch

from perfbench import bench, spec
from perfbench.tests import tiny

CELLS = ["astrocyte_n64.baseline", "box3d_l4.stim"]


def unchanged(sim):
    orig = sim.step

    def step(state, *a, **kw):
        new = orig(state, *a, **kw)
        return dataclasses.replace(state, t=new.t, step=new.step, emi_iters=new.emi_iters,
                                   knp_iters=new.knp_iters, emi_ok=new.emi_ok,
                                   knp_ok=new.knp_ok)
    sim.step = step


def half_batch(sim):
    orig = sim.knp_solver.solve

    def solve(c, *a, **kw):
        out, info = orig(c, *a, **kw)
        for t, x in out.items():
            x[x.shape[0] // 2:] = c[t][x.shape[0] // 2: x.shape[0]]
        return out, info
    sim.knp_solver.solve = solve


def altered(sim):
    orig = sim.emi_solver.solve

    def solve(*a, **kw):
        phi, info = orig(*a, **kw)
        tag = max(phi)
        phi[tag] = phi[tag] * (1.0 + 1e-3)
        return phi, info
    sim.emi_solver.solve = solve


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    r = tiny.run(workload)
    assert r["correct"], r["compared"]
    assert r["attempted"] > 0 and r["failed"] == 0


@pytest.mark.parametrize("fault", [unchanged, half_batch, altered])
@pytest.mark.parametrize("workload", CELLS)
def test_broken_run_is_not_correct(workload, fault):
    r = tiny.run(workload, break_step=fault)
    assert not r["correct"], r["compared"]
    assert r["failed"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_faults_at_full_size(workload):
    """Each fault, planted in the program at the cell's own size on the
    card, through a run's own comparison: ``correct`` false."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for i, fault in enumerate((unchanged, half_batch, altered)):
        r = bench.run(workload, 2 ** 31 + 101 + i, 6.0, False, time.time(), break_step=fault)
        print(f"fault {fault.__name__}: correct {r['correct']}, failed {r['failed']} of "
              f"{r['attempted']}, compared {r['compared']}", flush=True)
        assert not r["correct"], (fault.__name__, r["compared"])


def test_no_card_no_result(tmp_path):
    """Without a card the command exits non-zero and prints no result; so
    it does in a directory holding only BENCHMARK.json and perfbench/."""
    import shutil

    for cwd in (spec.ROOT, tmp_path):
        if cwd == tmp_path:
            shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
            shutil.copytree(spec.ROOT / "perfbench", tmp_path / "perfbench",
                            ignore=shutil.ignore_patterns("__pycache__"))
        out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                              "box3d_l4.stim", "--seed", str(2 ** 31 + 5), "--seconds", "1",
                              "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                             timeout=300)
        assert out.returncode != 0
        assert "{" not in out.stdout
