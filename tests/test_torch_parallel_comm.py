"""Ranks, transport and the device rule of the multi-device modes
(``parallel/comm.py``), on gloo ranks on the CPU.

* each collective of ``Comm`` on three ranks: the sum, the ragged
  gather, the neighbour exchange, the object scatter, counted by site;
* ``nccl`` with more ranks than cards raises before any process starts,
  as does ``nccl`` on the CPU (the device rule of ``launch``, ``Comm``
  and both simulations: ``tests/test_torch_hygiene.py``);
* a failing rank makes ``launch`` raise, naming the rank and carrying
  its traceback, and a launch past its deadline raises, both in time;
* ``import knpemi_tpu_torch.parallel`` loads no JAX and starts nothing.
"""

import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from knpemi_tpu_torch.parallel import launch, programs
from knpemi_tpu_torch.parallel.comm import check_launch

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def selftest():
    return launch(programs.comm_selftest, 3, "gloo", "cpu", threads=1, deadline=120)


def test_all_reduce_and_ragged_gather(selftest):
    for r in selftest:
        assert r["sum"] == [3.0, 3.0]
        assert r["gather"] == [0.0, 10.0, 11.0, 20.0, 21.0, 22.0]


def test_neighbour_exchange_and_object_scatter(selftest):
    blocks = {0: [0.0], 1: [10.0, 11.0], 2: [20.0, 21.0, 22.0]}
    for d, r in enumerate(selftest):
        assert r["exchange"] == {e: blocks[e] for e in (d - 1, d + 1) if 0 <= e < 3}
        assert r["scatter"] == f"to {d}"
        c = r["counts"]
        assert c["sum"]["calls"] == 1 and c["sum"]["bytes"] == 8  # two float32
        assert c["halo"]["bytes"] == 8 * (d + 1) * len(r["exchange"])
        assert all(v["staged"] == 0 for v in c.values())  # CPU tensors: nothing staged


def test_nccl_needs_a_card_per_rank(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="one card per rank"):
        launch(programs.wait, 2, "nccl", "cuda", args=(0,))
    assert check_launch(1, "nccl", "cuda") == torch.device("cuda")
    assert check_launch(4, "gloo", "cuda") == torch.device("cuda")
    with pytest.raises(ValueError, match="nccl needs CUDA"):
        check_launch(1, "nccl", "cpu")


def test_failing_rank_raises_naming_it():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"rank 1 of 2 failed(.|\n)*deliberate failure"):
        launch(programs.fail_on, 2, "gloo", "cpu", args=(1,), threads=1, deadline=60)
    assert time.monotonic() - t0 < 60


def test_launch_deadline():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="deadline"):
        launch(programs.wait, 2, "gloo", "cpu", args=(120,), threads=1, deadline=8)
    assert time.monotonic() - t0 < 30


def test_import_loads_no_jax_and_starts_nothing():
    code = ("import sys, knpemi_tpu_torch.parallel as p, torch.distributed as d\n"
            "print(any(m == 'jax' or m.startswith('jax.') or m == 'knpemi_tpu' "
            "or m.startswith('knpemi_tpu.') for m in sys.modules), d.is_initialized())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout.strip()
    assert out == "False False"
