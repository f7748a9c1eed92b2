"""The port's native host toolkit (``knpemi_tpu_torch/utils/native.py``).

The Vanek aggregation sweep a multigrid build runs is the C++ one of
``utils/csrc/host_toolkit.cpp``, built by ``g++`` at first use.  It must
give the aggregates of its plain Python twin
(``solvers/mg.py::vanek_aggregate_plain``) and of the JAX package's
``vanek_aggregate`` on every graph: the level-0 strength graph of the
idealized res-1 EMI operator, seeded random graphs (asymmetric patterns
too) and graphs with empty and diagonal-only rows.  The sweep's phase 3
(leftovers as singletons) cannot be reached: a row that fails phase 1
has an aggregated neighbour, which phase 2 finds; the graphs are held
to all three sweeps all the same.  A build that cannot run raises with
the compiler's message: there is no fallback.
"""

import numpy as np
import pytest
import scipy.sparse as sp

from knpemi_tpu.solvers import mg as jmg
from knpemi_tpu_torch.solvers import mg as tmg
from knpemi_tpu_torch.utils import native


def _all_three(Af):
    (a, n), (ap, n_p), (aj, nj) = (tmg.vanek_aggregate(Af), tmg.vanek_aggregate_plain(Af),
                                   jmg.vanek_aggregate(Af))
    assert a.dtype == np.int64 and a.shape == (Af.shape[0],)
    assert n == n_p == nj
    np.testing.assert_array_equal(a, ap)
    np.testing.assert_array_equal(a, np.asarray(aj))
    return a, n


@pytest.fixture(scope="module")
def emi_strength_graph(tmp_path_factory):
    """Level 0 of the EMI hierarchy of the 3-D res-1 idealized case, as the
    build forms it: the t = 0 operator equilibrated, RCM-permuted and
    strength-filtered; the build itself with an empty cache."""
    from knpemi_tpu_torch.sim import build_idealized, stepper
    from knpemi_tpu_torch.sim.stepper import _global_rcm

    cache = tmp_path_factory.mktemp("cache")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(stepper, "CACHE_DIR", cache)
        mp.setattr(tmg, "CACHE_DIR", cache)
        sim = build_idealized(dim=3, resolution=1, device="cpu")
    A_hat, s, _ = sim._emi_setup_operator()
    A_hat, s, _ = _global_rcm(A_hat, s)
    return tmg.strength_filter(A_hat, sim.opts.mg_theta, B=1.0 / s), sim


def test_emi_strength_graph(emi_strength_graph):
    Af, sim = emi_strength_graph
    agg, nc = _all_three(Af)
    assert Af.shape[0] > 10_000 and 0 < nc < Af.shape[0] // 4
    assert (agg >= 0).all()
    # and the build timed its sweeps with the native one
    assert sim.setup_detail["emi_vanek_sweep"] > 0.0
    assert sim.setup_detail["knp_vanek_sweep"] > 0.0


@pytest.mark.parametrize("n,density,symmetric", [(50, 0.05, True), (400, 0.01, True),
                                                 (400, 0.004, False), (2000, 0.002, True),
                                                 (2000, 0.001, False)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_graphs(n, density, symmetric, seed):
    rng = np.random.default_rng(seed)
    A = sp.random(n, n, density=density, random_state=rng, format="csr")
    if symmetric:
        A = A + A.T
    # diagonal on all rows but a few; some rows emptied, some diagonal only
    diag = np.ones(n)
    diag[rng.choice(n, n // 20, replace=False)] = 0.0
    A = (A + sp.diags(diag)).tolil()
    for i in rng.choice(n, n // 25, replace=False):
        A.rows[i], A.data[i] = [], []
    for i in rng.choice(n, n // 25, replace=False):
        A.rows[i], A.data[i] = [i], [1.0]
    A = A.tocsr()
    agg, nc = _all_three(A)
    # empty rows are aggregated too: as roots of their own or taken by an
    # earlier root whose row holds them
    assert (np.diff(A.indptr) == 0).any() and (agg >= 0).all()


def test_graph_whose_rows_need_phase_two():
    """A path 0-1-2-3-4 (with diagonals): 0 roots {0, 1}, 2 fails phase 1
    (1 is taken) and roots nothing, 3 roots {2, 3, 4}.  Then edges 0-1,
    1-2, 1-3, 3-4, 4-5: 0 roots {0, 1}; 2 and 3 fail phase 1; 4 roots
    {3, 4, 5}; phase 2 attaches 2 to its neighbour 1's aggregate."""
    path = sp.diags([np.ones(4), np.ones(5), np.ones(4)], [-1, 0, 1], format="csr")
    agg, nc = _all_three(path)
    assert nc == 2 and agg.tolist() == [0, 0, 1, 1, 1]
    edges = [(0, 1), (1, 2), (1, 3), (3, 4), (4, 5)]
    r, c = zip(*(edges + [(b, a) for a, b in edges] + [(i, i) for i in range(6)]))
    g = sp.csr_matrix((np.ones(len(r)), (r, c)), shape=(6, 6))
    agg, nc = _all_three(g)
    assert agg.tolist() == [0, 0, 0, 1, 1, 1] and nc == 2


def test_failed_build_raises_with_the_compiler_message(monkeypatch, tmp_path):
    A = sp.eye(4, format="csr")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="not found"):
        tmg.vanek_aggregate(A)
    assert not list(tmp_path.iterdir())
    # a compiler that refuses: its message is in the error, nothing is left
    monkeypatch.setattr(native, "CXX", "g++")
    monkeypatch.setattr(native, "CXX_FLAGS", (*native.CXX_FLAGS, "-fno-such-option"))
    with pytest.raises(RuntimeError, match="no-such-option"):
        tmg.vanek_aggregate(A)
    assert not list(tmp_path.iterdir())


def test_library_is_named_by_source_and_flags(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    path = native.build()
    assert path.parent == tmp_path and path.name.startswith("libhost_toolkit-")
    assert native.build() == path  # built once
    monkeypatch.setattr(native, "CXX_FLAGS", ("-O2", *native.CXX_FLAGS[1:]))
    assert native._target() != path
    agg, nc = native.vanek_aggregate(np.array([0, 1, 2], np.int64),
                                     np.array([0, 1], np.int32), 2)
    assert nc == 2 and agg.tolist() == [0, 1]


def test_hierarchy_is_built_with_the_native_sweep(monkeypatch):
    """build_hierarchy calls the native sweep and nothing else."""
    calls = []
    real = native.vanek_aggregate
    monkeypatch.setattr(native, "vanek_aggregate",
                        lambda *a: calls.append(a[2]) or real(*a))
    monkeypatch.setattr(tmg, "vanek_aggregate_plain",
                        lambda *a: pytest.fail("the plain sweep ran in a build"))
    n = 40
    L = sp.diags([-np.ones(n * n - 1), 4.0 * np.ones(n * n), -np.ones(n * n - 1)],
                 [-1, 0, 1], format="csr")
    hier = tmg.build_hierarchy(L + 1e-3 * sp.eye(n * n), coarse_max=50)
    assert calls and calls[0] == n * n and len(hier.levels) >= 1
