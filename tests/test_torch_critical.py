"""Watchdog-safe cache writes, and the t = 0 EMI assembly cache.

``knpemi_tpu_torch/utils/critical.py`` is the JAX package's
``utils/critical.py``: nesting, and a multigrid cache entry whose write
is interrupted by a watchdog's SIGALRM (the handler defers while a
critical section is open) lands whole, after which the timeout still
raises (``tests/test_mg_cache.py``'s two checks, on the port's
``build_hierarchy_cached``).

``Simulation._assemble_emi_cached``: a first build writes the entry, a
second reads it (``setup_detail["emi_assembly_cache"]``), and the CSR
read back is bitwise the fresh assembly; the cached build's hierarchy
arrays and first step are bitwise the fresh build's; a corrupt entry is
assembled afresh and replaced; another conductivity keys another entry;
an alarm during the entry's write is deferred too.
"""

import os
import pickle
import signal
import time

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from knpemi_tpu_torch.sim import SolverOptions, build_idealized, stepper
from knpemi_tpu_torch.solvers import direct
from knpemi_tpu_torch.solvers import mg
from knpemi_tpu_torch.utils.critical import critical_section, in_critical_section


def _laplacian_2d(n=40):
    T = sp.diags([-np.ones(n - 1), 2 * np.ones(n), -np.ones(n - 1)], [-1, 0, 1])
    return (sp.kron(sp.eye(n), T) + sp.kron(T, sp.eye(n)) + 1e-3 * sp.eye(n * n)).tocsr()


def test_critical_section_nesting():
    assert not in_critical_section()
    with critical_section():
        assert in_critical_section()
        with critical_section():
            assert in_critical_section()
        assert in_critical_section()
    assert not in_critical_section()
    with pytest.raises(KeyError):
        with critical_section():
            raise KeyError("inside")
    assert not in_critical_section()


def _watchdog(dump_name, module, monkeypatch):
    """A SIGALRM handler that defers inside a critical section, and a slow
    ``module.<dump_name>`` that arms the alarm from inside the write."""
    deferred = []

    def handler(signum, frame):
        if in_critical_section():
            deferred.append(1)
            signal.setitimer(signal.ITIMER_REAL, 0.02)
            return
        raise TimeoutError("watchdog")

    real = getattr(module, dump_name)

    def slow(*a, **kw):
        assert in_critical_section()
        signal.setitimer(signal.ITIMER_REAL, 0.02)
        time.sleep(0.15)  # several deferrals land here
        return real(*a, **kw)

    monkeypatch.setattr(module, dump_name, slow)
    return handler, deferred


def test_cache_write_survives_watchdog_timeout(tmp_path, monkeypatch):
    A = _laplacian_2d()
    handler, deferred = _watchdog("dump", pickle, monkeypatch)
    old = signal.signal(signal.SIGALRM, handler)
    try:
        with pytest.raises(TimeoutError):
            mg.build_hierarchy_cached(A, cache_dir=tmp_path)
            time.sleep(0.1)  # the re-armed alarm lands here
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)
    monkeypatch.undo()
    assert deferred, "the alarm should have been deferred at least once"
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".pkl")
    # the entry written is a valid hit
    h = mg.build_hierarchy_cached(A, cache_dir=tmp_path)
    assert h.levels
    assert os.listdir(tmp_path) == files


@pytest.fixture
def cache(tmp_path, monkeypatch):
    monkeypatch.setattr(stepper, "CACHE_DIR", tmp_path)
    monkeypatch.setattr(mg, "CACHE_DIR", tmp_path)
    return tmp_path


def _build():
    # a small mg_coarse_max gives the 2-D res-1 hierarchies real levels
    return build_idealized(dim=2, resolution=1, g_syn_bar=10.0, device="cpu",
                           solver_options=SolverOptions(mg_coarse_max=100))


def _kappa0(sim):
    from knpemi_tpu_torch.systems.coupling import set_initial_conditions

    c0 = set_initial_conditions(sim.geom, sim.ions, dtype=torch.float64, device="cpu")
    return {t: v.numpy() for t, v in sim.emi_sys.kappa(c0).items()}


def _csr_equal(a, b):
    return (a.shape == b.shape and a.dtype == b.dtype
            and all(np.array_equal(x, y) and x.dtype == y.dtype
                    for x, y in ((a.data, b.data), (a.indices, b.indices),
                                 (a.indptr, b.indptr))))


def _mg_tensors(sim):
    return [t for m in (sim.emi_solver.mg, *sim.knp_solver.mg.values())
            for t in (*m.tensors(), m.fine_diag)]


def test_emi_assembly_cache_round_trip(cache):
    fresh = _build()
    assert fresh.setup_detail["emi_assembly_cache"] == "miss"
    entries = sorted(p.name for p in cache.glob("emi_*.npz"))
    assert len(entries) == 1 and fresh.emi_cache_entry.name == entries[0]
    cached = _build()
    assert cached.setup_detail["emi_assembly_cache"] == "hit"
    assert fresh.setup_detail["emi_assembly"] >= 0 and cached.setup_detail["emi_assembly"] >= 0
    # the CSR read back is bitwise the fresh assembly
    kappa = _kappa0(cached)
    A_fresh = direct.assemble_emi_csr(cached.geom, cached.params, kappa)
    A_hit = cached._assemble_emi_cached(kappa)
    assert cached.setup_detail["emi_assembly_cache"] == "hit"
    assert _csr_equal(A_hit, A_fresh)
    # hierarchy arrays and the first step: bitwise
    assert len(fresh._emi_hier.levels) >= 1
    ta, tb = _mg_tensors(fresh), _mg_tensors(cached)
    assert len(ta) == len(tb) and all(torch.equal(a, b) for a, b in zip(ta, tb))
    sa, sb = fresh.step(fresh.init_state()), cached.step(cached.init_state())
    for f in ("phi", "phi_M", "c", "ode_states"):
        for k, v in getattr(sa, f).items():
            assert torch.equal(v, getattr(sb, f)[k]), f
    assert int(sa.emi_iters) == int(sb.emi_iters) and int(sa.knp_iters) == int(sb.knp_iters)


def test_corrupt_entry_is_rebuilt(cache):
    first = _build()
    entry = first.emi_cache_entry
    good = entry.read_bytes()
    entry.write_bytes(good[: len(good) // 3])  # torn
    again = _build()
    assert again.setup_detail["emi_assembly_cache"] == "miss"
    assert entry.read_bytes() == good  # replaced by a whole entry
    assert _build().setup_detail["emi_assembly_cache"] == "hit"
    entry.write_bytes(b"not an npz at all")
    assert _build().setup_detail["emi_assembly_cache"] == "miss"
    assert not list(cache.glob("*.tmp*"))


def test_other_conductivity_keys_another_entry(cache):
    sim = _build()
    kappa = _kappa0(sim)
    A = sim._assemble_emi_cached(kappa)
    assert sim.setup_detail["emi_assembly_cache"] == "hit"
    other = {t: 1.5 * v for t, v in kappa.items()}
    B = sim._assemble_emi_cached(other)
    assert sim.setup_detail["emi_assembly_cache"] == "miss"
    assert len(list(cache.glob("emi_*.npz"))) == 2
    assert not _csr_equal(A, B)
    assert _csr_equal(B, direct.assemble_emi_csr(sim.geom, sim.params, other))


def test_refresh_assembles_afresh(cache, monkeypatch):
    """The refresh path never reads the cache."""
    sim = _build()
    monkeypatch.setattr(type(sim), "_assemble_emi_cached",
                        lambda self, kappa: pytest.fail("the refresh read the cache"))
    sim.refresh_mg(sim.step(sim.init_state()))
    assert sim.refresh_counts["installed"] == 1


def test_emi_entry_write_survives_watchdog_timeout(cache, monkeypatch):
    handler, deferred = _watchdog("savez", np, monkeypatch)
    old = signal.signal(signal.SIGALRM, handler)
    try:
        with pytest.raises(TimeoutError):
            _build()
            time.sleep(0.1)
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)
    monkeypatch.undo()
    assert deferred
    entries = list(cache.glob("emi_*.npz"))
    assert len(entries) == 1 and not list(cache.glob("*.tmp*"))
    with np.load(entries[0]) as z:
        assert {"data", "indices", "indptr", "shape"} <= set(z.files)
