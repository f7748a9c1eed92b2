"""The hierarchy refresh of the port against the JAX package's.

All on the CPU in float64, inputs made from a seed with numpy.

* ``refresh_hierarchy``: the same new EMI operator (the setup operator's
  structure, concentrations perturbed) refreshes the same hierarchy in
  both packages, on 2-D and 3-D res 1, ELL and banded multigrid: every
  level's diagonal, smoother weight, ELL / windowed-ELL / band arrays
  and far lists within 1e-12 of their scale; the coarse inverse as
  V diag(1/lam) V^T (eigenvector signs are free).
* the drift guard: an operator whose sparsity drifted is refused with
  ``ValueError`` by both; a packed band window that has no slot for a
  refreshed nonzero drops it, counts it and refuses more than the guard.
* a stepped run: ``run(state, 6, save_every=2)`` with
  ``mg_refresh_every=2, mg_refresh_async=False`` against the JAX ``run``
  with the same options: equal iteration counts step for step, the
  observed fields within 1e-12 relative, two refreshes installed.
* the refill is in place (every ``DeviceMG`` tensor keeps its storage
  and shape), the async path installs and leaves no worker thread, and
  the astrocyte script's solver options are taken over.
"""

import threading

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

from knpemi_tpu.solvers import mg as jmg

from knpemi_tpu_torch.interop import hierarchy_to_numpy
from knpemi_tpu_torch.sim import SolverOptions, build_idealized
from knpemi_tpu_torch.solvers import mg as tmg

from test_torch_slice import jax_simulation

TOL = 1e-12
CASES = [(2, False), (2, True), (3, False), (3, True)]
IDS = ["2d_ell", "2d_banded", "3d_ell", "3d_banded"]


def port_sim(dim, banded, **opts):
    # a small coarse_max gives the 2-D hierarchies real levels
    cm = 100 if dim == 2 else 800
    return build_idealized(dim=dim, resolution=1, g_syn_bar=10.0, dtype=torch.float64,
                           device="cpu",
                           solver_options=SolverOptions(mg_coarse_max=cm, mg_banded=banded,
                                                        **opts))


def perturbed_c(sim):
    """The initial concentrations with [K] tripled in a box of the ECS and
    raised 5% in the cells: kappa moves by tens of percent there."""
    c = {t: v.numpy().copy() for t, v in sim.init_state().c.items()}
    coords = sim.geom.subdomains[0].coords
    lo, hi = coords.min(axis=0), coords.max(axis=0)
    mid = (lo + hi) / 2
    box = np.all((coords > mid) & (coords < mid + 0.3 * (hi - lo)), axis=1)
    c[0][0] *= np.where(box, 3.0, 1.0)
    for t in c:
        if t:
            c[t][0] *= 1.05
    return c


def assert_tree_close(a, b, path="hier"):
    """Same structure, shapes and dtypes; integer arrays equal, float arrays
    within TOL of the array's largest magnitude."""
    if a is None or b is None:
        assert a is None and b is None, path
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_tree_close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_tree_close(x, y, f"{path}[{i}]")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, path
        if np.issubdtype(b.dtype, np.floating):
            scale = float(np.abs(b).max()) if b.size else 0.0
            np.testing.assert_allclose(a, b, rtol=0, atol=TOL * max(scale, 1e-300),
                                       err_msg=path)
        else:
            np.testing.assert_array_equal(a, b, err_msg=path)


def coarse_inverse(h):
    return h["coarse_V"] * h["coarse_ilam"] @ h["coarse_V"].T


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def refreshed(request):
    """(port sim, JAX setup hierarchy, the new operator, both refreshes)."""
    dim, banded = request.param
    sim = port_sim(dim, banded)
    c0 = {t: v.numpy() for t, v in sim.init_state().c.items()}
    A_setup = sim._emi_operator(c0)
    s = 1.0 / np.sqrt(np.abs(sim._emi_diag0))[sim._emi_hier.perm]
    hj = jmg.build_hierarchy(A_setup, B=1.0 / s, theta=sim.opts.mg_theta,
                             coarse_max=sim.opts.mg_coarse_max, banded=banded,
                             smoother="jacobi", slab_dtype=np.float64)
    A_new = sim._emi_operator(perturbed_c(sim))
    return (sim, hj, A_new, tmg.refresh_hierarchy(sim._emi_hier, A_new),
            jmg.refresh_hierarchy(hj, A_new))


def test_refreshed_hierarchy_equals_jax(refreshed):
    sim, hj, A_new, rt, rj = refreshed
    assert len(rt.levels) >= 1
    if sim.opts.mg_banded:
        assert any(getattr(lv, w + "_band") is not None
                   for lv in rt.levels for w in ("a", "ap"))
    # the setup hierarchies are equal to begin with
    setup_t, setup_j = hierarchy_to_numpy(sim._emi_hier), hierarchy_to_numpy(hj)
    setup_t["perm"] = setup_j["perm"] = None
    assert_tree_close(setup_t, setup_j)
    nt, nj = hierarchy_to_numpy(rt), hierarchy_to_numpy(rj)
    assert_tree_close(nt["levels"], nj["levels"])
    assert_tree_close(coarse_inverse(nt), coarse_inverse(nj))
    # and the values did move
    assert not np.allclose(nt["levels"][0]["diag"], setup_t["levels"][0]["diag"])
    assert nt["perm"] is not None and np.array_equal(nt["perm"], sim._emi_hier.perm)


def test_drifted_sparsity_is_refused_by_both(refreshed):
    """A row that gains couplings to far columns of the size of its own
    entries: the frozen layouts cannot hold them."""
    sim, hj, A_new, _, _ = refreshed
    n = A_new.shape[0]
    r = n // 2
    cols = np.arange(0, n, max(1, n // 300))
    E = sp.csr_matrix((np.full(len(cols), float(A_new[r, r])), (np.full(len(cols), r), cols)),
                      shape=A_new.shape)
    A_bad = (A_new + E + E.T).tocsr()
    with pytest.raises(ValueError):
        jmg.refresh_hierarchy(hj, A_bad)
    with pytest.raises(ValueError):
        tmg.refresh_hierarchy(sim._emi_hier, A_bad)
    with pytest.raises(ValueError):
        tmg.refresh_hierarchy(sim._emi_hier, A_new[:-1, :-1].tocsr())


def test_refill_is_in_place(refreshed):
    """Every tensor of the device cycle keeps its storage and shape; the
    cycle then applies the refreshed hierarchy exactly as one uploaded
    from it."""
    sim, _, _, rt, _ = refreshed
    mg = sim.emi_solver.mg
    before = [(t.data_ptr(), tuple(t.shape), t.dtype) for t in mg.tensors()]
    old = [t.clone() for t in mg.tensors()]
    pairs, stats = mg.refill_arrays(rt)
    mg.install(pairs)
    after = [(t.data_ptr(), tuple(t.shape), t.dtype) for t in mg.tensors()]
    assert before == after and stats["band_dropped"] == 0
    assert any(not torch.equal(a, b) for a, b in zip(old, mg.tensors()))
    fresh = rt.device(torch.float64, "cpu")
    fresh.fine_diag = mg.fine_diag
    r = torch.as_tensor(np.random.default_rng(4).standard_normal(rt.levels[0].n))
    A0 = lambda v: v  # level 0 smooths with its own operator where it stores one
    assert torch.allclose(mg.apply(A0, r), fresh.apply(A0, r), rtol=0, atol=1e-13)


def test_packed_window_drift_is_dropped_counted_and_guarded():
    """A refreshed nonzero without a slot in a packed band window (float32
    kappa rounding can make one): a small one is dropped and counted, the
    cycle keeps every tensor in place; one above the guard is refused."""
    # tridiagonal, with one longer row far away: the ELL of level 0 has a
    # free slot in every row, the packed window of row 40's slice none
    A = sp.diags([-1.0, 2.05, -1.0], [-1, 0, 1], shape=(3000, 3000)).tolil()
    A[2000, 2010] = A[2010, 2000] = -0.01
    A = A.tocsr()
    ht = tmg.build_hierarchy(A, coarse_max=80, banded=True)
    assert ht.levels[0].a_band is not None
    dev = ht.device(torch.float32, "cpu")
    win = dev.levels[0]["a_band"]["windows"][0]
    # a row whose slice holds exactly its three nonzeros: a fourth has no slot
    r = 40
    assert int(win.slot_ptr_host[r // 32 + 1] - win.slot_ptr_host[r // 32]) == 3 * 32
    for size, raises in ((1e-9, False), (1.0, True)):
        E = sp.csr_matrix(([size], ([r], [r + 5])), shape=A.shape)
        new = tmg.refresh_hierarchy(ht, (A + E).tocsr())
        if raises:
            with pytest.raises(ValueError):
                dev.refill_arrays(new)
            continue
        ptrs = [t.data_ptr() for t in dev.tensors()]
        pairs, stats = dev.refill_arrays(new)
        dev.install(pairs)
        assert stats["band_dropped"] >= 1 and 0 < stats["band_dropped_frac"] <= 1e-5
        assert [t.data_ptr() for t in dev.tensors()] == ptrs


# ---------------------------------------------------------------------------
# Simulation.run with refreshes
# ---------------------------------------------------------------------------
def _observed(sim, n, **kw):
    seen = []
    out = sim.run(sim.init_state(), n, save_every=2, observer=seen.append, **kw)
    return out, seen


@pytest.fixture(scope="module")
def stepped():
    opts = dict(mg_coarse_max=100, mg_refresh_every=2, mg_refresh_async=False)
    simJ = jax_simulation(jnp.float64, use_pallas=False, **opts)
    (_, ejax, kjax), seenJ = _observed(simJ, 6)
    simT = build_idealized(dim=2, resolution=1, g_syn_bar=10.0, dtype=torch.float64,
                           device="cpu", solver_options=SolverOptions(**opts))
    (_, etor, ktor, ok), seenT = _observed(simT, 6)
    return simT, (ejax, kjax, seenJ), (etor, ktor, ok, seenT)


def test_refreshing_run_matches_jax_run(stepped):
    simT, (ejax, kjax, seenJ), (etor, ktor, ok, seenT) = stepped
    assert ok.all() and len(etor) == 6
    np.testing.assert_array_equal(etor, np.asarray(ejax))
    np.testing.assert_array_equal(ktor, np.asarray(kjax))
    # refreshes after steps 2 and 4, none after the last chunk
    assert simT.refresh_counts == {"installed": 2, "skipped": 0}
    assert len(seenT) == len(seenJ) == 3
    for sJ, sT in zip(seenJ, seenT):
        assert int(sT.step) == int(sJ.step) and sT.c[0].device.type == "cpu"
        for m in sJ.phi_M:
            ref = np.asarray(sJ.phi_M[m])
            np.testing.assert_allclose(sT.phi_M[m].numpy(), ref, rtol=0,
                                       atol=TOL * np.abs(ref).max())
        for t in sJ.c:
            np.testing.assert_allclose(sT.c[t].numpy(), np.asarray(sJ.c[t]),
                                       rtol=TOL, atol=0)


def test_refresh_changes_the_hierarchy_in_the_run(stepped):
    """The run's last installed refresh is the hierarchy of the state it
    was taken from, not the setup one."""
    simT = stepped[0]
    setup = port_sim(2, False)
    assert not np.array_equal(simT._emi_hier.levels[0].diag,
                              setup._emi_hier.levels[0].diag)
    assert [tuple(t.shape) for t in simT.emi_solver.mg.tensors()] == \
        [tuple(t.shape) for t in setup.emi_solver.mg.tensors()]


@pytest.mark.parametrize("banded", [False, True], ids=["ell", "banded"])
def test_async_refresh_installs_and_stops_its_worker(banded):
    sim = port_sim(2, banded, mg_refresh_every=2)
    assert sim.opts.mg_refresh_async
    state, it_e, it_k, ok = sim.run(sim.init_state(), 6, save_every=2)
    assert ok.all() and int(state.step) == 6
    assert sim.refresh_counts["installed"] >= 1 and sim.refresh_counts["skipped"] == 0
    assert not any(t.name.startswith("mg-refresh") for t in threading.enumerate())
    assert sim._refresh_pool is None and sim._refresh_future is None


def test_astrocyte_script_options_are_accepted():
    """The solver options of the JAX astrocyte script
    (``examples/astrocyte/run_stim_duration.py``) build the port's (its
    scenario's default cadence of 100 steps: tests/test_torch_tissue.py)."""
    o = SolverOptions(mg_refresh_every=100, mg_refresh_async=False)
    assert (o.mg_refresh_every, o.mg_refresh_async) == (100, False)
    assert SolverOptions().mg_refresh_every == 0 and SolverOptions().mg_refresh_async
