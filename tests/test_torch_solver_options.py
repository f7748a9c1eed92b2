"""The port's ``SolverOptions`` against the JAX package's, and the helpers
behind them.

* The port's ``SolverOptions`` has every field of the JAX package's with
  its default (``mg_banded`` and ``mg_band_bf16`` default to the port's
  False, which None also means); its only extra field is ``knp_batched``;
  an invalid value raises ``ValueError`` at construction.
* Options whose path is not the multigrid cycle, for two steps of the
  2-D res-1 scenario in float64 against the JAX package's XLA path
  (``use_pallas=False``, ``mg_banded=False``, ``mg_coarse_max=100`` so
  that the hierarchies have levels): ``direct=True`` (host LU, no
  hierarchy), ``emi_precond='jacobi'`` (the deflated Jacobi CG, no
  hierarchy; the KNP GMRES unpreconditioned) and
  ``compensated_dots=True`` (dot2 / bdot2, which in float64 are the
  plain dots); the port per ion and ion-batched: equal iteration counts,
  phi_M and the concentrations within 1e-10.  The multigrid options:
  ``tests/test_torch_mg_options.py``.
* ``compensated_dots``: None means dot2 for float32 and the plain dot
  for float64; True and False force it.
* ``mg.py``'s ``_cheb_steps``, ``_cast_band_dtype`` and ``_evict_lru``
  against the JAX package's on the same input (the cache in
  ``tmp_path``), and the cache never serving float32 slabs to a float64
  build.
"""

import dataclasses
import os
from functools import lru_cache
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

from knpemi_tpu_torch.sim import SolverOptions, build_idealized
from knpemi_tpu_torch.solvers import mg as tmg
from knpemi_tpu_torch.solvers.precision import dot2

from test_torch_slice import jax_simulation, run_jax, run_port

N_STEPS = 2
TOL = 1e-10
BRANCHES = ["per_ion", "batched"]


def set_gamma(sim, gamma):
    """The cycle index on every built hierarchy of a simulation (either
    package's)."""
    sim.emi_solver.mg.gamma = gamma
    for m in sim.knp_solver.mg.values():
        m.gamma = gamma


@lru_cache(maxsize=None)
def option_runs(name, opts):
    """(JAX states, {branch: port states}) of N_STEPS steps with ``opts``
    (a tuple of items; ``gamma`` is set on the built hierarchies)."""
    opts = dict(opts)
    gamma = opts.pop("gamma", None)
    simJ = jax_simulation(jnp.float64, use_pallas=False, mg_coarse_max=100, **opts)
    if gamma:
        set_gamma(simJ, gamma)
    statesJ = run_jax(simJ, N_STEPS)
    statesT = {}
    for branch in BRANCHES:
        simT = build_idealized(dim=2, resolution=1, g_syn_bar=10.0, dtype=torch.float64,
                               device="cpu", solver_options=SolverOptions(
                                   mg_coarse_max=100, knp_batched=branch == "batched",
                                   **opts))
        if gamma:
            set_gamma(simT, gamma)
        statesT[branch] = run_port(simT, N_STEPS)
    return statesJ, statesT


def assert_option_step(name, opts, branch, step):
    statesJ, statesT = option_runs(name, tuple(sorted(opts.items())))
    sJ, sT = statesJ[step], statesT[branch][step]
    assert bool(sT.emi_ok) and bool(sT.knp_ok)
    assert (int(sT.emi_iters), int(sT.knp_iters)) == (int(sJ.emi_iters), int(sJ.knp_iters))
    for m in sJ.phi_M:
        np.testing.assert_allclose(sT.phi_M[m].numpy(), np.asarray(sJ.phi_M[m]),
                                   rtol=0, atol=TOL)
    for t in sJ.c:
        np.testing.assert_allclose(sT.c[t].numpy(), np.asarray(sJ.c[t]), rtol=TOL, atol=0)


CASES = {
    "direct": dict(direct=True),
    "emi_precond_jacobi": dict(emi_precond="jacobi"),
    "compensated_dots": dict(compensated_dots=True),
}


@pytest.mark.parametrize("step", range(N_STEPS))
@pytest.mark.parametrize("branch", BRANCHES)
@pytest.mark.parametrize("name", list(CASES))
def test_option_step_matches_jax_xla(name, branch, step):
    assert_option_step(name, CASES[name], branch, step)


def test_no_hierarchy_without_multigrid():
    """direct=True and emi_precond='jacobi' build no hierarchy (as the JAX
    package); the direct path's solves report 0 iterations, and
    ``run`` drives it."""
    for opts in (dict(direct=True), dict(emi_precond="jacobi")):
        sim = build_idealized(dim=2, resolution=1, g_syn_bar=10.0, dtype=torch.float64,
                              device="cpu", solver_options=SolverOptions(**opts))
        assert sim.emi_solver.mg is None and sim.knp_solver.mg == {}
        assert sim._emi_hier is None
        with pytest.raises(ValueError):
            sim.refresh_mg(sim.init_state())
    s, it_e, it_k, ok = sim.run(sim.init_state(), 2, save_every=1)
    assert ok.all() and int(s.step) == 2 and (it_e > 0).all()
    sim = build_idealized(dim=2, resolution=1, g_syn_bar=10.0, dtype=torch.float64,
                          device="cpu", solver_options=SolverOptions(
                              direct=True, mg_refresh_every=1))
    s, it_e, it_k, ok = sim.run(sim.init_state(), 2, save_every=1)
    assert ok.all() and list(it_e) == [0, 0] and list(it_k) == [0, 0]
    assert sim.refresh_counts == {"installed": 0, "skipped": 0}


# ---------------------------------------------------------------------------
# the options themselves
# ---------------------------------------------------------------------------
def test_fields_and_defaults_are_the_jax_package():
    from knpemi_tpu.sim import SolverOptions as JOpts

    jf = {f.name: f.default for f in dataclasses.fields(JOpts)}
    tf = {f.name: f.default for f in dataclasses.fields(SolverOptions)}
    assert set(tf) - set(jf) == {"knp_batched"}
    assert set(jf) <= set(tf)
    for name, default in jf.items():
        if name in ("mg_banded", "mg_band_bf16"):
            assert default is None and tf[name] is False
        else:
            assert tf[name] == default, name


@pytest.mark.parametrize("bad", [
    dict(emi_precond="amg"), dict(mg_smoother="sor"), dict(on_divergence="stop"),
    dict(mg_nu=0), dict(mg_degree=0), dict(maxiter=0), dict(mg_theta=-0.1)])
def test_invalid_option_raises(bad):
    with pytest.raises(ValueError):
        SolverOptions(**bad)


def test_none_means_the_port_default():
    """mg_banded=None and mg_band_bf16=None build the plain-ELL hierarchies
    of the defaults; mg_smoother='auto' is damped Jacobi."""
    sims = [build_idealized(dim=2, resolution=1, g_syn_bar=10.0, dtype=torch.float64,
                            device="cpu", solver_options=SolverOptions(
                                mg_coarse_max=100, **opts))
            for opts in (dict(mg_banded=None, mg_band_bf16=None), dict())]
    lays = [s.emi_solver.mg.layout() for s in sims]
    assert lays[0] == lays[1] and {lv["A"] for lv in lays[0]} == {"ell"}
    assert all(len(lv.steps) == 1 for lv in sims[0]._emi_hier.levels)
    assert SolverOptions(mg_smoother="auto").smoother == "jacobi"
    assert SolverOptions(mg_smoother="cheby").smoother == "cheby"


@pytest.mark.parametrize("comp", [None, True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_compensated_dots_choice(dtype, comp):
    sim = build_idealized(dim=2, resolution=1, g_syn_bar=10.0, dtype=dtype, device="cpu",
                          solver_options=SolverOptions(direct=True, compensated_dots=comp))
    on = (dtype == torch.float32) if comp is None else comp
    assert (sim.emi_solver.dot is dot2) == on
    assert (sim.knp_solver.dot is dot2) == on
    assert (sim.knp_solver.bdot is not None) == on


# ---------------------------------------------------------------------------
# mg.py helpers against the JAX package's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("degree", [1, 2, 3, 5])
def test_cheb_steps_match_jax(degree):
    from knpemi_tpu.solvers import mg as jmg

    for lam in (0.7, 1.9, 4.0):
        np.testing.assert_array_equal(tmg._cheb_steps(lam, degree),
                                      jmg._cheb_steps(lam, degree))


def _laplacian_2d(n):
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n))
    I = sp.identity(n)
    return (sp.kron(T, I) + sp.kron(I, T)).tocsr()


def test_cast_band_dtype_matches_jax():
    from knpemi_tpu.solvers import mg as jmg

    A = _laplacian_2d(48)
    kw = dict(theta=0.04, coarse_max=100, banded=True, smoother="jacobi")
    ht = tmg.build_hierarchy(A, **kw)
    hj = jmg.build_hierarchy(A, **kw)
    assert any(True for _ in tmg._bands(ht))
    ct, cj = tmg._cast_band_dtype(ht, np.float32), jmg._cast_band_dtype(hj, np.float32)
    for lt, lj in zip(ct.levels, cj.levels):
        for attr in ("a_band", "ap_band", "p_band", "pt_band"):
            bt, bj = getattr(lt, attr), getattr(lj, attr)
            assert (bt is None) == (bj is None)
            if bt is None:
                continue
            for (st, w0t, Wt), (sj, w0j, Wj) in zip(bt[0], bj[0]):
                assert st.dtype == sj.dtype == np.float32 and Wt == Wj
                np.testing.assert_array_equal(st, sj)
                np.testing.assert_array_equal(w0t, w0j)


def _fill_cache(d: Path, sizes):
    d.mkdir()
    for i, size in enumerate(sizes):
        p = d / f"entry{i}.pkl"
        p.write_bytes(b"x" * size)
        os.utime(p, (1000.0 + i, 1000.0 + i))
    (d / "notes.txt").write_bytes(b"y" * 4096)  # not an entry


@pytest.mark.parametrize("cap_kib,keep", [(10, None), (10, 1), (3, 0), (1, None), (100, None)])
def test_evict_lru_matches_jax(tmp_path, monkeypatch, cap_kib, keep):
    """The same entries survive the port's eviction (the cap passed as
    ``max_bytes``) and the JAX package's (``KNPEMI_MG_CACHE_MAX_GB``) of the
    same directory; a cap of 1 KiB leaves no entry."""
    from knpemi_tpu.solvers import mg as jmg

    sizes = [4096, 2048, 8192, 1024, 4096]
    dt, dj = tmp_path / "port", tmp_path / "jax"
    _fill_cache(dt, sizes)
    _fill_cache(dj, sizes)
    cap = cap_kib * 1024
    monkeypatch.setenv("KNPEMI_MG_CACHE_MAX_GB", repr(cap / (1 << 30)))
    kt = None if keep is None else str(dt / f"entry{keep}.pkl")
    kj = "" if keep is None else str(dj / f"entry{keep}.pkl")
    tmg._evict_lru(dt, keep=kt, max_bytes=cap)
    jmg._evict_lru(str(dj), keep=kj)
    left = lambda d: sorted(p.name for p in d.iterdir())
    assert left(dt) == left(dj)
    assert "notes.txt" in left(dt)


def test_cache_never_serves_float32_slabs_to_float64(tmp_path):
    A = _laplacian_2d(48)
    kw = dict(theta=0.04, coarse_max=100, banded=True)
    h32 = tmg.build_hierarchy_cached(A, cache_dir=tmp_path, slab_dtype=np.float32, **kw)
    h64 = tmg.build_hierarchy_cached(A, cache_dir=tmp_path, slab_dtype=np.float64, **kw)
    fresh64 = tmg.build_hierarchy(A, slab_dtype=np.float64, **kw)
    fresh32 = tmg.build_hierarchy(A, slab_dtype=np.float32, **kw)
    again32 = tmg.build_hierarchy_cached(A, cache_dir=tmp_path, slab_dtype=np.float32, **kw)
    assert len(list(tmp_path.glob("*.pkl"))) == 1  # one key for both dtypes
    for got, ref in ((h32, fresh32), (h64, fresh64), (again32, fresh32)):
        for (lg, ag), (lr, ar) in zip(tmg._bands(got), tmg._bands(ref)):
            for wg, wr in zip(getattr(lg, ag)[0], getattr(lr, ar)[0]):
                assert wg[0].dtype == wr[0].dtype
                np.testing.assert_array_equal(wg[0], wr[0])


def test_scatter_cells_is_the_scatter_add():
    """``P1Operator.scatter_cells`` (the solves' Jacobi diagonals without a
    hierarchy) sums each row's cell values as ``ops.kernels.scatter_add``
    does, one vector and a batch, to 1e-15 of max|y|."""
    from knpemi_tpu_torch.mesh import unit_cube_mms_mesh
    from knpemi_tpu_torch.ops import kernels as K
    from knpemi_tpu_torch.ops.geometry import build_geometry
    from knpemi_tpu_torch.ops.p1op import p1_operators

    geom = build_geometry(unit_cube_mms_mesh(4))
    gen = torch.Generator().manual_seed(2)
    for t, op in p1_operators(geom, "cpu").items():
        cells = op.cells.long()
        V = torch.randn(3, *cells.shape, generator=gen, dtype=torch.float64)
        got = op.scatter_cells(V)
        ref = torch.stack([K.scatter_add(op.n, cells, V[b]) for b in range(3)])
        assert got.shape == (3, op.n)
        assert float((got - ref).abs().max()) <= 1e-15 * float(ref.abs().max())
        assert torch.equal(op.scatter_cells(V[0]), got[0])
