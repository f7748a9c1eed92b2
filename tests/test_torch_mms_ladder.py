"""The port's reference-scale MMS ladder (``tools/run_mms_ladder.py`` of
the port) against the JAX package's recipe, on the CPU in float64.

The JAX side is rebuilt here from ``knpemi_tpu`` functions as the JAX
package's ``tools/run_mms_ladder.py`` builds it (that tool is not
imported: it sets JAX's platform at import).  Its systems take the MMS
data of the port's ``build_mms_data`` (numpy arrays, held to JAX's own
within 1e-12 by ``tests/test_torch_mms.py``), which spares JAX's
compiles of the sources for every mesh size:

* ``ladder_hierarchies`` at 2-D M = 8, 16 and 32 (the first with more
  than the coarse level): the same levels and level sizes, every level
  operator, prolongator, smoothing diagonal, the coarse inverse and the
  fine diagonals within 1e-12 relative;
* ``ladder_rung(..., iterative=True, device="cpu")`` at M = 8 and 16
  against the JAX iterative solves on those hierarchies: equal EMI and
  KNP iteration counts, the six errors within 1e-8 relative;
* the iterative rung within 1e-6 + 1e-3 e of the direct rung at M = 16;
* ``main`` at ``--Ms 4 8 --device cpu`` writes a readable
  ``ladder.json``, and ``--join`` of its rungs from files or from its
  log gives the same rates; without ``--device cpu`` and without a card the tool
  raises before it builds anything.
"""

import dataclasses
import json
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from knpemi_tpu_torch.mesh import unit_square_mms_mesh
from knpemi_tpu_torch.ops.geometry import build_geometry
from knpemi_tpu_torch.ops.p1op import membrane_operators, p1_operators
from knpemi_tpu_torch.systems import mms
from knpemi_tpu_torch.systems.coupling import set_initial_conditions
from knpemi_tpu_torch.systems.emi import emi_system
from knpemi_tpu_torch.systems.knp import knp_system
from knpemi_tpu_torch.tools import run_mms_ladder as ladder

FIELDS = ladder.FIELDS


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the Krylov solves are many small ops, which
    threads of several test processes on one host slow down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@lru_cache(maxsize=None)
def jax_ladder(M, cache_dir):
    """The JAX tool's iterative rung at M: (host hierarchies {"emi" | tag},
    fine diagonals, iterations (emi, knp), errors)."""
    from knpemi_tpu.mesh import unit_square_mms_mesh as jsquare
    from knpemi_tpu.ops.geometry import build_geometry as jgeom
    from knpemi_tpu.solvers import mg as jmg
    from knpemi_tpu.solvers.api import create_solver_emi, create_solver_knp
    from knpemi_tpu.solvers.direct import (
        _coo_accumulate, _mass_coo, _stiffness_coo, assemble_emi_csr,
    )
    from knpemi_tpu.systems import mms as jmms
    from knpemi_tpu.systems.coupling import set_initial_conditions as jsic
    from knpemi_tpu.systems.emi import EMIMMSData as JEMIMMSData
    from knpemi_tpu.systems.emi import emi_system as jemi
    from knpemi_tpu.systems.knp import KNPMMSData as JKNPMMSData
    from knpemi_tpu.systems.knp import knp_system as jknp

    geom = jgeom(jsquare(M))
    case = jmms.reference_mms_case(geom)
    _, _, ions_t, emi_t, knp_t = port_data(M)
    ions = case.ions
    for ion, ion_t in zip(ions, ions_t):
        ion.c_init = ion_t.c_init
    emi_data, knp_data = (
        cls(**{f.name: getattr(src, f.name) for f in dataclasses.fields(cls)})
        for cls, src in ((JEMIMMSData, emi_t), (JKNPMMSData, knp_t)))
    p = case.params
    esys = jemi(geom, ions, p, mms=emi_data)
    ksys = jknp(geom, ions, p, mms=knp_data)
    c0 = jsic(geom, ions)
    phiM0 = {m: jnp.zeros(s.n_dofs) for m, s in geom.membranes.items()}
    kw = dict(theta=0.04, banded=False, smoother="jacobi", cache_dir=cache_dir)
    # tools/run_mms_ladder.py:68-121 of the JAX package
    kappa0 = {t: np.asarray(v) for t, v in esys.kappa(c0).items()}
    A0 = assemble_emi_csr(esys, kappa0).tocsr()
    bc = esys.offsets[0] + np.asarray(esys.mms.dirichlet_dofs)
    msk = np.ones(A0.shape[0])
    msk[bc] = 0.0
    Dm = sp.diags(msk)
    A0 = (Dm @ A0 @ Dm + sp.diags(1.0 - msk)).tocsr()
    d0 = A0.diagonal()
    d0 = np.where(d0 != 0, d0, 1.0)
    s0 = 1.0 / np.sqrt(np.abs(d0))
    hosts, diags = {}, {"emi": d0}
    hosts["emi"] = jmg.build_hierarchy_cached(
        (sp.diags(s0) @ A0 @ sp.diags(s0)).tocsr(), B=1.0 / s0, **kw)
    emi_mg = hosts["emi"].device(jnp.float64)
    emi_mg.fine_diag = jnp.asarray(d0, jnp.float64)
    knp_mg = {}
    for t, sub in geom.subdomains.items():
        Dbar = float(np.mean([ion.D[t] for ion in ions[:-1]]))
        r1, c1, v1 = _mass_coo(sub.cells, sub.vols, 1.0 / p.dt)
        r2, c2, v2 = _stiffness_coo(sub.cells, sub.grads, sub.vols, coef_cell=Dbar)
        Ak = _coo_accumulate([r1, r2], [c1, c2], [v1, v2], sub.n_dofs)
        dk = Ak.diagonal()
        dk = np.where(dk != 0, dk, 1.0)
        sk = 1.0 / np.sqrt(np.abs(dk))
        hosts[t] = jmg.build_hierarchy_cached(
            (sp.diags(sk) @ Ak @ sp.diags(sk)).tocsr(), B=1.0 / sk, **kw)
        knp_mg[t] = hosts[t].device(jnp.float64)
        knp_mg[t].fine_diag = jnp.asarray(dk, jnp.float64)
        diags[t] = dk
    if M > 16:  # hierarchies only
        return hosts, diags, None, None
    es = create_solver_emi(esys, rtol=1e-10, maxiter=20000, mg=emi_mg)
    ks = create_solver_knp(ksys, rtol=1e-10, maxiter=20000, mg=knp_mg)
    # jitted: eagerly, each small op of the solves compiles on its own
    phi, ie = jax.jit(es.solve)(c0, phiM0)
    cK, ik = jax.jit(ks.solve)(c0, phi, phiM0)
    assert bool(ie.converged) and bool(ik.converged)
    errs = dict(
        phi_e=jmms.l2_error(geom, 0, phi[0], case.phi[0]),
        phi_i=jmms.l2_error(geom, 1, phi[1], case.phi[1]),
        a_e=jmms.l2_error(geom, 0, cK[0][0], case.conc[("a", 0)]),
        b_e=jmms.l2_error(geom, 0, cK[0][1], case.conc[("b", 0)]),
        a_i=jmms.l2_error(geom, 1, cK[1][0], case.conc[("a", 1)]),
        b_i=jmms.l2_error(geom, 1, cK[1][1], case.conc[("b", 1)]),
    )
    return hosts, diags, (int(ie.iters), int(ik.iters)), errs


@pytest.fixture(scope="module")
def jax_cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp("jax_mg_cache"))


@lru_cache(maxsize=None)
def port_data(M):
    """(geom, case, ions, EMI data, KNP data) of the port at M."""
    geom = build_geometry(unit_square_mms_mesh(M))
    case = mms.reference_mms_case(geom)
    return (geom, case) + mms.build_mms_data(geom, case)


def port_hierarchies(M):
    geom, case, ions, emi_data, knp_data = port_data(M)
    ops, mops = p1_operators(geom, "cpu"), membrane_operators(geom, "cpu")
    esys = emi_system(geom, ions, case.params, mms=emi_data, device="cpu",
                      p1ops=ops, memops=mops)
    ksys = knp_system(geom, ions, case.params, mms=knp_data, device="cpu",
                      p1ops=ops, memops=mops)
    c0 = set_initial_conditions(geom, ions, device="cpu")
    return ladder.ladder_hierarchies(geom, ions, case.params, esys, ksys, c0, "cpu",
                                     torch.float64)


def _coarse_inverse(h):
    return (h.coarse_V * h.coarse_ilam) @ h.coarse_V.T


@pytest.mark.parametrize("M", [8, 16, 32])
def test_ladder_hierarchies_match_jax(M, jax_cache):
    hJ, dJ, _, _ = jax_ladder(M, jax_cache)
    emi_mg, knp_mg, hT = port_hierarchies(M)
    assert set(hT) == set(hJ) == {"emi", 0, 1}
    fine = {"emi": emi_mg.fine_diag, **{t: knp_mg[t].fine_diag for t in knp_mg}}
    for key, hj in hJ.items():
        ht = hT[key]
        assert rel(fine[key].numpy(), dJ[key]) <= 1e-12, key
        assert [lv.n for lv in ht.levels] == [lv.n for lv in hj.levels], key
        assert ht.coarse_V.shape == hj.coarse_V.shape, key
        for i, (lt, lj) in enumerate(zip(ht.levels, hj.levels)):
            assert rel(lt.diag, lj.diag) <= 1e-12, (key, i)
            assert abs(lt.omega - lj.omega) <= 1e-12 * abs(lj.omega), (key, i)
            np.testing.assert_array_equal(lt.a_cols, lj.a_cols, err_msg=f"{key} {i}")
            assert rel(lt.a_vals, lj.a_vals) <= 1e-12, (key, i)
            Pt, Pj = lt.P_csr.tocsr(), lj.P_csr.tocsr()
            assert Pt.shape == Pj.shape and (abs(Pt - Pj)).max() <= 1e-12 * abs(Pj).max()
        assert rel(_coarse_inverse(ht), _coarse_inverse(hj)) <= 1e-12, key
    if M == 32:  # a level below the fine one in the EMI and ECS hierarchies
        assert len(hT["emi"].levels) >= 1 and len(hT[0].levels) >= 1


@pytest.mark.parametrize("M", [8, 16])
def test_iterative_rung_matches_jax(M, jax_cache):
    _, _, itJ, eJ = jax_ladder(M, jax_cache)
    rec = ladder.ladder_rung(M, iterative=True, device="cpu")
    assert rec["converged"] == dict(emi=True, knp=True)
    assert (rec["iters"]["emi"], rec["iters"]["knp"]) == itJ
    assert rec["dofs"] > 0 and rec["peak_device_bytes"] is None
    for f in FIELDS:
        assert abs(rec["errors"][f] - eJ[f]) <= 1e-8 * eJ[f], (f, rec["errors"][f], eJ[f])


def test_iterative_rung_matches_direct():
    e_it = ladder.ladder_rung(16, iterative=True, device="cpu")["errors"]
    e_dir = ladder.ladder_rung(16, iterative=False, device="cpu")["errors"]
    for f in FIELDS:
        assert abs(e_it[f] - e_dir[f]) < 1e-6 + 1e-3 * e_dir[f], (f, e_it[f], e_dir[f])


def test_main_writes_ladder_json(tmp_path, capsys):
    assert ladder.main(["--Ms", "4", "8", "--device", "cpu", "--min-rate", "0",
                        "--out", str(tmp_path)]) == 0
    out = json.loads((tmp_path / "ladder.json").read_text())
    assert [r["M"] for r in out["rungs"]] == [4, 8] and out["ok"]
    assert set(out["rates"]) == set(FIELDS)
    assert all(len(v) == 1 and np.isfinite(v[0]) for v in out["rates"].values())
    summ = json.loads((tmp_path / "summary.json").read_text())
    assert [r["M"] for r in summ["rungs"]] == [4, 8]
    # one JSON line a rung on stdout
    log = capsys.readouterr().out
    lines = [ln for ln in log.splitlines() if ln.startswith("{")]
    assert [json.loads(ln)["M"] for ln in lines] == [4, 8]
    # rungs of separate runs joined: the same rates
    a, b = tmp_path / "a", tmp_path / "b"
    for M, d in ((8, b), (4, a)):
        d.mkdir()
        (d / "ladder.json").write_text(json.dumps(dict(rungs=[
            r for r in out["rungs"] if r["M"] == M])))
    assert ladder.main(["--join", str(b / "ladder.json"), str(a / "ladder.json"),
                        "--min-rate", "0", "--out", str(tmp_path / "j")]) == 0
    joined = json.loads((tmp_path / "j" / "ladder.json").read_text())
    assert joined["rates"] == out["rates"]
    # ... or the rung lines of a run's log
    (tmp_path / "run.log").write_text(log)
    assert ladder.main(["--join", str(tmp_path / "run.log"), "--min-rate", "0",
                        "--out", str(tmp_path / "k")]) == 0
    assert json.loads((tmp_path / "k" / "ladder.json").read_text())["rates"] == out["rates"]


def test_without_a_card_the_tool_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    built = []
    monkeypatch.setattr(ladder, "build_geometry", lambda *a: built.append(a))
    with pytest.raises(RuntimeError, match="CUDA"):
        ladder.main(["--Ms", "4"])
    with pytest.raises(RuntimeError, match="CUDA"):
        ladder.ladder_rung(4)
    assert not built
