"""The multigrid restriction (K5, K6b) as a gather from the transposed form.

All on the CPU, at small sizes, inputs made from a seed with numpy.  A
windowed-ELL layout of a transfer P uploads, once per hierarchy, the CSR
of P^T (``ops/ell.py::transposed_csr``), and the restriction wrappers
read that form only:

(a) the form is scipy's A^T exactly (row pointers, entries, their order
    within a row: ascending row of A) for every case of
    ``test_torch_mg_banded.ELL_CASES``, far entries included, with the
    lanes per row that ``lanes_per_row`` gives its mean row length;
(b) ``MGHierarchy.device`` uploads it for every layout the cycle
    restricts through, and a layout used only as P^T keeps no other
    form; the cycle is the same with P and P^T in one layout or two;
(c) ``DeviceMG.tensors()`` lists it, and a refresh (``refill_arrays`` +
    ``install``) leaves it bitwise unchanged at the same ``data_ptr()``;
(d) the wrappers refuse a layout without it and allocate their output
    with ``torch.empty``; the CUDA source sums with no atomics.

The plain K5/K6b against JAX ``interpret=True`` (float32) and scipy
(float64) are ``test_torch_mg_banded.py::test_ellw_plain_*[*ATr*]``.
"""

import ast
import copy
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from knpemi_tpu_torch.ops import assembly as TA
from knpemi_tpu_torch.ops import ell as TE
from knpemi_tpu_torch.solvers import mg as tmg

from test_torch_mg_banded import ELL_CASES, close, spd_banded

PORT = Path(__file__).resolve().parents[1] / "knpemi_tpu_torch"


# ---------------------------------------------------------------------------
# (a) the host form
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", list(ELL_CASES))
def test_transposed_form_is_scipy_transpose(case):
    make, kw = ELL_CASES[case]
    A = make()
    host = TE.build_ellw(A, **kw)
    if case == "spill":
        assert host.far_cap > 0
    e = host.device(torch.float64, "cpu", transposed=True)
    assert e.slot_ptr is None
    At = A.T.tocsr()
    At.sort_indices()
    assert e.trow_ptr.dtype == torch.int32
    np.testing.assert_array_equal(e.trow_ptr.numpy(), At.indptr)
    np.testing.assert_array_equal(e.tcol.numpy(), At.indices)
    np.testing.assert_array_equal(e.tval.numpy(), At.data)
    assert e.tgroup == TE.lanes_per_row(A.nnz / A.shape[1])


@pytest.mark.parametrize("mean_row, lanes", [
    (0.0, 4), (1.0, 4), (12.9, 4), (24.0, 8), (30.4, 8), (64.0, 16), (200.0, 32),
    (5000.0, 32)])
def test_lanes_per_row_is_a_quarter_of_the_mean_row(mean_row, lanes):
    """About a quarter of the mean row as a power of two, within 4..32:
    the flagship's prolongator (rows of 30.4 entries) takes 8 lanes, the
    3-D res-2 one (12.9) takes 4."""
    assert TE.lanes_per_row(mean_row) == lanes
    assert lanes in TE.GROUPS


def test_transposed_build_refuses_more_than_int32_entries(monkeypatch):
    make, kw = ELL_CASES["tall"]
    cols, vals = TE.build_ellw(make(), **kw).to_ell()
    monkeypatch.setattr(TE, "_INDEX_LIMIT", int((vals != 0).sum()))
    with pytest.raises(ValueError):
        TE.transposed_csr(cols, vals, make().shape[1])


def test_value_refill_leaves_the_transposed_form_alone():
    """ELLW.refill_arrays carries a refreshed layout's sliced values, never
    the transposed form: a transfer is frozen."""
    make, kw = ELL_CASES["square"]
    A = make()
    host = TE.build_ellw(A, **kw)
    e = host.device(torch.float64, "cpu", sliced=True, transposed=True)
    new = TE.build_ellw(2.0 * A, force_shape=(host.C, host.K, host.Wr, host.G, host.far_cap))
    refilled = {id(t) for t, _ in new.refill_arrays(e)[0]}
    assert {id(e.scol), id(e.sval)} <= refilled
    assert not refilled & {id(e.trow_ptr), id(e.tcol), id(e.tval)}


# ---------------------------------------------------------------------------
# (b) the forms a hierarchy uploads
# ---------------------------------------------------------------------------
def _ellw_hierarchy(monkeypatch, separate_pt: bool = False):
    """A windowed-ELL hierarchy (banding refused) of an SPD banded matrix;
    with ``separate_pt`` every level's P^T is a layout of its own, as the
    build makes it where P is banded and P^T is not."""
    monkeypatch.setattr(tmg, "_csr_to_banded", lambda *a, **k: None)
    A = spd_banded()
    hier = tmg.build_hierarchy(A, coarse_max=80, banded=True)
    assert all(lv.pt_ellw is lv.p_ellw is not None for lv in hier.levels)
    if separate_pt:
        for lv in hier.levels:
            lv.pt_ellw = copy.deepcopy(lv.p_ellw)
    return A, hier


def _forms(e):
    assert not hasattr(e, "cols") and not hasattr(e, "vals")
    return (e.slot_ptr is not None, e.trow_ptr is not None)


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
@pytest.mark.parametrize("separate_pt", [False, True], ids=["shared", "pt_only"])
def test_hierarchy_uploads_the_forms_its_cycle_reads(monkeypatch, batched, separate_pt):
    """The sliced form (K4 on one vector, K6a on B) where a cycle applies a
    layout forward, the transposed form (K5/K6b) where it restricts
    through it, and no other form; a layout used only as P^T holds the
    transposed form alone.  A and AP are never restricted through.  One
    upload serves the single-vector and the batched cycle alike."""
    A, hier = _ellw_hierarchy(monkeypatch, separate_pt)
    dev = hier.device(torch.float64, "cpu")
    fwd = (True, False)
    for lv in dev.levels:
        for w in ("a", "ap"):
            if lv[w + "_ellw"] is not None:
                assert _forms(lv[w + "_ellw"]) == fwd
        if separate_pt:
            assert _forms(lv["p_ellw"]) == fwd
            assert _forms(lv["pt_ellw"]) == (False, True)
        else:
            assert lv["pt_ellw"] is lv["p_ellw"]
            assert _forms(lv["p_ellw"]) == (True, True)
    R = torch.as_tensor(np.random.default_rng(6).standard_normal((2, A.shape[0])))
    ident = lambda v: v  # unused: level 0 stores its operator
    y = dev.apply_batch(ident, R) if batched else dev.apply(ident, R[0])
    assert bool(torch.isfinite(y).all()) and y.shape == (R if batched else R[0]).shape


@pytest.mark.parametrize("batched", [False, True], ids=["apply", "apply_batch"])
def test_cycle_is_the_same_with_pt_in_a_layout_of_its_own(monkeypatch, batched):
    """One layout of P read both ways, or a second one read only
    transposed: the same V-cycle to 1e-14."""
    A, hier = _ellw_hierarchy(monkeypatch)
    shared = hier.device(torch.float64, "cpu")
    for lv in hier.levels:
        lv.pt_ellw = copy.deepcopy(lv.p_ellw)
    own = hier.device(torch.float64, "cpu")
    R = torch.as_tensor(np.random.default_rng(3).standard_normal((3, A.shape[0])))
    ident = lambda v: v  # unused: level 0 stores its operator
    if batched:
        close(own.apply_batch(ident, R), shared.apply_batch(ident, R), 1e-14)
    else:
        close(own.apply(ident, R[0]), shared.apply(ident, R[0]), 1e-14)


# ---------------------------------------------------------------------------
# (c) in place across a refresh
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
def test_refresh_keeps_the_transposed_form_bitwise_in_place(monkeypatch, batched):
    A, hier = _ellw_hierarchy(monkeypatch)
    dev = hier.device(torch.float64, "cpu")
    held = [t for lv in dev.levels for t in (lv["pt_ellw"].trow_ptr, lv["pt_ellw"].tcol,
                                            lv["pt_ellw"].tval)]
    listed = {id(t) for t in dev.tensors()}
    assert all(id(t) in listed for t in held)
    before = [(t.data_ptr(), t.clone()) for t in held]
    rng = np.random.default_rng(5)
    A_new = (A + sp.diags(0.2 * rng.random(A.shape[0]))).tocsr()
    pairs, stats = dev.refill_arrays(tmg.refresh_hierarchy(hier, A_new))
    assert not {id(t) for t, _ in pairs} & {id(t) for t in held}
    old_diag = dev.levels[0]["dinv"].clone()
    dev.install(pairs)
    assert not torch.equal(old_diag, dev.levels[0]["dinv"])  # the refresh did land
    for t, (ptr, copy_) in zip(held, before):
        assert t.data_ptr() == ptr and torch.equal(t, copy_)
    # the cycle of either kind runs on the refreshed forms
    R = torch.as_tensor(rng.standard_normal((2, A.shape[0])))
    ident = lambda v: v  # unused: level 0 stores its operator
    y = dev.apply_batch(ident, R) if batched else dev.apply(ident, R[0])
    assert bool(torch.isfinite(y).all())


# ---------------------------------------------------------------------------
# (d) the wrappers
# ---------------------------------------------------------------------------
def test_restriction_wrappers_check_their_form():
    make, kw = ELL_CASES["tall"]
    A = make()
    n, m = A.shape
    host = TE.build_ellw(A, **kw)
    e = host.device(torch.float64, "cpu", transposed=True)
    r = torch.ones(n, dtype=torch.float64)
    before = TE.ellw_rmatvec.launches, TE.ellw_rmatvec_batch.launches
    assert TE.ellw_rmatvec(e, r).shape == (m,)
    assert TE.ellw_rmatvec_batch(e, r[None].repeat(9, 1)).shape == (9, m)
    bare = host.device(torch.float64, "cpu", sliced=True)
    with pytest.raises(ValueError):
        TE.ellw_rmatvec(bare, r)
    with pytest.raises(ValueError):
        TE.ellw_rmatvec_batch(bare, r[None])
    with pytest.raises(ValueError):
        TE.ellw_rmatvec(e, r[:-1])
    with pytest.raises(ValueError):
        TE.ellw_rmatvec_batch(e, r)
    with pytest.raises(TypeError):
        TE.ellw_rmatvec(e, r.float())
    with pytest.raises(TypeError):
        TE.ellw_rmatvec(dataclasses.replace(e, trow_ptr=e.trow_ptr.long()), r)
    with pytest.raises(ValueError):
        TE.ellw_rmatvec(dataclasses.replace(e, tval=e.tval[:-1]), r)
    # the CPU takes the plain version: no launch counted
    assert (TE.ellw_rmatvec.launches, TE.ellw_rmatvec_batch.launches) == before


def test_restriction_has_no_atomics_and_no_memset():
    """K5/K6b allocate Y with torch.empty (no zeroing pass), reach their
    plain version only for a CPU tensor, and launch the CSR gather of
    mg.cu, whose source has no atomic add left."""
    src = (PORT / "ops" / "csrc" / "mg.cu").read_text()
    assert "atomicAdd" not in src and "ell_rmatvec_batch_kernel" not in src
    assert "csr_gather_batch_kernel<T, BB, G, ADD>" in src and "__shfl_down_sync" in src
    assert TA._SIGS["csr_gather_batch"][:2] == ("mg", "knp_csr_gather_batch")
    assert "ell_rmatvec" not in TA._SIGS and "ell_rmatvec_batch" not in TA._SIGS
    tree = ast.parse((PORT / "ops" / "ell.py").read_text())
    for name, arg in (("ellw_rmatvec", "r"), ("ellw_rmatvec_batch", "R")):
        fn = next(n for n in ast.walk(tree)
                  if isinstance(n, ast.FunctionDef) and n.name == name)
        calls = [ast.unparse(c.func) for c in ast.walk(fn) if isinstance(c, ast.Call)]
        assert "torch.empty" in calls and "torch.zeros" not in calls
        assert calls.count("A._launch") == 1
        guard = next(n for n in ast.walk(fn) if isinstance(n, ast.If)
                     and any(isinstance(c, ast.Call) and getattr(c.func, "id", "") ==
                             name + "_plain" for c in ast.walk(n)))
        assert ast.unparse(guard.test) == f"not {arg}.is_cuda"
