"""The multi-device modes' host partition against the JAX package's, on
the host alone (no ranks).

For N = 1, 2, 4 ranks and three scenarios (the 2-D and 3-D res-1 cases
and the astrocyte tissue at ``mesh_n`` 10), array for array:
``partition_subdomain`` (B, H, hops, the cells, gradients and volumes of
each rank), the sharded multigrid layout (``local_layout_gids``,
``permute_operator``, ``rcm_block_perm``, ``_device_row_split``) and the
host arrays of ``shard_hierarchy`` on the EMI hierarchy built on the
permuted operator (slabs, window starts, hops, far rows, columns and
values, smoother diagonals and steps, coarse factors).  Also: each rank's
local P1 operator (``parallel/sharded.py::RowBlock``, its owned rows with
every cell that touches them, in its window numbering) has exactly the
global operator's rows, pattern and values (scipy).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from knpemi_tpu.parallel import sharded as J
from knpemi_tpu.parallel import sharded_mg as JMG
from knpemi_tpu_torch.parallel import sharded as T
from knpemi_tpu_torch.parallel import sharded_mg as TMG
from knpemi_tpu_torch.sim import ASTROCYTE_BASELINE, SolverOptions, build_astrocyte, build_idealized
from knpemi_tpu_torch.systems.coupling import set_initial_conditions

CASES = ("2d", "3d", "tissue")
NS = (1, 2, 4)


@pytest.fixture(scope="module")
def sims():
    opts = SolverOptions(direct=True)  # no single-device hierarchy: not needed here
    out = {
        "2d": build_idealized(dim=2, resolution=1, device="cpu", solver_options=opts),
        "3d": build_idealized(dim=3, resolution=1, device="cpu", solver_options=opts),
        "tissue": build_astrocyte({**ASTROCYTE_BASELINE, "mesh_n": 10}, device="cpu",
                                  solver_options=opts),
    }
    ops = {}
    for k, sim in out.items():
        c0 = set_initial_conditions(sim.geom, sim.ions, dtype=torch.float64, device="cpu")
        kappa = {t: v.numpy() for t, v in sim.emi_sys.kappa(c0).items()}
        ops[k] = sim._assemble_emi_cached(kappa)
    return out, ops


@pytest.mark.parametrize("n_dev", NS)
@pytest.mark.parametrize("case", CASES)
def test_partition_subdomain_equals_jax(sims, case, n_dev):
    sim = sims[0][case]
    for t, sub in sim.geom.subdomains.items():
        fsrc = sim.knp_sys._src_vec[t]
        a = T.partition_subdomain(sub, n_dev)
        b = J.partition_subdomain(sub, n_dev)
        for f in ("tag", "n_dofs", "B", "H", "n_hops"):
            assert getattr(a, f) == getattr(b, f), (t, f)
        # what the set-up reads of it, without the per-rank arrays
        blk = T.subdomain_blocks(np.asarray(sub.cells), sub.n_dofs, n_dev)
        assert (blk.n_dofs, blk.B, blk.H, blk.n_hops) == (b.n_dofs, b.B, b.H, b.n_hops)
        for f in ("cells", "grads", "vols"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        # the rank partition of the port: ragged owned rows of B, and the
        # cells of each rank's rows inside its two-sided window of whole blocks
        parts = T.tag_partition(np.asarray(sub.cells), sub.n_dofs, n_dev)
        assert sum(info.own for info, _ in parts) == sub.n_dofs
        for d, (info, ids) in enumerate(parts):
            assert info.B == b.B and info.r0 == min(d * b.B, sub.n_dofs)
            assert max(info.hop_lo, info.hop_hi) <= b.n_hops
            lc = np.asarray(sub.cells)[ids]
            assert lc.min() >= info.base and lc.max() < info.base + info.n_win
        assert fsrc is None or fsrc.shape[1] == sub.n_dofs


@pytest.mark.parametrize("n_dev", NS)
@pytest.mark.parametrize("case", CASES)
def test_sharded_layout_equals_jax(sims, case, n_dev):
    sim, A0 = sims[0][case], sims[1][case]
    tags = sim.geom.sub_tags
    parts = {t: T.partition_subdomain(s, n_dev) for t, s in sim.geom.subdomains.items()}
    g_t, L256_t, L_t = TMG.local_layout_gids(parts, tags, n_dev)
    g_j, L256_j, L_j = JMG.local_layout_gids(parts, tags, n_dev)
    np.testing.assert_array_equal(g_t, g_j)
    assert (L256_t, L_t) == (L256_j, L_j)
    Pt, Pj = TMG.permute_operator(A0, g_t), JMG.permute_operator(A0, g_j)
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(Pt, f), getattr(Pj, f))
    np.testing.assert_array_equal(TMG.rcm_block_perm(Pt, n_dev, L256_t),
                                  JMG.rcm_block_perm(Pj, n_dev, L256_j))
    for n in (1, 255, 256, 257, A0.shape[0]):
        assert TMG._device_row_split(n, n_dev) == JMG._device_row_split(n, n_dev)


def _eq(a, b, what):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=what)


@pytest.mark.parametrize("n_dev", NS)
@pytest.mark.parametrize("case", CASES)
def test_shard_hierarchy_equals_jax(sims, case, n_dev):
    sim, A0 = sims[0][case], sims[1][case]
    tags = sim.geom.sub_tags
    parts = {t: T.partition_subdomain(s, n_dev) for t, s in sim.geom.subdomains.items()}
    gids, L256, _ = TMG.local_layout_gids(parts, tags, n_dev)
    opts = SolverOptions(mg_coarse_max=100)
    data, meta, _, _, hier = TMG.build_local(A0, gids, L256, n_dev, opts, np.float64)
    jd, jm = JMG.shard_hierarchy(hier, n_dev, jnp.float64)
    assert meta.n_coarse == jm.n_coarse and meta.nu == jm.nu
    assert len(data["levels"]) == len(jd["levels"]) >= 1
    for key, mine, theirs, mm, tm in (("levels", data["levels"], jd["levels"], meta.levels,
                                       jm.levels),
                                      ("p", data["p"], jd["p"], meta.p_meta, jm.p_meta),
                                      ("pt", data["pt"], jd["pt"], meta.pt_meta, jm.pt_meta)):
        for i, (a, b, am, bm) in enumerate(zip(mine, theirs, mm, tm)):
            where = f"{key}[{i}]"
            assert (am.n, am.Bd, am.Bc, am.f_max) == (bm.n, bm.Bd, bm.Bc, bm.f_max), where
            for wa, wb, ma, mb in zip(a["wins"], b["wins"], am.wins, bm.wins):
                assert (ma.W, ma.NBloc, ma.hop_lo, ma.hop_hi) == (mb.W, mb.NBloc, mb.hop_lo,
                                                                  mb.hop_hi), where
                _eq(np.stack(wa["slabT"]), wb["slabT"], where + " slabT")
                _eq(wa["w0"], wb["w0"], where + " w0")
            for f in ("rows", "cols_rep", "vals"):
                _eq(a["far"][f], b["far"][f], where + " far " + f)
            if key == "levels":
                _eq(a["dinv"], b["dinv"], where + " dinv")
                _eq(a["steps"], b["steps"], where + " steps")
    _eq(data["coarse"]["V"], jd["coarse"]["V"], "coarse V")
    _eq(data["coarse"]["ilam"], jd["coarse"]["ilam"], "coarse ilam")


@pytest.mark.parametrize("n_dev", NS)
@pytest.mark.parametrize("case", CASES)
def test_rank_operator_rows_equal_the_global_rows(sims, case, n_dev):
    """Each rank's local P1 operator: its owned rows are the global
    operator's rows (pattern and values, scipy), shifted by its window."""
    sim = sims[0][case]
    for t, sub in sim.geom.subdomains.items():
        gop = sim.emi_sys.sub[t]["op"]
        kst = sim.emi_sys.sub[t]["kst"]
        G = gop.scipy_csr(kst)
        cells = np.asarray(sub.cells)
        for info, ids in T.tag_partition(cells, sub.n_dofs, n_dev):
            blk = T.RowBlock(cells[ids] - info.base, info.r0, info.r1, info.base, info.n_win,
                             torch.float64, "cpu", sub.grads[ids], sub.vols[ids], maps=False)
            vals = T.place_row_values(blk.op, T.csr_row_values(gop, kst, info.r0, info.r1),
                                      torch.float64, "cpu")
            L = blk.op.scipy_csr(vals)
            mine = L[blk.lo:blk.hi]
            ref = G[info.r0:info.r1][:, info.base:info.base + info.n_win]
            assert (mine != ref).nnz == 0
            np.testing.assert_array_equal(mine.indices, ref.tocsr().indices)
            # rows outside the owned range have no slots
            assert L[:blk.lo].nnz == 0 and L[blk.hi:].nnz == 0


def test_a_level_without_a_band_raises(sims):
    """The distributed V-cycle needs every level banded: a hierarchy with
    one level that is not raises, naming the level."""
    sim, A0 = sims[0]["2d"], sims[1]["2d"]
    parts = {t: T.partition_subdomain(s, 4) for t, s in sim.geom.subdomains.items()}
    gids, L256, _ = TMG.local_layout_gids(parts, sim.geom.sub_tags, 4)
    _, _, _, _, hier = TMG.build_local(A0, gids, L256, 4, SolverOptions(mg_coarse_max=100),
                                       np.float64)
    hier.levels[-1].p_band = None
    with pytest.raises(ValueError, match=f"level {len(hier.levels) - 1} .* no banded layout"):
        TMG.shard_hierarchy(hier, 4)
