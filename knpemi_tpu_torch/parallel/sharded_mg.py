"""The distributed V-cycle of the dof-sharded mode.

Counterpart of ``knpemi_tpu/parallel/sharded_mg.py``.  The replicated
hierarchy (``parallel/sharded.py::_GatheredMG``) gathers the residual and
holds the whole hierarchy on every rank; here the V-cycle itself runs on
the ranks' blocks:

* **Row order = the sharded layout** (host, JAX ``:56-118``).  The
  hierarchy is built on the operator permuted into the solver's local
  layout ``[rank 0: tag blocks of B_t, padding][rank 1: ...]``, each
  rank's segment padded to a multiple of 256 (:func:`local_layout_gids`,
  :func:`permute_operator`; padding rows are identity), then reordered by
  a reverse Cuthill-McKee within each rank's rows
  (:func:`rcm_block_perm`), so that contiguous 256-row blocks of every
  level belong to one rank and its banded windows stay narrow.  The build
  is the port's ``build_hierarchy_cached(..., banded=True)`` with the JAX
  package's sharded slab budgets.
* **Each level's banded windows split by row block** (host, JAX
  ``:160-325``): :func:`shard_hierarchy` gives, per window, each rank's
  dense slab rows (views of the host slab), its window starts re-based
  on the rank's haloed input buffer and the window's hop counts, and of
  the far remainder the replicated column list with each rank's rows
  and values.  Its arrays equal the JAX package's array for array.  A
  level without a banded layout raises: the mode has no other form
  (``distributed_mg=False`` gives the replicated hierarchy).
* **Device side** (JAX ``:331-536``): each rank's row block of a window
  is a ``PackedWindow`` (``ops/banded.py``) on its haloed buffer, applied
  by K7 (K8 for the ion batch); the buffer is the rank's block with
  ``hop_lo`` blocks below and ``hop_hi`` above, fetched from the
  neighbours (:func:`exchange`, zeros beyond the first and last rank;
  one exchange for all windows of an operator).  The far remainder's
  columns ride the same exchange (each owner sends the columns a rank's
  entries read; the JAX package gathers every far column with a masked
  sum) and are added by the ``ADD`` form of K5/K6b (``ell.csr_add``)
  from a ``DeviceCSR`` of the rank's far entries; there is no atomic far
  sum.
  The coarsest dense solve runs on an ``all_gather``ed vector.

The cycle is the JAX package's sharded one (``ShardedMG._cycle``):
``nu`` sweeps of the level's Richardson steps before and after the
coarse correction, each post-smoothing sweep on the operator (no fused
``A P`` form), and no post-smoothing for a V(1,0) KNP hierarchy.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import scipy.sparse as sp
import torch

from ..ops import banded as band_ops
from ..ops import ell as ell_ops
from ..ops.assembly import index_dtype

R_BLOCK = 256  # row-block granularity of the block-banded layouts
# the slab budgets of the sharded build: the host slabs are split into
# per-rank row blocks, so the single-device budgets do not apply (the
# JAX package's values, sharded.py:990)
BAND_CAP = 4096 << 20
TBAND_CAP = 2048 << 20


# ---------------------------------------------------------------------------
# host: the permuted operator
# ---------------------------------------------------------------------------
def local_layout_gids(parts, tags, n_dev: int):
    """Global dof id of every entry of the concatenated local layout
    ``[rank: tag blocks of B_t + padding]``, -1 on padding; each rank's
    segment padded to a multiple of R_BLOCK.  Returns (gids, L256, L),
    L the unpadded per-rank length (the sum of the B_t)."""
    offs_g = {}
    off = 0
    for t in tags:
        offs_g[t] = off
        off += parts[t].n_dofs
    L = sum(parts[t].B for t in tags)
    L256 = -(-L // R_BLOCK) * R_BLOCK
    segs = []
    for d in range(n_dev):
        for t in tags:
            p = parts[t]
            i = d * p.B + np.arange(p.B)
            segs.append(np.where(i < p.n_dofs, offs_g[t] + i, -1))
        if L256 > L:
            segs.append(np.full(L256 - L, -1, np.int64))
    return np.concatenate(segs).astype(np.int64), L256, L


def permute_operator(A: sp.csr_matrix, gids: np.ndarray) -> sp.csr_matrix:
    """A_perm[l1, l2] = A[gids[l1], gids[l2]]; padding rows identity.  The
    JAX package's result (sorted indices, the product's zeros dropped),
    with the padding diagonals inserted into their empty rows directly
    instead of through a LIL matrix."""
    n_pad = len(gids)
    real = gids >= 0
    rows = np.flatnonzero(real)
    S = sp.csr_matrix((np.ones(len(rows)), (rows, gids[rows])), shape=(n_pad, A.shape[0]))
    P = (S @ A @ S.T).tocsr()
    P.sort_indices()
    pad = np.flatnonzero(~real)
    count = np.diff(P.indptr)
    count[pad] += 1
    indptr = np.zeros(n_pad + 1, np.int64)
    np.cumsum(count, out=indptr[1:])
    # a padding row is empty in P: its one entry goes at its row's start
    at = P.indptr[pad]
    indices = np.insert(P.indices.astype(np.int64), at, pad)
    data = np.insert(P.data, at, 1.0)
    return sp.csr_matrix((data, indices, indptr), shape=(n_pad, n_pad))


def rcm_block_perm(A_perm: sp.csr_matrix, n_dev: int, Bd: int) -> np.ndarray:
    """Per-rank reverse Cuthill-McKee order of the local diagonal blocks:
    MG slot i holds solver-layout row perm[i], a bijection of each rank's
    ``[d*Bd, (d+1)*Bd)``.  (The solver layout puts the tags side by side,
    so the EMI membrane coupling would widen every banded window; the
    cross-rank couplings land in the far remainder.)"""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    perm = np.empty(n_dev * Bd, np.int64)
    for d in range(n_dev):
        blk = A_perm[d * Bd:(d + 1) * Bd, d * Bd:(d + 1) * Bd].tocsr()
        p = np.asarray(reverse_cuthill_mckee(blk, symmetric_mode=True))
        perm[d * Bd:(d + 1) * Bd] = d * Bd + p
    return perm


# ---------------------------------------------------------------------------
# host: shard a banded hierarchy
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class WinMeta:
    W: int
    NBloc: int
    hop_lo: int
    hop_hi: int


@dataclasses.dataclass
class OpMeta:
    n: int  # true row count
    Bd: int  # output rows per rank (a multiple of R_BLOCK)
    Bc: int  # input block per rank
    wins: List[WinMeta]
    f_max: int  # far entries (all ranks')


@dataclasses.dataclass
class SMGMeta:
    levels: List[OpMeta]
    p_meta: List[OpMeta]
    pt_meta: List[OpMeta]
    k_steps: List[int]
    nu: int
    n_coarse: int


def _device_row_split(n: int, n_dev: int) -> int:
    """Rows per rank: whole R_BLOCK row blocks, equal across ranks."""
    nb = -(-n // R_BLOCK)
    nb_d = -(-nb // n_dev)
    return nb_d * R_BLOCK


def _shard_band(band, Bd: int, Bc: int, n_dev: int, dtype=np.float64):
    """Split a host banded layout by row block (JAX ``_shard_band``).
    Returns (data, metas, f_max): per window ``slabT`` (a list of each
    rank's (NBloc*W, R) rows: views of the host slab, zero rows past its
    last block) and ``w0`` (n_dev, NBloc) re-based on the rank's haloed
    buffer ``[d*Bc - hop_lo*Bc, (d+1)*Bc + hop_hi*Bc)``; the far
    remainder as ``cols_rep`` (every far entry's global column, the same
    on every rank) with ``rows`` / ``vals`` (n_dev, f) each rank's own
    entries (local row, value), 0 elsewhere."""
    windows, fr, fc, fv, n, m = band
    NBloc = Bd // R_BLOCK
    data = {"wins": [], "far": None}
    metas = []
    for slabT, w0, W in windows:
        R = slabT.shape[1]
        if R != R_BLOCK:
            raise ValueError(f"a window of {R}-row blocks: {R_BLOCK} needed")
        NB = len(w0)
        slabs = []
        w0_d = np.zeros((n_dev, NBloc), np.int64)
        hop_lo = hop_hi = 0
        for d in range(n_dev):
            b0, b1 = d * NBloc, min((d + 1) * NBloc, NB)
            nb = max(b1 - b0, 0)
            s = slabT[b0 * W:b1 * W] if nb else slabT[:0]
            if nb < NBloc:
                s = np.concatenate([s, np.zeros(((NBloc - nb) * W, R), slabT.dtype)])
            slabs.append(s.astype(dtype, copy=False))
            w0_d[d, :nb] = w0[b0:b1]
            # a block past the last reads the buffer start: a zero slab
            w0_d[d, nb:] = d * Bc
            lo = int(w0_d[d].min())
            hi = int(w0_d[d].max()) + W
            hop_lo = max(hop_lo, -(-(d * Bc - lo) // Bc) if lo < d * Bc else 0)
            need_hi = hi - (d + 1) * Bc
            hop_hi = max(hop_hi, -(-need_hi // Bc) if need_hi > 0 else 0)
        hop_lo = min(hop_lo, n_dev - 1)
        hop_hi = min(hop_hi, n_dev - 1)
        for d in range(n_dev):
            w0_d[d] -= d * Bc - hop_lo * Bc
        if w0_d.min() < 0:
            raise ValueError("a window starts before its rank's haloed buffer")
        data["wins"].append(dict(slabT=slabs, w0=w0_d.astype(np.int32)))
        metas.append(WinMeta(W=int(W), NBloc=NBloc, hop_lo=hop_lo, hop_hi=hop_hi))
    f_max = len(fr)
    frl = np.zeros((n_dev, max(f_max, 1)), np.int32)
    fvl = np.zeros((n_dev, max(f_max, 1)), np.float64)
    fc_rep = np.zeros(max(f_max, 1), np.int32)
    if f_max:
        owner = fr // Bd
        fc_rep[:] = fc
        for d in range(n_dev):
            own = owner == d
            frl[d, own] = fr[own] - d * Bd
            fvl[d, own] = fv[own]
    data["far"] = dict(rows=frl, cols_rep=fc_rep, vals=fvl.astype(dtype))
    return data, metas, f_max


def shard_hierarchy(hier, n_dev: int, dtype=np.float64):
    """A host ``MGHierarchy`` built on the permuted operator -> (data,
    meta): per level the sharded operator (:func:`_shard_band`) with
    ``dinv`` (n_dev, Bd) and ``steps`` (n_dev, k), the sharded transfers,
    and the coarsest dense factors.  Every level operator and transfer
    must have a banded layout: ``ValueError`` names the first that has
    none."""
    if not hier.levels:
        raise ValueError("the hierarchy has no levels (the problem is below "
                         "coarse_max); use the replicated hierarchy")
    data = {"levels": [], "p": [], "pt": [], "coarse": None}
    sizes = [lv.n for lv in hier.levels]
    n_coarse = hier.levels[-1].P_csr.shape[1]
    sizes.append(n_coarse)
    Bds = [_device_row_split(nn, n_dev) for nn in sizes]
    lvl_meta, p_meta, pt_meta, k_steps = [], [], [], []
    for i, lv in enumerate(hier.levels):
        for w in ("a", "p", "pt"):
            if getattr(lv, w + "_band") is None:
                raise ValueError(f"level {i} of {len(hier.levels)} (n = {lv.n}) has no "
                                 f"banded layout of {'A' if w == 'a' else w.upper()}: "
                                 "the distributed V-cycle needs every one banded")
        Bd = Bds[i]
        a_data, a_wins, a_fmax = _shard_band(lv.a_band, Bd, Bd, n_dev, dtype)
        dinv = 1.0 / lv.diag
        dinv_d = np.zeros((n_dev, Bd))
        for d in range(n_dev):
            seg = dinv[d * Bd:(d + 1) * Bd]
            dinv_d[d, :len(seg)] = seg
        steps = lv.steps if lv.steps is not None else np.array([lv.omega])
        a_data["dinv"] = dinv_d.astype(dtype)
        a_data["steps"] = np.tile(steps, (n_dev, 1)).astype(dtype)
        data["levels"].append(a_data)
        lvl_meta.append(OpMeta(n=lv.n, Bd=Bd, Bc=Bd, wins=a_wins, f_max=a_fmax))
        k_steps.append(len(steps))
        pt_data, pt_wins, pt_fmax = _shard_band(lv.pt_band, Bds[i + 1], Bd, n_dev, dtype)
        data["pt"].append(pt_data)
        pt_meta.append(OpMeta(n=sizes[i + 1], Bd=Bds[i + 1], Bc=Bd, wins=pt_wins,
                              f_max=pt_fmax))
        p_data, p_wins, p_fmax = _shard_band(lv.p_band, Bd, Bds[i + 1], n_dev, dtype)
        data["p"].append(p_data)
        p_meta.append(OpMeta(n=lv.n, Bd=Bd, Bc=Bds[i + 1], wins=p_wins, f_max=p_fmax))
    data["coarse"] = dict(V=np.asarray(hier.coarse_V, dtype),
                          ilam=np.asarray(hier.coarse_ilam, dtype))
    meta = SMGMeta(levels=lvl_meta, p_meta=p_meta, pt_meta=pt_meta, k_steps=k_steps,
                   nu=hier.nu, n_coarse=n_coarse)
    return data, meta


def _far_needs(f, d: int):
    """Rank d's far entries (their positions in the column list, value 0
    where another rank owns the row) and the sorted global columns they
    read."""
    own = np.flatnonzero(f["vals"][d] != 0)
    return own, np.unique(f["cols_rep"][own].astype(np.int64))


def _rank_op(op_data, meta: OpMeta, d: int, dtype):
    """Rank d's part of a sharded operator in the form its device side
    reads: each window packed (``ops/banded.py::pack_window``, on the
    host); the rank's far entries as a CSR by row (``ell.far_csr``) over
    the columns they read, with what the neighbour exchange moves for
    them: the columns the rank owns (``local``), those it receives from
    each owner (``recv``) and what it sends each rank that reads its
    block (``send``).  (The JAX package gathers every far column on every
    device with a masked sum; a rank reads only its own entries' columns,
    so they ride the halo exchange.)"""
    wins = [band_ops.pack_window(w["slabT"][d], w["w0"][d], wm.W, dtype, "cpu")
            for w, wm in zip(op_data["wins"], meta.wins)]
    far = None
    if meta.f_max:
        f, Bc, N = op_data["far"], meta.Bc, op_data["far"]["vals"].shape[0]
        own, need = _far_needs(f, d)
        owner = need // Bc
        far = dict(n_need=len(need), csr=None,
                   local=(np.flatnonzero(owner == d), need[owner == d] - d * Bc),
                   recv={int(e): np.flatnonzero(owner == e) for e in np.unique(owner)
                         if e != d},
                   send={})
        for e in range(N):
            if e != d:
                ne = _far_needs(f, e)[1]
                mine = ne[ne // Bc == d]
                if len(mine):
                    far["send"][e] = mine - d * Bc
        if len(own):
            # an entry's column: its global column's place in ``need``
            col = np.searchsorted(need, f["cols_rep"][own])
            far["csr"] = ell_ops.far_csr(f["rows"][d][own], col, f["vals"][d][own],
                                         meta.Bd, len(own))
    return dict(wins=wins, far=far)


def rank_hierarchy(data, meta: SMGMeta, d: int, torch_dtype) -> dict:
    """Rank d's share of :func:`shard_hierarchy`'s output, host-side and
    picklable (packed windows on the CPU): what :class:`ShardedMG` uploads."""
    dt = {torch.float32: np.float32, torch.float64: np.float64}[torch_dtype]
    out = dict(meta=meta, levels=[], p=[], pt=[],
               coarse_V=data["coarse"]["V"], coarse_ilam=data["coarse"]["ilam"])
    for i, lm in enumerate(meta.levels):
        lv = data["levels"][i]
        r = _rank_op(lv, lm, d, torch_dtype)
        r["dinv"] = lv["dinv"][d].astype(dt)
        r["steps"] = lv["steps"][d].astype(dt)
        out["levels"].append(r)
        out["p"].append(_rank_op(data["p"][i], meta.p_meta[i], d, torch_dtype))
        out["pt"].append(_rank_op(data["pt"][i], meta.pt_meta[i], d, torch_dtype))
    return out


# ---------------------------------------------------------------------------
# device: halo, sharded banded matvec, the cycle
# ---------------------------------------------------------------------------
def exchange(comm, X, hop_lo: int, hop_hi: int, site: str, far=None):
    """One neighbour exchange of a rank's block X (..., Bc) of a level
    vector (every rank's of one length): the haloed buffer (...,
    (hop_lo + 1 + hop_hi) Bc) -- hop_lo blocks below, the own block,
    hop_hi above, zeros beyond the first and last rank -- and, with
    ``far`` (a ``_DevOp``'s far lists), the values (..., n_need) of the
    columns the rank's far entries read, their messages riding the same
    ``batch_isend_irecv`` (one message a peer: halo block, then far
    values).  Returns (buffer, far values or None)."""
    d, N = comm.rank, comm.world
    send, recv = {}, {}  # peer -> parts
    for h in range(1, hop_lo + 1):
        if d + h < N:
            send.setdefault(d + h, []).append(X)
        if d - h >= 0:
            recv.setdefault(d - h, []).append(X.shape[-1])
    for h in range(1, hop_hi + 1):
        if d - h >= 0:
            send.setdefault(d - h, []).append(X)
        if d + h < N:
            recv.setdefault(d + h, []).append(X.shape[-1])
    if far is not None:
        for e, idx in far["send"].items():
            send.setdefault(e, []).append(X[..., idx])
        for e, pos in far["recv"].items():
            recv.setdefault(e, []).append(pos.shape[0])
    lead = X.shape[:-1]
    got = comm.exchange({e: torch.cat(p, dim=-1) for e, p in send.items()},
                        {e: lead + (sum(p),) for e, p in recv.items()}, X, site)
    blocks = [X if h == 0 else None for h in range(-hop_lo, hop_hi + 1)]
    for h in list(range(-hop_lo, 0)) + list(range(1, hop_hi + 1)):
        if 0 <= d + h < N:
            blocks[h + hop_lo] = got[d + h][..., :X.shape[-1]]
    buf = (X if len(blocks) == 1 else
           torch.cat([b if b is not None else torch.zeros_like(X) for b in blocks], dim=-1))
    if far is None:
        return buf, None
    xc = X.new_zeros(lead + (far["n_need"],))
    pos, idx = far["local"]
    xc[..., pos] = X[..., idx]
    for e, pos in far["recv"].items():
        # a halo neighbour's message starts with its block
        halo = X.shape[-1] if (0 < d - e <= hop_lo or 0 < e - d <= hop_hi) else 0
        xc[..., pos] = got[e][..., halo:]
    return buf, xc


class _DevOp:
    """One sharded operator of one rank on its device."""

    def __init__(self, r, meta: OpMeta, dtype, device):
        self.meta = meta
        self.wins = [_window_to(w, device) for w in r["wins"]]
        self.far = self.far_lists = None
        if r["far"] is not None:
            f = r["far"]
            ix = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
            self.far_lists = dict(n_need=f["n_need"], local=tuple(ix(a) for a in f["local"]),
                                  recv={e: ix(a) for e, a in f["recv"].items()},
                                  send={e: ix(a) for e, a in f["send"].items()})
            if f["csr"] is not None:
                ptr, col, val = f["csr"]
                counts = np.diff(ptr)
                self.far = ell_ops.DeviceCSR(
                    meta.Bd, f["n_need"], torch.as_tensor(ptr, device=device),
                    torch.as_tensor(col, device=device),
                    torch.as_tensor(val, dtype=dtype, device=device),
                    ell_ops.lanes_per_row(counts.sum() / max(int((counts > 0).sum()), 1)))


def _window_to(win: band_ops.PackedWindow, device) -> band_ops.PackedWindow:
    """A packed window (built on the host) on ``device``, its starts in the
    index type the device's kernels take."""
    return dataclasses.replace(win, slot_ptr=win.slot_ptr.to(device), off=win.off.to(device),
                               val=win.val.to(device),
                               w0=win.w0.to(device, index_dtype(device)))


def smv(comm, op: _DevOp, X, site: str):
    """The rank's rows of A x for a sharded operator (X (Bc,) or (B, Bc),
    the rank's block): one neighbour exchange (the widest window's halo
    and the far entries' columns), each window by K7 (K8 for a batch) on
    its slice of the haloed buffer, the far remainder added by
    ``ell.csr_add`` (JAX ``_smv``)."""
    m = op.meta
    batch = X.dim() == 2
    mv = band_ops.banded_matvec_batch if batch else band_ops.banded_matvec
    lo = max((w.hop_lo for w in m.wins), default=0)
    hi = max((w.hop_hi for w in m.wins), default=0)
    big, xc = exchange(comm, X, lo, hi, site + "/halo", op.far_lists)
    Bc = X.shape[-1]
    Y = None
    for win, wm in zip(op.wins, m.wins):
        a = (lo - wm.hop_lo) * Bc
        buf = big[..., a:a + (wm.hop_lo + 1 + wm.hop_hi) * Bc]
        ys = mv(win, buf.contiguous(), m.Bd)
        Y = ys if Y is None else Y + ys
    if Y is None:
        Y = X.new_zeros(X.shape[:-1] + (m.Bd,))
    if op.far is not None:
        Y = ell_ops.csr_add(op.far, xc.contiguous(), Y.contiguous())
    return Y


class ShardedMG:
    """The distributed V-cycle of one hierarchy on one rank: ``apply`` /
    ``apply_batch`` take the solver's local vectors (the rank's owned rows
    of each tag, concatenated: ``sel`` places them in the rank's MG
    block, RCM order included), ``fine_diag`` the lagged diagonal of
    those rows (the solvers' equilibration scale)."""

    def __init__(self, comm, shard: dict, sel: np.ndarray, fine_diag: np.ndarray,
                 dtype, device, post_smooth: bool = True, site: str = "mg"):
        self.comm, self.site, self.dtype = comm, site, dtype
        self.meta = meta = shard["meta"]
        self.levels = []
        for i, lm in enumerate(meta.levels):
            r = shard["levels"][i]
            self.levels.append(dict(
                A=_DevOp(r, lm, dtype, device),
                P=_DevOp(shard["p"][i], meta.p_meta[i], dtype, device),
                Pt=_DevOp(shard["pt"][i], meta.pt_meta[i], dtype, device),
                dinv=torch.as_tensor(r["dinv"], dtype=dtype, device=device),
                steps=torch.as_tensor(r["steps"], dtype=dtype, device=device)))
        self.coarse_V = torch.as_tensor(shard["coarse_V"], dtype=dtype, device=device)
        self.coarse_ilam = torch.as_tensor(shard["coarse_ilam"], dtype=dtype, device=device)
        self.sel = torch.as_tensor(sel, dtype=torch.int64, device=device)
        self.fine_diag = torch.as_tensor(fine_diag, dtype=dtype, device=device)
        self.post_smooth = post_smooth
        self.nu = meta.nu

    def _smv(self, op: _DevOp, X):
        return smv(self.comm, op, X, self.site)

    def _coarse(self, R):
        n_c = self.meta.n_coarse
        Bd = R.shape[-1]
        Rg = torch.cat(self.comm.all_gather(R.contiguous(), self.site + "/coarse"), dim=-1)
        Rg = Rg[..., :n_c]
        V, ilam = self.coarse_V, self.coarse_ilam
        if R.dim() == 2:
            Xg = ((Rg @ V) * ilam) @ V.T
        else:
            Xg = V @ (ilam * (V.T @ Rg))
        d = self.comm.rank
        Xp = torch.nn.functional.pad(Xg, (0, self.comm.world * Bd - n_c))
        return Xp[..., d * Bd:(d + 1) * Bd]

    def _cycle(self, i: int, r):
        if i == len(self.levels):
            return self._coarse(r)
        lv = self.levels[i]
        A = lambda x: self._smv(lv["A"], x)
        dinv, steps = lv["dinv"], lv["steps"]
        k = steps.shape[0]
        x = steps[0] * (dinv * r)
        for j in range(1, k):
            x = x + steps[j] * (dinv * (r - A(x)))
        for _ in range(self.nu - 1):
            for j in range(k):
                x = x + steps[j] * (dinv * (r - A(x)))
        rc = self._smv(lv["Pt"], r - A(x))
        xc = self._cycle(i + 1, rc)
        x = x + self._smv(lv["P"], xc)
        if self.post_smooth:
            for _ in range(self.nu):
                for j in range(k - 1, -1, -1):
                    x = x + steps[j] * (dinv * (r - A(x)))
        return x

    def _apply(self, R):
        Bd = self.meta.levels[0].Bd
        Rm = R.new_zeros(R.shape[:-1] + (Bd,))
        Rm[..., self.sel] = R
        return self._cycle(0, Rm)[..., self.sel]

    def apply(self, A0, r):
        """The cycle on the rank's residual r (L,) (``A0`` unused: every
        level smooths with its lagged operator)."""
        return self._apply(r)

    def apply_batch(self, A0b, R):
        """The cycle on B residual rows at once, R (B, L): one haloed
        K8 launch a window for all rows."""
        return self._apply(R)


def build_local(A0: sp.csr_matrix, gids: np.ndarray, L256: int, n_dev: int, opts,
                slab_dtype):
    """The distributed hierarchy of operator ``A0`` (global numbering):
    permuted into the sharded layout ``gids``, reordered by
    :func:`rcm_block_perm`, equilibrated, built banded
    (``build_hierarchy_cached``, the sharded slab budgets) and sharded.
    Returns (data, meta, d, perm): ``d`` the permuted operator's diagonal
    (padding rows 1) in the solver layout, ``perm`` the RCM order (JAX
    ``ShardedSimulation._build_distributed_mg.build``)."""
    from ..solvers.mg import build_hierarchy_cached

    A_perm = permute_operator(A0, gids)
    d = A_perm.diagonal()
    d = np.where(d != 0, d, 1.0)
    perm = rcm_block_perm(A_perm, n_dev, L256)
    A_mg = A_perm[perm][:, perm].tocsr()
    s = 1.0 / np.sqrt(np.abs(d[perm]))
    A_hat = (sp.diags(s) @ A_mg @ sp.diags(s)).tocsr()
    hier = build_hierarchy_cached(
        A_hat, B=1.0 / s, theta=opts.mg_theta, coarse_max=opts.mg_coarse_max,
        nu=opts.mg_nu, banded=True, smoother=opts.smoother, degree=opts.mg_degree,
        slab_dtype=slab_dtype, band_cap=BAND_CAP, tband_cap=TBAND_CAP)
    data, meta = shard_hierarchy(hier, n_dev, slab_dtype)
    return data, meta, d, perm, hier
