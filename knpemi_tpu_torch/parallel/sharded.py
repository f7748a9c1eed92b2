"""Dof-sharded domain decomposition: each rank owns a block of every
subdomain's dofs.

Counterpart of ``knpemi_tpu/parallel/sharded.py``, the JAX package's
"MPI-parity" mode (the reference's PETSc decomposition: partitioned
vectors, ghost updates, distributed Krylov), on ``torch.distributed``
ranks (``parallel/comm.py``):

* **Partition** (:func:`partition_subdomain`, JAX ``:53-104``): every
  subdomain's Morton-ordered dofs split into contiguous blocks of
  B = ceil(n / N), rank d owning ``[d B, min((d + 1) B, n))`` -- ragged:
  the last rank owns what is left, and no array is padded to a uniform
  shape (padding is a ``shard_map`` constraint, not part of the method).
  ``partition_subdomain`` itself (cells owned by their min dof, padded
  per-rank arrays) is the JAX package's, kept to hold the two partitions
  equal; the set-up reads only its block sizes and hop count
  (:func:`subdomain_blocks`, no per-rank arrays); the one-hot blockings of ``partition_blocking`` /
  ``local_blocking`` (``:107-189``) are the TPU's and have no
  counterpart here.
* **The rank's local P1 operator** takes their place
  (:class:`RowBlock`): the rank's owned rows of the subdomain's P1
  operator, complete (every cell that touches an owned row, in
  ascending order), its columns in a two-sided window of whole blocks,
  ``hop_lo`` below and ``hop_hi`` above.  The fills and applies on it are
  K1f / K1 and K11f / K3 (K11), unchanged: each owned row keeps its
  columns, its order and so its sums.  A row-complete apply needs only
  the forward halo (:func:`halo_gather`, the neighbours' blocks, by
  ``send`` / ``recv``); the JAX package's ``halo_reduce``, the backward
  sum of partial rows into their owners, has no counterpart, because no
  rank computes a partial row: the cells of a row shared by two ranks
  are on both.
* **Membrane terms** ride replicated membrane-sized vectors
  (:func:`gather_replicated`: one sum over the ranks of the values each
  owns; :func:`scatter_owned`): K2 applies the whole membrane operator
  on every rank, K9 / K10 the whole Robin right-hand side, as the JAX
  package does.
* **Krylov inner products** are local partial sums plus one sum over the
  ranks (``solvers/precision.py``: ``make_pdot2`` / ``make_pbdot2`` with
  compensation, ``make_pdot`` / ``make_pbdot`` without), so every rank
  runs the same iterations.
* **The membrane ODEs** run on each rank's rows of the membrane dofs and
  are ``all_gather``ed (``:1176-1221``).
* **The preconditioner**: the distributed V-cycle
  (``parallel/sharded_mg.py``) by default; with ``distributed_mg=False``
  the replicated hierarchy of the single-device simulation applied to
  the gathered residual (:class:`_GatheredMG`).  A hierarchy that
  refuses banding raises: nothing falls back to another form.

The host set-up runs once, on rank 0, from a ``Simulation`` built there
(as the JAX package's single controller does); each rank receives its
shard (:meth:`ShardedSimulation._host_shards`) and builds its device
objects, holding n/N of the dof vectors and of the distributed
hierarchy.  The host LU path and the deflated Jacobi preconditioner are
not ported to this mode (``ValueError``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..interop import owned_rows, scatter_state
from ..ops import assembly as A
from ..ops import ell as E
from ..ops import p1op as P
from ..solvers.api import EMISolver, KNPSolver
from ..sim.stepper import _to_host, check_health
from ..solvers.precision import make_pbdot, make_pbdot2, make_pdot, make_pdot2
from ..systems.coupling import eliminated_concentration
from ..systems.knp import KNPSystem
from ..systems.types import SimState
from . import sharded_mg as smg


# ---------------------------------------------------------------------------
# host: the JAX package's partition
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class SubPartition:
    """Per-subdomain dof / cell partition over N ranks, the JAX package's
    arrays (stacked with a leading rank axis, cells padded to Cmax)."""

    tag: int
    n_dofs: int  # true dof count
    B: int  # owned block per rank
    H: int  # halo width, whole blocks
    n_hops: int
    cells: np.ndarray  # (N, Cmax, k) window-local dof ids
    grads: np.ndarray  # (N, Cmax, k, dim)
    vols: np.ndarray  # (N, Cmax), zero-padded
    fsrc: Optional[np.ndarray] = None  # (N, Cmax, nq, Ns) source at quad pts


@dataclasses.dataclass
class Blocks:
    """One subdomain's dof blocks over N ranks: B owned rows a rank, the
    JAX package's halo width H (whole blocks) and its hop count."""

    n_dofs: int
    B: int
    H: int
    n_hops: int


def subdomain_blocks(cells: np.ndarray, n: int, n_dev: int) -> Blocks:
    """The block size, halo width and hops of the JAX package's partition
    of a subdomain with ``n`` dofs and ``cells``."""
    B = -(-n // n_dev)
    spread = int((cells.max(axis=1) - cells.min(axis=1)).max()) if len(cells) else 1
    n_hops = -(-min(max(spread, 1), (n_dev - 1) * B) // B)
    return Blocks(n_dofs=n, B=B, H=n_hops * B, n_hops=n_hops)


def partition_subdomain(sub, n_dev: int, fsrc=None) -> SubPartition:
    """The JAX package's partition of one subdomain: cells to the rank of
    their min dof, the window ``[d B, d B + B + H)`` of whole blocks."""
    n = sub.n_dofs
    cells = np.asarray(sub.cells)
    blk = subdomain_blocks(cells, n, n_dev)
    B, H, n_hops = blk.B, blk.H, blk.n_hops
    owner = np.minimum(cells.min(axis=1) // B, n_dev - 1)
    counts = np.bincount(owner, minlength=n_dev)
    Cmax = int(counts.max())
    k = cells.shape[1]
    dim = sub.grads.shape[-1]
    c_l = np.zeros((n_dev, Cmax, k), np.int32)
    g_l = np.zeros((n_dev, Cmax, k, dim), sub.grads.dtype)
    v_l = np.zeros((n_dev, Cmax), sub.vols.dtype)
    f_l = None
    if fsrc is not None:
        fsrc = np.asarray(fsrc)
        f_l = np.zeros((n_dev, Cmax) + fsrc.shape[1:], fsrc.dtype)
    for d in range(n_dev):
        ids = np.flatnonzero(owner == d)
        m = len(ids)
        loc = cells[ids] - d * B
        if m and (loc.min() < 0 or loc.max() >= B + H):
            raise AssertionError(f"cell window violation on device {d}")
        c_l[d, :m] = loc
        g_l[d, :m] = sub.grads[ids]
        v_l[d, :m] = sub.vols[ids]
        if f_l is not None:
            f_l[d, :m] = fsrc[ids]
    return SubPartition(tag=sub.tag, n_dofs=n, B=B, H=H, n_hops=n_hops,
                        cells=c_l, grads=g_l, vols=v_l, fsrc=f_l)


# ---------------------------------------------------------------------------
# host: a rank's rows of a P1 operator
# ---------------------------------------------------------------------------
def cells_touching(cells: np.ndarray, r0: int, r1: int) -> np.ndarray:
    """Ascending ids of the cells with a vertex in rows [r0, r1)."""
    return np.flatnonzero(((cells >= r0) & (cells < r1)).any(axis=1))


def csr_row_values(op: P.P1Operator, vals, r0: int, r1: int):
    """The slot values ``vals`` of a whole operator at the nonzeros of rows
    [r0, r1), in CSR order (rows, then columns ascending): what a rank's
    operator of those rows places with :func:`place_row_values`."""
    at = op.csr_slots()[op._indptr[r0]:op._indptr[r1]]
    if torch.is_tensor(vals):
        return vals[torch.as_tensor(at, device=vals.device)]
    return np.asarray(vals)[at]


def place_row_values(op: P.P1Operator, csr_vals, dtype, device) -> torch.Tensor:
    """The slot values of a rank's operator ``op`` (its owned rows) from
    their CSR-ordered values; padding slots 0."""
    out = torch.zeros(op.slots, dtype=dtype, device=device)
    out[torch.as_tensor(op.csr_slots(), device=device)] = torch.as_tensor(
        csr_vals, dtype=dtype).to(device)
    return out


class RowBlock:
    """A rank's rows [r0, r1) of one P1 operator on its window [base, base
    + n_win): the rows' operator (``P1Operator(..., rows=(lo, hi))`` in
    window numbering), the local cells' geometry and K4's mean-vertex
    and gradient maps on them.  ``own`` 0: no operator."""

    def __init__(self, cells, r0: int, r1: int, base: int, n_win: int, dtype, device,
                 grads=None, vols=None, maps: bool = True):
        self.r0, self.r1, self.own = int(r0), int(r1), int(r1) - int(r0)
        self.base, self.n_win = int(base), int(n_win)
        self.lo, self.hi = self.r0 - self.base, self.r1 - self.base
        self.op = None
        if self.own == 0:
            return
        cells = np.asarray(cells)
        self.n_cells = cells.shape[0]
        self.op = P.P1Operator(cells, self.n_win, device, rows=(self.lo, self.hi))
        as_f = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
        if grads is not None:
            self.grads, self.vols = as_f(grads), as_f(vols)
        if maps:
            self.kbar = E.cell_mean_ell(cells, self.n_win, dtype, device)
            self.grad = E.cell_gradient_ell(cells, grads, self.n_win, dtype, device)


# ---------------------------------------------------------------------------
# device: halo and replicated membrane vectors
# ---------------------------------------------------------------------------
def halo_gather(comm, blk: "TagInfo", X: torch.Tensor) -> torch.Tensor:
    """X (..., own), the rank's block of a subdomain vector -> (...,
    n_win), its window: the neighbours' whole blocks ``hop_lo`` below and
    ``hop_hi`` above, fetched by ``send`` / ``recv`` (leading axes, the
    ion batch, ride one message)."""
    d, N = comm.rank, comm.world
    if blk.hop_lo == 0 and blk.hop_hi == 0:
        return X
    sends, recvs = {}, {}
    for e in range(max(0, d - blk.hop_hi), min(N, d + blk.hop_lo + 1)):
        if e != d and blk.sizes[d]:
            sends[e] = X.contiguous()
    lo_r, hi_r = max(0, d - blk.hop_lo), min(N - 1, d + blk.hop_hi)
    for e in range(lo_r, hi_r + 1):
        if e != d:
            recvs[e] = X.shape[:-1] + (blk.sizes[e],)
    got = comm.exchange(sends, recvs, X, "halo")
    parts = [X if e == d else got.get(e, X.new_zeros(X.shape[:-1] + (0,)))
             for e in range(lo_r, hi_r + 1)]
    return torch.cat(parts, dim=-1)


class OwnedIndex:
    """Where a rank's block holds some of a list of global dof ids: the
    positions ``pos`` in the list and the local rows ``loc``."""

    def __init__(self, gids, r0: int, r1: int, device):
        gids = np.asarray(gids)
        own = np.flatnonzero((gids >= r0) & (gids < r1))
        self.n = len(gids)
        self.pos = torch.as_tensor(own, device=device)
        self.loc = torch.as_tensor(gids[own] - r0, device=device)


def gather_replicated(comm, items, site: str = "trace"):
    """Values of rank-blocked vectors at global ids, on every rank:
    ``items`` [(X (..., own), OwnedIndex)], one sum over the ranks for
    all of them (each rank fills the ids it owns, the others add 0).
    Returns the list of (..., len(ids)) tensors."""
    bufs = []
    for X, ix in items:
        b = X.new_zeros(X.shape[:-1] + (ix.n,))
        b[..., ix.pos] = X[..., ix.loc]
        bufs.append(b.reshape(-1))
    flat = comm.all_reduce(torch.cat(bufs), site)
    out, at = [], 0
    for (X, ix), b in zip(items, bufs):
        out.append(flat[at:at + b.numel()].reshape(X.shape[:-1] + (ix.n,)))
        at += b.numel()
    return out


def scatter_owned(Y: torch.Tensor, ix: OwnedIndex, vals: torch.Tensor) -> torch.Tensor:
    """Y (..., own) plus the replicated per-id values ``vals`` (..., len
    ids) at the ids the rank owns (each id once: no atomics in play)."""
    return Y.index_add(Y.dim() - 1, ix.loc, vals[..., ix.pos])


# ---------------------------------------------------------------------------
# a rank's share of the systems
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class TagInfo:
    """A rank's view of one subdomain's partition (host, picklable)."""

    n: int
    B: int
    sizes: List[int]  # owned rows of every rank
    r0: int
    r1: int
    base: int
    n_win: int
    hop_lo: int
    hop_hi: int

    @property
    def own(self) -> int:
        return self.r1 - self.r0


def tag_partition(cells: np.ndarray, n: int, n_dev: int):
    """The ranks' rows of one subdomain and the two-sided hops that their
    local cells need (the largest over the ranks, whole blocks): a list
    of (TagInfo, local cell ids) per rank."""
    B = -(-n // n_dev)
    rows = [owned_rows(n, n_dev, d) for d in range(n_dev)]
    ids, hop_lo, hop_hi = [], 0, 0
    for d, (r0, r1) in enumerate(rows):
        c = cells_touching(cells, r0, r1)
        ids.append(c)
        if len(c):
            v = cells[c]
            hop_lo = max(hop_lo, d - int(v.min()) // B)
            hop_hi = max(hop_hi, int(v.max()) // B - d)
    sizes = [r1 - r0 for r0, r1 in rows]
    out = []
    for d, (r0, r1) in enumerate(rows):
        base = max(0, d - hop_lo) * B
        end = min(n, (d + 1 + hop_hi) * B)
        out.append((TagInfo(n=n, B=B, sizes=sizes, r0=r0, r1=r1, base=base,
                            n_win=end - base, hop_lo=hop_lo, hop_hi=hop_hi), ids[d]))
    return out


class _Tag:
    """A rank's share of one subdomain on its device: partition, local
    operator, constant values."""

    def __init__(self, sh: dict, dtype, device):
        self.info = info = sh["info"]
        self.own = info.own
        if self.own == 0:
            raise ValueError(f"a rank owns no row of a subdomain of {info.n} dofs: "
                             "use fewer ranks")
        self.block = RowBlock(sh["cells"], info.r0, info.r1, info.base, info.n_win, dtype,
                              device, sh["grads"], sh["vols"])
        op = self.block.op
        place = lambda v: place_row_values(op, v, dtype, device)
        self.kst, self.M = place(sh["kst"]), place(sh["M"])
        self.ion_vals = [place(v) for v in sh["ion_vals"]] if sh["ion_vals"] else []
        self.src = (None if sh["src"] is None
                    else torch.as_tensor(sh["src"], dtype=dtype).to(device))


class ShardedEMI:
    """The EMI system on a rank's blocks (duck-types ``EMISystem`` for
    ``EMISolver``): vectors are the flat concatenation of the rank's
    owned rows of each subdomain; the solver's dot must be a
    distributed one."""

    def __init__(self, comm, tags: Dict[int, _Tag], mems: dict, common: dict):
        self.comm, self.t, self.mem = comm, tags, mems
        self.tags = common["tags"]
        self.params, self.ions = common["params"], common["ions"]
        self.dtype, self.device = common["dtype"], comm.device
        self.splitting_scheme = common["splitting_scheme"]
        self.has_bc, self.mms = False, None
        self.offsets, off = {}, 0
        for t in self.tags:
            self.offsets[t] = off
            off += tags[t].own
        self.n = off
        self.nullvec = torch.full((off,), 1.0 / np.sqrt(common["n_emi"]), dtype=self.dtype,
                                  device=self.device)

    def split(self, x):
        return {t: x[self.offsets[t]:self.offsets[t] + self.t[t].own] for t in self.tags}

    def flatten(self, d):
        return torch.cat([d[t] for t in self.tags])

    def kappa(self, c):
        F, psi = self.params.F, self.params.psi
        out = {}
        for t in self.tags:
            acc = 0.0
            for k, ion in enumerate(self.ions):
                acc = acc + (ion.z ** 2) * ion.D[t] * c[t][k]
            out[t] = F * psi * acc
        return out

    def prepare(self, kappa):
        """K4's mean-vertex kappa on the rank's cells (from the haloed
        kappa), then K1f on its rows."""
        vals = {}
        for t in self.tags:
            tg = self.t[t]
            b = tg.block
            kbar = E.ellw_matvec(b.kbar, halo_gather(self.comm, tg.info, kappa[t]).contiguous())
            vals[t] = P.emi_fill(b.op, b.grads, b.vols * kbar)
        return {"kappa": kappa, "vals": vals}

    def _rows(self, t, X, vals, scale=1.0):
        b = self.t[t].block
        return P.emi_stiffness(halo_gather(self.comm, self.t[t].info, X).contiguous(), b.op,
                               vals, scale)[b.lo:b.hi]

    def _coupling(self, ys, g):
        """ys[ct] += C_phi M_Gamma g, ys[0] -= it, for every membrane's
        replicated g (K2 on the whole membrane operator)."""
        C_phi = self.params.C_phi
        for m, mb in self.mem.items():
            w = P.surface_mass(g[m].contiguous(), mb["op"], mb["M"], C_phi)
            ct = mb["cell_tag"]
            ys[ct] = scatter_owned(ys[ct], mb["i"], w)
            ys[0] = scatter_owned(ys[0], mb["e"], -w)

    def matvec(self, x, ctx):
        xs = self.split(x)
        ys = {t: self._rows(t, xs[t], ctx["vals"][t]) for t in self.tags}
        items = []
        for mb in self.mem.values():
            items += [(xs[0], mb["e"]), (xs[mb["cell_tag"]], mb["i"])]
        tr = gather_replicated(self.comm, items)
        self._coupling(ys, {m: tr[2 * j + 1] - tr[2 * j] for j, m in enumerate(self.mem)})
        return self.flatten(ys)

    def diag(self, kappa):
        raise ValueError("the sharded mode preconditions with a hierarchy; the "
                         "deflated Jacobi path is not ported to it")

    def rhs(self, c, phi_M, I_ch=None, ctx=None):
        """The centered diffusive driving (its mean a sum over the ranks)
        by K1 of the unit stiffness, plus the membrane Robin data by K2."""
        F, C_phi = self.params.F, self.params.C_phi
        rs = {}
        for t in self.tags:
            u = torch.zeros(self.t[t].own, dtype=self.dtype, device=self.device)
            for k, ion in enumerate(self.ions):
                u = u + (F * ion.z * ion.D[t]) * c[t][k]
            tot = self.comm.all_reduce(u.sum(), "center")
            u = u - tot / self.t[t].info.n
            rs[t] = self._rows(t, u, self.t[t].kst, -1.0)
        g = {}
        for m, mb in self.mem.items():
            g[m] = phi_M[m]
            if not self.splitting_scheme:
                g[m] = g[m] - (1.0 / C_phi) * I_ch[m].sum(dim=0)
        self._coupling(rs, g)
        return self.flatten(rs)


class ShardedKNP(KNPSystem):
    """The KNP system on a rank's blocks (duck-types ``KNPSystem`` for
    ``KNPSolver``); the Robin terms' quadrature algebra is
    ``KNPSystem._robin_facet_values`` on replicated membrane vectors."""

    def __init__(self, comm, tags: Dict[int, _Tag], mems: dict, common: dict):
        self.comm, self.t, self.mem = comm, tags, mems
        self.tags = common["tags"]
        self.params, ions = common["params"], common["ions"]
        self.ions = ions
        self.dtype, self.device = dtype, device = common["dtype"], comm.device
        self.splitting_scheme = common["splitting_scheme"]
        self.mms = None
        self.n_solved = Ns = len(ions) - 1
        self.dim = common["dim"]
        as_f = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
        dt, psi = self.params.dt, self.params.psi
        self.z_solved = as_f([ion.z for ion in ions[:-1]])
        self.z_all = as_f([ion.z for ion in ions])
        self.D = {t: as_f([ion.D[t] for ion in ions[:-1]]) for t in self.tags}
        self.D_all = {t: as_f([ion.D[t] for ion in ions]) for t in self.tags}
        self.coef = {t: as_f([[1.0 / dt, ion.D[t], ion.z * psi * ion.D[t]]
                              for ion in ions[:-1]]) for t in self.tags}
        self.coef_mass = as_f([[1.0 / dt, 0.0, 0.0]] * Ns)
        self.fb, self.fw = as_f(common["facet_rule"][0]), as_f(common["facet_rule"][1])

    def _halo(self, t, X):
        return halo_gather(self.comm, self.t[t].info, X).contiguous()

    def gradphi_cells(self, phi):
        """grad(phi) per local cell by K4 on the haloed phi."""
        return {t: E.ellw_matvec(self.t[t].block.grad, self._halo(t, phi[t]))
                .reshape(-1, self.dim) for t in self.tags}

    def drift_values(self, tag, gradphi):
        b = self.t[tag].block
        return P.drift_fill(b.op, b.grads, b.vols, gradphi)

    def matvec_batch(self, tag, X, Dr):
        tg = self.t[tag]
        b = tg.block
        return P.knp_apply_batch(self._halo(tag, X), b.op, self.coef[tag], tg.M, tg.kst,
                                 Dr)[:, b.lo:b.hi]

    def matvec_one(self, tag, k, x, Dr):
        tg = self.t[tag]
        b = tg.block
        ion = self.ions[k]
        return P.knp_apply(self._halo(tag, x), b.op, tg.ion_vals[k], Dr,
                           ion.z * self.params.psi * ion.D[tag])[b.lo:b.hi]

    def diag(self, tag, gradphi):
        raise ValueError("the sharded mode preconditions with a hierarchy; the "
                         "unpreconditioned KNP path is not ported to it")

    def rhs(self, c, phi, phi_M, I_ch=None, source_gate=1.0):
        """The mass term by K3 on the rank's rows, the gated source rows,
        and the Robin terms on replicated membrane traces (K9, the
        quadrature algebra, K10 on every rank), added at the owned ids."""
        Ns = self.n_solved
        if torch.is_tensor(source_gate):
            source_gate = source_gate.to(self.dtype)
        r = {}
        for t in self.tags:
            tg = self.t[t]
            b = tg.block
            r[t] = P.knp_apply_batch(self._halo(t, c[t][:Ns]), b.op, self.coef_mass,
                                     tg.M)[:, b.lo:b.hi]
            if tg.src is not None:
                r[t] = r[t] + source_gate * tg.src
        items = []
        for mb in self.mem.values():
            ct = mb["cell_tag"]
            items += [(c[0], mb["e"]), (c[ct], mb["i"]), (phi[0], mb["e"]),
                      (phi[ct], mb["i"])]
        tr = gather_replicated(self.comm, items)
        for j, (m, mb) in enumerate(self.mem.items()):
            ce, ci, pe, pi = tr[4 * j:4 * j + 4]
            ct = mb["cell_tag"]
            X = torch.cat([ce, ci, (pi - pe)[None], phi_M[m][None], I_ch[m]], dim=0)
            G = A.facet_gather(X, mb["op"].cells)
            vals = self._robin_facet_values(ct, G, mb["areas"])
            Y = A.facet_scatter(vals.contiguous(), mb["op"])
            r[0] = scatter_owned(r[0], mb["e"], Y[:Ns])
            r[ct] = scatter_owned(r[ct], mb["i"], Y[Ns:])
        return r


# ---------------------------------------------------------------------------
# the replicated hierarchy
# ---------------------------------------------------------------------------
class _GatheredMG:
    """A replicated ``DeviceMG`` (the single-device hierarchy, global dof
    layout) applied to a rank's blocks: ``all_gather`` of the residual,
    the V-cycle, the rank's rows of the result (JAX ``:692-713``).
    ``fine_diag`` is the hierarchy's lagged diagonal at the rank's rows."""

    def __init__(self, mg, layout, fine_diag_local):
        self.mg = mg
        self.layout = layout  # (to_global, to_local)
        self.fine_diag = fine_diag_local

    def apply(self, A0, r_loc):
        to_global, to_local = self.layout
        return to_local(self.mg.apply(lambda v: v, to_global(r_loc)))

    def apply_batch(self, A0b, R):
        to_global, to_local = self.layout
        return to_local(self.mg.apply_batch(lambda V: V, to_global(R)))


def make_layout(comm, infos: Dict[int, TagInfo], tags: List[int]):
    """(to_global, to_local) between a rank's flat concatenation of owned
    blocks and the global flat concatenation of the subdomains' dofs:
    one ``all_gather`` of the ranks' flat blocks."""
    sizes = [sum(infos[t].sizes[r] for t in tags) for r in range(comm.world)]

    def to_global(x):
        full = comm.all_gather_v(x, sizes, "mg_gather")
        segs, at = {t: [] for t in tags}, 0
        for r in range(comm.world):
            for t in tags:
                s = infos[t].sizes[r]
                segs[t].append(full[..., at:at + s])
                at += s
        return torch.cat([torch.cat(segs[t], dim=-1) for t in tags], dim=-1)

    offs, at = {}, 0
    for t in tags:
        offs[t] = at
        at += infos[t].n

    def to_local(xg):
        return torch.cat([xg[..., offs[t] + infos[t].r0:offs[t] + infos[t].r1]
                          for t in tags], dim=-1)

    return to_global, to_local


def make_tag_layout(comm, info: TagInfo):
    """Per-subdomain (to_global, to_local) for a replicated KNP hierarchy;
    both act on the last axis (the ion batch rides one gather)."""
    return ((lambda x: comm.all_gather_v(x, info.sizes, "mg_gather")),
            (lambda xg: xg[..., info.r0:info.r1]))


# ---------------------------------------------------------------------------
# the sharded simulation
# ---------------------------------------------------------------------------
def _np(v):
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def distributed_operators(sim, n_dev: int):
    """The operators of the distributed hierarchies over ``n_dev`` ranks, in
    the order the sharded mode builds them: (key, A0, {tag: Blocks},
    tags) for the t = 0 EMI operator (key ``"emi"``, every subdomain) and
    each subdomain's KNP setup operator (mass/dt + mean-D stiffness; key
    its tag)."""
    from ..solvers import direct
    from ..systems.coupling import set_initial_conditions

    tags, subs = sim.geom.sub_tags, sim.geom.subdomains
    parts = {t: subdomain_blocks(np.asarray(subs[t].cells), subs[t].n_dofs, n_dev)
             for t in tags}
    c0 = set_initial_conditions(sim.geom, sim.ions, dtype=torch.float64, device="cpu")
    kappa = {t: v.numpy() for t, v in sim.emi_sys.kappa(c0).items()}
    yield "emi", sim._assemble_emi_cached(kappa), parts, tags
    for t in tags:
        sub = subs[t]
        Dbar = float(np.mean([ion.D[t] for ion in sim.ions[:-1]]))
        r1, c1, v1 = direct._mass_coo(sub.cells, sub.vols, 1.0 / sim.params.dt)
        r2, c2, v2 = direct._stiffness_coo(sub.cells, sub.grads, sub.vols, coef_cell=Dbar)
        yield t, direct._coo_accumulate([r1, r2], [c1, c2], [v1, v2], sub.n_dofs), \
            {t: parts[t]}, [t]


def warm_distributed_hierarchies(sim, n_dev: int) -> None:
    """Build the distributed hierarchies of ``sim`` over ``n_dev`` ranks into
    the hierarchy cache (no process group needed), so that a sharded
    simulation's set-up later finds them there."""
    slab_dtype = np.float32 if sim.dtype == torch.float32 else np.float64
    for _, A0, sub_parts, sub_tags in distributed_operators(sim, n_dev):
        gids, L256, _ = smg.local_layout_gids(sub_parts, sub_tags, n_dev)
        smg.build_local(A0, gids, L256, n_dev, sim.opts, slab_dtype)


def ode_rows(n_mem: int, n_dev: int, d: int):
    """Rank d's rows of a membrane's ODE states: contiguous blocks of
    ceil(n / N)."""
    blk = -(-n_mem // n_dev)
    return min(d * blk, n_mem), min((d + 1) * blk, n_mem)


class ShardedSimulation:
    """A ``Simulation``'s step with dof-sharded domain decomposition on the
    ranks of ``comm``.  Rank 0 passes the ``Simulation`` (the host set-up:
    build it with ``device="cpu"``); the other ranks pass None.  The
    state's dof arrays hold the rank's owned rows (``c`` {tag: (N_ions,
    own)}, ``phi`` {tag: (own,)}); the membrane arrays are replicated.
    ``setup_seconds`` (rank 0) times the host set-up's parts:
    ``partition``, ``hierarchies`` (the permuted ones, or the replicated
    ones' packing), ``scatter``, and ``device`` (this rank's uploads)."""

    def __init__(self, comm, sim=None, distributed_mg: bool = True):
        self.comm = comm
        self.distributed_mg = distributed_mg
        self.sim = sim if comm.rank == 0 else None
        if comm.rank == 0 and sim is None:
            raise ValueError("rank 0 must pass the Simulation (the host set-up)")
        self.setup_seconds = {}
        shards = self._host_shards(sim) if comm.rank == 0 else None
        t0 = time.perf_counter()
        shard = comm.scatter_object(shards)
        del shards
        self.setup_seconds["scatter"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self._build(shard)
        self.setup_seconds["device"] = time.perf_counter() - t0

    # -- host set-up (rank 0) ---------------------------------------------
    def _host_shards(self, sim) -> list:
        opts = sim.opts
        if opts.direct or opts.emi_precond != "mg":
            raise ValueError("the sharded mode needs the multigrid preconditioner "
                             "(direct and emi_precond='jacobi' are not ported to it)")
        N = self.comm.world
        t0 = time.perf_counter()
        geom, tags = sim.geom, sim.geom.sub_tags
        common = dict(
            tags=tags, params=sim.params, ions=sim.ions, dtype=sim.dtype, opts=opts,
            splitting_scheme=sim.splitting_scheme, dim=geom.dim,
            mem_models=list(sim.mem_models.values()), source_gate=sim.source_gate,
            n_emi=geom.emi_size, world=N,
            facet_rule=(_np(sim.knp_sys.fb), _np(sim.knp_sys.fw)),
            knp_batched=opts.knp_batched, knp_post_smooth=opts.knp_post_smooth)
        shards = [dict(common=common, tags={}, mems={}) for _ in range(N)]
        self.infos = {}
        for t in tags:
            sub = geom.subdomains[t]
            cells = np.asarray(sub.cells)
            op = sim.emi_sys.sub[t]["op"]
            kst = _np(sim.emi_sys.sub[t]["kst"])
            M = _np(sim.knp_sys.sub[t]["M"])
            ion_vals = [_np(v) for v in sim.knp_sys.ion_vals.get(t, [])]
            src = sim.knp_sys._src_vec[t]
            src = None if src is None else _np(src)
            parts = tag_partition(cells, sub.n_dofs, N)
            self.infos[t] = [info for info, _ in parts]
            for d, (info, ids) in enumerate(parts):
                r0, r1 = info.r0, info.r1
                shards[d]["tags"][t] = dict(
                    info=info, cells=(cells[ids] - info.base).astype(np.int32),
                    grads=np.asarray(sub.grads)[ids], vols=np.asarray(sub.vols)[ids],
                    kst=csr_row_values(op, kst, r0, r1), M=csr_row_values(op, M, r0, r1),
                    ion_vals=[csr_row_values(op, v, r0, r1) for v in ion_vals],
                    src=None if src is None else src[:, r0:r1])
        for m, sp_ in geom.membranes.items():
            for d in range(N):
                shards[d]["mems"][m] = dict(
                    facet_dofs=np.asarray(sp_.facet_dofs), areas=np.asarray(sp_.areas),
                    mem_to_ecs=np.asarray(sp_.mem_to_ecs), mem_to_ics=np.asarray(sp_.mem_to_ics),
                    cell_tag=sp_.cell_tag, n_dofs=sp_.n_dofs)
        self.setup_seconds["partition"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        mgs = (self._distributed_hierarchies(sim) if self.distributed_mg
               else self._replicated_hierarchies(sim))
        for d in range(N):
            shards[d]["mg"] = mgs[d]
        self.setup_seconds["hierarchies"] = time.perf_counter() - t0
        return shards

    def _replicated_hierarchies(self, sim) -> list:
        """Every rank gets the single-device host hierarchies (uploaded on
        the rank) and their lagged diagonals at its rows."""
        N, tags = self.comm.world, sim.geom.sub_tags
        emi_d = _np(sim.emi_solver.mg.fine_diag)
        offs = sim.geom.emi_offsets()
        out = []
        for d in range(N):
            fd = np.concatenate([emi_d[offs[t] + self.infos[t][d].r0:
                                       offs[t] + self.infos[t][d].r1] for t in tags])
            knp = {t: dict(hier=sim._knp_hier[t],
                           fine_diag=_np(sim.knp_solver.mg[t].fine_diag)[
                               self.infos[t][d].r0:self.infos[t][d].r1])
                   for t in tags}
            out.append(dict(kind="replicated", emi=dict(hier=sim._emi_hier, fine_diag=fd),
                            knp=knp))
        return out

    def _distributed_hierarchies(self, sim) -> list:
        """The EMI and KNP hierarchies of the operators permuted into the
        sharded layout (``sharded_mg.build_local``), each rank's share
        packed on the host (JAX ``_build_distributed_mg``)."""
        N = self.comm.world
        slab_dtype = np.float32 if sim.dtype == torch.float32 else np.float64
        self.hier_meta = {}
        out = [dict(kind="distributed", knp={}) for _ in range(N)]
        for key, A0, sub_parts, sub_tags in distributed_operators(sim, N):
            if key == "emi":  # every subdomain's blocks
                self.blocks = sub_parts
            gids, L256, L = smg.local_layout_gids(sub_parts, sub_tags, N)
            data, meta, dg, perm, hier = smg.build_local(A0, gids, L256, N, sim.opts,
                                                         slab_dtype)
            self.hier_meta[key] = (meta, hier)
            lperm = perm.reshape(N, L256) - (np.arange(N) * L256)[:, None]
            iperm = np.argsort(lperm, axis=1)
            for d in range(N):
                # the rank's owned rows of each tag within its MG block
                pos, at = [], 0
                for t in sub_tags:
                    pos.append(at + np.arange(self.infos[t][d].own))
                    at += sub_parts[t].B
                pos = np.concatenate(pos)
                share = dict(shard=smg.rank_hierarchy(data, meta, d, sim.dtype),
                             sel=iperm[d][pos], fine_diag=dg.reshape(N, L256)[d][pos])
                if key == "emi":
                    out[d]["emi"] = share
                else:
                    out[d]["knp"][key] = share
        return out

    # -- device objects (every rank) ----------------------------------------
    def _build(self, shard):
        comm, common = self.comm, shard["common"]
        self.common = common
        dtype, dev = common["dtype"], comm.device
        self.dtype, self.device = dtype, dev
        self.tags, self.params, self.ions = common["tags"], common["params"], common["ions"]
        self.opts = common["opts"]
        self.source_gate = common["source_gate"]
        self.mem_models = {mm.tag: mm for mm in common["mem_models"]}
        self.t = {t: _Tag(sh, dtype, dev) for t, sh in shard["tags"].items()}
        self.info = {t: tg.info for t, tg in self.t.items()}
        mems = {}
        for m, sh in shard["mems"].items():
            op = P.P1Operator(sh["facet_dofs"], sh["n_dofs"], dev)
            ct = sh["cell_tag"]
            mems[m] = dict(
                cell_tag=ct, n_mem=sh["n_dofs"], op=op,
                M=P.mass_values(op, sh["facet_dofs"], sh["areas"], dtype),
                areas=torch.as_tensor(sh["areas"], dtype=dtype, device=dev),
                e=OwnedIndex(sh["mem_to_ecs"], self.info[0].r0, self.info[0].r1, dev),
                i=OwnedIndex(sh["mem_to_ics"], self.info[ct].r0, self.info[ct].r1, dev))
        self.mems = mems
        self.emi_sys = ShardedEMI(comm, self.t, mems, common)
        self.knp_sys = ShardedKNP(comm, self.t, mems, common)
        comp = self.opts.compensated_dots
        if comp is None:
            comp = dtype == torch.float32
        dot = (make_pdot2 if comp else make_pdot)(comm)
        bdot = (make_pbdot2 if comp else make_pbdot)(comm)
        o = self.opts
        self.emi_solver = EMISolver(self.emi_sys, rtol=o.rtol_emi, atol=o.atol_emi,
                                    maxiter=o.maxiter, dot=dot)
        self.knp_solver = KNPSolver(self.knp_sys, rtol=o.rtol_knp, atol=o.atol_knp,
                                    maxiter=o.maxiter, restart=o.restart,
                                    min_iter=o.min_iter_knp, dot=dot, bdot=bdot,
                                    batched=o.knp_batched)
        self._build_mg(shard["mg"])

    def _build_mg(self, mg):
        comm, dtype, dev = self.comm, self.dtype, self.device
        post = self.opts.knp_post_smooth
        if mg["kind"] == "distributed":
            e = mg["emi"]
            self.emi_solver.mg = smg.ShardedMG(comm, e["shard"], e["sel"], e["fine_diag"],
                                               dtype, dev, site="emi_mg")
            self.knp_solver.mg = {
                t: smg.ShardedMG(comm, k["shard"], k["sel"], k["fine_diag"], dtype, dev,
                                 post_smooth=post, site="knp_mg")
                for t, k in mg["knp"].items()}
            return
        e = mg["emi"]
        dmg = e["hier"].device(dtype, dev)
        self.emi_solver.mg = _GatheredMG(dmg, make_layout(comm, self.info, self.tags),
                                         torch.as_tensor(e["fine_diag"], dtype=dtype).to(dev))
        self.knp_solver.mg = {}
        for t, k in mg["knp"].items():
            dmg = k["hier"].device(dtype, dev)
            dmg.post_smooth = post
            self.knp_solver.mg[t] = _GatheredMG(
                dmg, make_tag_layout(comm, self.info[t]),
                torch.as_tensor(k["fine_diag"], dtype=dtype).to(dev))

    # -- state layout -------------------------------------------------------
    def scatter_state(self, state=None) -> SimState:
        """A whole-domain state, given on rank 0 (a ``SimState`` on any
        device, or the JAX package's state after ``jax.device_get``, its
        padded-global dof arrays cut to n: ``interop.scatter_state``), to
        this rank's blocks on its device."""
        comm = self.comm
        blocks = scatter_state(self.sim, state, comm.world) if comm.rank == 0 else None
        s = comm.scatter_object(blocks, "state")
        dev = self.device
        move = lambda v: ({k: t.to(dev) for k, t in v.items()} if isinstance(v, dict)
                          else v.to(dev))
        return SimState(**{f: move(getattr(s, f)) for f in SimState.__dataclass_fields__})

    def init_state(self) -> SimState:
        """The single-device initial state (rank 0's simulation), scattered."""
        return self.scatter_state(self.sim.init_state() if self.comm.rank == 0 else None)

    def gather_state(self, state: SimState) -> SimState:
        """The whole-domain state on every rank (on its device): the dof
        arrays gathered, the rest as it is."""
        comm = self.comm
        c = {t: comm.all_gather_v(state.c[t].contiguous(), self.info[t].sizes, "state")
             for t in self.tags}
        phi = {t: comm.all_gather_v(state.phi[t].contiguous(), self.info[t].sizes, "state")
               for t in self.tags}
        return dataclasses.replace(state, c=c, phi=phi)

    # -- the step -----------------------------------------------------------
    def _membrane_odes(self, state: SimState):
        """[1] the ODE inputs from replicated traces, RK4 on the rank's rows
        of each membrane, the rows ``all_gather``ed."""
        comm, dt = self.comm, self.params.dt
        first = state.step == 0
        phi_M = dict(state.phi_M)
        ode_states, ode_params, I_ch = dict(state.ode_states), dict(state.ode_params), {}
        items = []
        for m in self.mem_models:
            mb = self.mems[m]
            items += [(state.c[0], mb["e"]), (state.c[mb["cell_tag"]], mb["i"])]
        tr = gather_replicated(comm, items)
        for j, (m, mm) in enumerate(self.mem_models.items()):
            tr_e, tr_i = tr[2 * j], tr[2 * j + 1]
            prms = state.ode_params[m].clone()
            for k, ion in enumerate(self.ions):
                if f"{ion.name}_e" in mm._pidx:
                    prms[:, mm.param_index(f"{ion.name}_e")] = tr_e[k]
                    prms[:, mm.param_index(f"{ion.name}_i")] = tr_i[k]
            sts = state.ode_states[m].clone()
            v = mm.state_index("V")
            sts[:, v] = torch.where(first, sts[:, v], state.phi_M[m])
            a, b = ode_rows(mm.n_dofs, comm.world, comm.rank)
            loc = mm.step(sts[a:b], prms[a:b], state.t, dt)
            sizes = [ode_rows(mm.n_dofs, comm.world, r) for r in range(comm.world)]
            sizes = [hi - lo for lo, hi in sizes]
            sts = comm.all_gather_v(loc.T.contiguous(), sizes, "ode").T.contiguous()
            ode_states[m], ode_params[m] = sts, prms
            phi_M[m] = mm.get_membrane_potential(sts).contiguous()
            cur = mm.currents(sts, prms, state.t + dt)
            I_ch[m] = torch.stack([cur[ion.name] for ion in self.ions])
        return ode_states, ode_params, phi_M, I_ch

    def step(self, state: SimState) -> SimState:
        """One splitting step on the rank's blocks (JAX ``_step_body``)."""
        p = self.params
        ode_states, ode_params, phi_M_new, I_ch = self._membrane_odes(state)
        phi, emi_info = self.emi_solver.solve(state.c, phi_M_new, I_ch, x0=state.phi)
        c_solved, knp_info = self.knp_solver.solve(
            state.c, phi, phi_M_new, I_ch, source_gate=self.source_gate(state.t),
            x0=state.c)
        zs = [ion.z for ion in self.ions[:-1]]
        c_new = {}
        for t in self.tags:
            c_el = eliminated_concentration(c_solved[t], zs, self.ions[-1].z, p.rho_z,
                                            p.rho.get(t, 0.0))
            c_new[t] = torch.cat([c_solved[t], c_el[None, :]], dim=0)
        items = []
        for m in self.mem_models:
            mb = self.mems[m]
            items += [(phi[0], mb["e"]), (phi[mb["cell_tag"]], mb["i"])]
        tr = gather_replicated(self.comm, items)
        phi_M = {m: tr[2 * j + 1] - tr[2 * j] for j, m in enumerate(self.mem_models)}
        dev = self.device
        return SimState(
            c=c_new, phi=phi, phi_M=phi_M, ode_states=ode_states, ode_params=ode_params,
            t=state.t + p.dt, step=state.step + 1,
            emi_iters=torch.tensor(emi_info.iters, dtype=torch.int32, device=dev),
            knp_iters=torch.tensor(knp_info.iters, dtype=torch.int32, device=dev),
            emi_ok=torch.tensor(emi_info.converged, device=dev),
            knp_ok=torch.tensor(knp_info.converged, device=dev),
            emi_res=emi_info.resnorm.to(self.dtype), knp_res=knp_info.resnorm.to(self.dtype))

    def run(self, state: SimState, n_steps: int, save_every: Optional[int] = None,
            observer=None, verbose: bool = False):
        """Advance n_steps in chunks of ``save_every`` (default one chunk):
        after each, read the chunk's counts once, act on a solve that did
        not converge (``SolverOptions.on_divergence``), and call
        ``observer`` with the whole-domain state on the host (every rank
        calls it).  Returns (state, emi_iters[], knp_iters[])."""
        return _run_chunks(self, state, n_steps, save_every, observer, verbose)


def _run_chunks(msim, state, n_steps, save_every, observer, verbose):
    """The chunked run of both modes (``Simulation.run``'s cadence)."""
    chunk_n = save_every or n_steps
    it_e, it_k = [], []
    done = 0
    while done < n_steps:
        n = min(chunk_n, n_steps - done)
        t0 = time.perf_counter()
        diag = []
        for _ in range(n):
            state = msim.step(state)
            diag.append(torch.stack([state.emi_iters.to(torch.int64),
                                     state.knp_iters.to(torch.int64),
                                     (state.emi_ok & state.knp_ok).to(torch.int64)]))
        diag = torch.stack(diag).cpu().numpy()
        if verbose and msim.comm.rank == 0:
            print(f"  steps {done + 1}..{done + n}: "
                  f"{(time.perf_counter() - t0) / n * 1e3:.2f} ms/step, "
                  f"emi_it={int(diag[-1, 0])} knp_it={int(diag[-1, 1])}")
        it_e += diag[:, 0].tolist()
        it_k += diag[:, 1].tolist()
        done += n
        check_health(msim.opts, state, diag[:, 2].astype(bool).tolist(), done - n)
        if observer is not None:
            observer(_to_host(msim.gather_state(state)))
    return state, np.array(it_e), np.array(it_k)
