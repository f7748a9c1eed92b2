"""Rank programs of the multi-device modes, for :func:`parallel.launch`.

A launched function runs in a child process that imports torch and this
package alone, so the programs that the tests and ``chip_smoke.py`` start
on their ranks live here.  Each takes the rank's ``Comm`` first; a
scenario arrives as ``build``, a picklable callable taking ``device=``
and returning a ``Simulation`` (e.g. ``functools.partial(build_idealized,
dim=2, resolution=1, solver_options=...)``).  Results go back as numpy
(``interop.state_to_numpy``), from every rank.

* :func:`spmd_case`: the single-device steps on rank 0, then the same
  steps in :class:`~.spmd.SpmdSimulation` on every rank;
  ``bitwise`` says whether every field of every step has the same bits.
* :func:`sharded_case`: the steps in :class:`~.sharded.ShardedSimulation`
  from rank 0's simulation (or from a carried state), gathered, with
  the single-device steps on rank 0 where asked.
* :func:`run_cases`: several cases in one launch (one process start).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..interop import state_to_numpy
from .sharded import ShardedSimulation
from .spmd import SpmdSimulation


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


_SCALARS = ("t", "step", "emi_iters", "knp_iters", "emi_ok", "knp_ok", "emi_res", "knp_res")


def _steps(sim, state, n, keep=None):
    """``n`` steps; after each the whole state as numpy, or, for the steps
    not in ``keep`` (None: all kept), its scalars alone (no gather)."""
    out = []
    for i in range(n):
        state = sim.step(state)
        if keep is None or i in keep:
            whole = sim.gather_state(state) if hasattr(sim, "gather_state") else state
            out.append(state_to_numpy(whole))
        else:
            out.append({f: getattr(state, f).detach().cpu().numpy() for f in _SCALARS})
    return state, out


def simulation_inputs(sim) -> dict:
    """What ``Simulation`` is built from, host-side and picklable (the
    geometry, ions, parameters, membrane models, options, source gate,
    dtype): a host set-up can be rebuilt from it without the mesh."""
    return dict(geom=sim.geom, ions=sim.ions, params=sim.params,
                mem_models=list(sim.mem_models.values()), opts=sim.opts,
                source_gate=sim.source_gate, dtype=sim.dtype,
                splitting_scheme=sim.splitting_scheme)


def simulation_of(d: dict, device=None, opts=None):
    """The ``Simulation`` of :func:`simulation_inputs` ``d`` on ``device``,
    with solver options ``opts`` in place of its own where given."""
    from ..sim.stepper import Simulation

    return Simulation(d["geom"], d["ions"], d["params"], d["mem_models"],
                      opts or d["opts"], source_gate=d["source_gate"],
                      splitting_scheme=d["splitting_scheme"], dtype=d["dtype"],
                      device=device)


def simulation_from(path, device=None):
    """The ``Simulation`` of the :func:`simulation_inputs` pickled at
    ``path``, on ``device`` (a ``build`` for the rank programs)."""
    import pickle

    with open(path, "rb") as f:
        return simulation_of(pickle.load(f), device)


def same_bits(a: dict, b: dict) -> bool:
    """Every array of two ``state_to_numpy`` trees has the same bits."""
    for f, v in a.items():
        if isinstance(v, dict):
            for k in v:
                if v[k].tobytes() != b[f][k].tobytes():
                    return False
        elif np.asarray(v).tobytes() != np.asarray(b[f]).tobytes():
            return False
    return True


def memory_peak(dev) -> dict:
    """This process's memory, bytes: ``host_hwm``, the high-water resident
    set from ``/proc/self/status`` (``VmHWM``; None where the system does
    not report it), ``host_rss_now``, the resident set now
    (``/proc/self/statm``), ``ru_maxrss`` (which a spawned process
    inherits from the parent it was forked from: a floor of the parent's
    peak), and ``device_allocated``, the device's peak allocation."""
    import os
    import resource

    out = {"host_hwm": None, "host_rss_now": None,
           "ru_maxrss": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024}
    if os.path.exists("/proc/self/status"):
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    out["host_hwm"] = int(line.split()[1]) * 1024
    if os.path.exists("/proc/self/statm"):
        with open("/proc/self/statm") as f:
            out["host_rss_now"] = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    if torch.device(dev).type == "cuda":
        out["device_allocated"] = torch.cuda.max_memory_allocated(dev)
    return out


# the simulations this rank process built, by build callable and device: the
# cases of one launch share them (a Simulation keeps no state between runs
# but a refresh's, which these cases never turn on)
_BUILT = {}


def _built(build, device):
    key = (repr(build), str(torch.device(device)))
    if key not in _BUILT:
        _BUILT[key] = build(device=device)
    return _BUILT[key]


def spmd_case(comm, build, n_steps: int = 2, nccl_rank0: bool = False):
    """Rank 0 builds first and runs ``n_steps`` single-device steps; then
    every rank builds (the hierarchy cache is warm) and runs the SPMD
    steps.  Rank 0 returns both runs' states and ``bitwise``.
    ``nccl_rank0``: the case runs on rank 0 alone, in a process group of
    that one rank over NCCL made beside the launch's (every rank joins
    its creation; the others return None)."""
    if nccl_rank0:
        import torch.distributed as dist

        from .comm import Comm

        group = dist.new_group([0], backend="nccl")
        if comm.rank != 0:
            return None
        comm = Comm(0, 1, "nccl", comm.device, group=group)
    ref = None
    if comm.rank == 0:
        sim = _built(build, comm.device)
        _, ref = _steps(sim, sim.init_state(), n_steps)
    comm.barrier()
    if comm.rank != 0:
        sim = _built(build, comm.device)
    ssim = SpmdSimulation(comm, sim)
    comm.reset_counts()
    t0 = time.perf_counter()
    _, got = _steps(ssim, ssim.init_state(), n_steps)
    _sync(comm.device)
    out = dict(seconds=time.perf_counter() - t0, counts=dict(comm.counts),
               totals=comm.totals())
    if comm.rank == 0:
        out.update(ref=ref, states=got,
                   bitwise=all(same_bits(a, b) for a, b in zip(ref, got)))
    return out


def sharded_case(comm, build, n_steps: int = 2, distributed_mg: bool = True,
                 state=None, reference: bool = False, repeat: int = 0,
                 warm: int = 0, kernels: bool = False, device=None, threads=None,
                 keep=None):
    """Rank 0 builds the host set-up on the CPU; every rank runs
    ``n_steps`` sharded steps from ``state`` (a whole-domain state tree on
    rank 0, numpy; None: the initial state, after ``warm`` single-device
    steps on rank 0), gathered after each step.
    ``reference``: rank 0 also runs the single-device steps from the same
    state.  ``repeat``: the first ``repeat`` steps once more from the same
    state, for ``repeat_bitwise``.  ``device`` / ``threads``: run the case
    on another device of the same ranks (gloo: the CPU beside the card)
    with that many intra-op threads.  ``keep``: the steps whose whole
    state is gathered and returned (None: all; the others return their
    scalars; the repeated steps are always kept).  ``kernels``: every
    kernel's launch
    count over the ``n_steps`` (``launches``, this rank's), and after the
    steps rank 0's shards' kernels against their plain twins
    (:func:`shard_kernel_checks`).  Returns states, iterations, the
    collectives of the steps (``counts``, ``totals``), the set-up's
    seconds, the steps' host seconds and the peak memory."""
    from .comm import Comm

    if device is not None and torch.device(device) != comm.device:
        # the same ranks on another device (gloo takes CPU tensors as they are)
        comm = Comm(comm.rank, comm.world, comm.backend, device)
    n_threads = torch.get_num_threads()
    if threads:
        torch.set_num_threads(threads)
    try:
        if keep is not None:
            keep = set(keep) | set(range(repeat))
        return _sharded(comm, build, n_steps, distributed_mg, state, reference, repeat,
                        warm, kernels, keep)
    finally:
        torch.set_num_threads(n_threads)


def _sharded(comm, build, n_steps, distributed_mg, state, reference, repeat, warm,
             kernels, keep):
    from .. import ops
    from ..interop import state_from_numpy
    from ..ops import ell as E

    sim = None
    t0 = time.perf_counter()
    if comm.rank == 0:
        sim = _built(build, "cpu")
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    ssim = ShardedSimulation(comm, sim, distributed_mg=distributed_mg)
    t_setup = time.perf_counter() - t0
    host = None
    if comm.rank == 0:
        if state is None:
            host = sim.init_state()
            for _ in range(warm):
                host = sim.step(host)
            state = state_to_numpy(host)
        host = state_from_numpy(_Tree(state), "cpu", sim.dtype)
    s0 = ssim.scatter_state(host)
    comm.reset_counts()
    ops.reset_launch_counts()
    _sync(comm.device)
    t0 = time.perf_counter()
    _, got = _steps(ssim, s0, n_steps, keep)
    _sync(comm.device)
    seconds = time.perf_counter() - t0
    counts, totals = dict(comm.counts), comm.totals()
    launches = {**ops.launch_counts(), "K5/K6b csr_add": E.csr_add.launches}
    out = dict(seconds=seconds, counts=counts, totals=totals, launches=launches,
               iters=[(int(s["emi_iters"]), int(s["knp_iters"])) for s in got],
               setup_seconds=dict(ssim.setup_seconds, build=t_build, total=t_setup),
               memory=memory_peak(comm.device))
    if repeat:
        _, again = _steps(ssim, ssim.scatter_state(host), repeat)
        out["repeat_bitwise"] = all(same_bits(a, b) for a, b in zip(got[:repeat], again))
    if kernels:
        out["kernel_checks"] = shard_kernel_checks(comm, ssim)
    if comm.rank == 0:
        out["states"] = got
        out["start"] = state
        # the hop counts of every window of every distributed hierarchy
        out["hops"] = {key: [[(w.hop_lo, w.hop_hi) for w in lm.wins] for lm in meta.levels]
                       for key, (meta, _) in getattr(ssim, "hier_meta", {}).items()}
        out["n_hops"] = {t: b.n_hops for t, b in getattr(ssim, "blocks", {}).items()}
        if reference:
            ref_sim = _built(build, comm.device)
            h = state_from_numpy(_Tree(state), comm.device, ref_sim.dtype)
            _, out["ref"] = _steps(ref_sim, h, n_steps)
    return out


def smv_case(comm, A, x):
    """The ranks' rows of A x for a scipy matrix in the sharded banded form
    (``sharded_mg.shard_hierarchy``'s operator split, K7 plus the far
    remainder), gathered: the distributed matvec against scipy."""
    from ..solvers.mg import _csr_to_banded
    from . import sharded_mg as smg

    N, d = comm.world, comm.rank
    band = _csr_to_banded(A, R=smg.R_BLOCK)
    Bd = smg._device_row_split(A.shape[0], N)
    data, metas, f_max = smg._shard_band(band, Bd, Bd, N, np.float64)
    meta = smg.OpMeta(n=A.shape[0], Bd=Bd, Bc=Bd, wins=metas, f_max=f_max)
    op = smg._DevOp(smg._rank_op(data, meta, d, torch.float64), meta, torch.float64,
                    comm.device)
    xl = torch.as_tensor(np.pad(x, (0, N * Bd - len(x)))[d * Bd:(d + 1) * Bd],
                         device=comm.device)
    y = smg.smv(comm, op, xl, "smv")
    full = torch.cat(comm.all_gather(y, "smv"))[:A.shape[0]]
    return dict(y=full.cpu().numpy(), f_max=f_max, counts=dict(comm.counts))


class _Tree:
    """Attribute access to a ``state_to_numpy`` dict."""

    def __init__(self, d):
        self.__dict__.update(d)


CASES = {"spmd": spmd_case, "sharded": sharded_case, "smv": smv_case}


def run_cases(comm, cases):
    """Run ``cases`` [(kind, kwargs)] in turn ('spmd' or 'sharded');
    returns {"results": their results, "jax": whether this process has
    loaded JAX}."""
    import sys

    results = [CASES[kind](comm, **kw) for kind, kw in cases]
    return {"results": results,
            "jax": any(m == "jax" or m.startswith("jax.") for m in sys.modules)}


def fail_on(comm, rank: int):
    """Raise on ``rank`` after the others have met it (a launch that must
    fail, naming the rank)."""
    if comm.rank == rank:
        raise RuntimeError(f"deliberate failure on rank {rank}")
    comm.barrier()
    return comm.rank


def wait(comm, seconds: float):
    """Sleep (a launch that must pass its deadline)."""
    time.sleep(seconds)
    return comm.rank


def comm_selftest(comm):
    """Each collective of ``Comm`` on rank-numbered data: the sum, the
    ragged gather, the two-sided neighbour exchange and the object
    scatter, with the counts by site."""
    d, N = comm.rank, comm.world
    x = torch.arange(d + 1, dtype=torch.float64, device=comm.device) + 10.0 * d
    out = dict(sum=comm.all_reduce(torch.tensor([float(d), 1.0], device=comm.device),
                                   "sum").tolist(),
               gather=comm.all_gather_v(x, [r + 1 for r in range(N)], "gather").tolist())
    sends = {e: x for e in (d - 1, d + 1) if 0 <= e < N}
    recvs = {e: (e + 1,) for e in (d - 1, d + 1) if 0 <= e < N}
    got = comm.exchange(sends, recvs, x, "halo")
    out["exchange"] = {e: t.tolist() for e, t in got.items()}
    out["scatter"] = comm.scatter_object([f"to {r}" for r in range(N)] if d == 0 else None)
    out["counts"] = {k: dict(v) for k, v in comm.counts.items()}
    return out


def _check(name, variant, call, plain, tol, **info):
    """A kernel on the card against its plain twin on the same inputs:
    two launches (``deterministic``: the same bits), the error over
    max|y|, the gate ``tol``."""
    y1, y2, yp = call(), call(), plain()
    scale = float(yp.abs().max()) or 1.0
    err = float((y1 - yp).abs().max())
    return dict(name=name, variant=variant, max_abs_err=err, max_abs_y=scale,
                rel_err=err / scale, tol=tol, held=err <= tol * scale,
                deterministic=bool(torch.equal(y1, y2)), **info)


def shard_kernel_checks(comm, ssim, seed: int = 5):
    """The kernels of the sharded step on rank 0's shards, each against its
    plain twin (1e-5 of max|y| in float32, 1e-13 in float64) and across
    two launches: K1f / K1 and K11f / K3 on each subdomain's local
    operator (its window from a halo exchange), the K4 grad(phi) map on
    the local cells, K2 / K9 / K10 on each membrane, K7 / K8 on every
    window of the EMI hierarchy's level-0 operator with its halo and the
    far add where it has far entries.  Every rank joins the exchanges;
    rank 0 returns the rows (the others None)."""
    from ..ops import assembly as A
    from ..ops import banded as BD
    from ..ops import ell as E
    from ..ops import p1op as P
    from . import sharded_mg as smg
    from .sharded import halo_gather

    dev = comm.device
    g = torch.Generator(device="cpu").manual_seed(seed)
    rnd = lambda *shape: torch.rand(*shape, generator=g, dtype=torch.float64).to(dev)
    # the collectives every rank joins: each subdomain's haloed vectors,
    # the EMI level-0 windows' buffers and far columns
    wins = {}
    for t, tg in ssim.t.items():
        wins[t] = (halo_gather(comm, tg.info, rnd(tg.own)),
                   halo_gather(comm, tg.info, rnd(2, tg.own)))
    mg = ssim.emi_solver.mg
    bufs = None
    if isinstance(mg, smg.ShardedMG):
        op = mg.levels[0]["A"]
        m = op.meta
        X = rnd(2, m.Bd)
        bufs = [(smg.exchange(comm, X[0], w.hop_lo, w.hop_hi, "check")[0],
                 smg.exchange(comm, X, w.hop_lo, w.hop_hi, "check")[0]) for w in m.wins]
        far = smg.exchange(comm, X, 0, 0, "check", op.far_lists)[1]
    if comm.rank != 0:
        return None
    rows = []
    for dt, tol in ((torch.float32, 1e-5), (torch.float64, 1e-13)):
        f = lambda v: v.to(dt)
        for t, tg in ssim.t.items():
            b = tg.block
            x, X = f(wins[t][0]), f(wins[t][1])
            grads, vols = f(b.grads), f(b.vols)
            kbar = f(rnd(b.n_cells)) * 1e-3 + 1.0
            v = dict(variant=f"tag {t}", shape=[b.own, b.n_win, b.n_cells])
            vals = P.emi_fill(b.op, grads, vols * kbar)
            rows.append(_check("K1f emi_fill", v["variant"],
                               lambda: P.emi_fill(b.op, grads, vols * kbar),
                               lambda: P.emi_fill_plain(b.op, grads, vols * kbar), tol))
            rows.append(_check("K1 emi_stiffness", v["variant"],
                               lambda: P.emi_stiffness(x, b.op, vals),
                               lambda: P.emi_stiffness_plain(x, b.op, vals), tol))
            gmap = b.grad if dt == ssim.dtype else E.cell_gradient_ell(
                b.op.cells.cpu().numpy(), b.grads.double().cpu().numpy(), b.n_win, dt, dev)
            rows.append(_check("K4 ellw_matvec", v["variant"] + " grad(phi)",
                               lambda: E.ellw_matvec(gmap, x),
                               lambda: E.ellw_matvec_plain(gmap, x), tol))
            gp = E.ellw_matvec(gmap, x).reshape(-1, grads.shape[-1])
            Dr = P.drift_fill(b.op, grads, vols, gp)
            rows.append(_check("K11f drift_fill", v["variant"],
                               lambda: P.drift_fill(b.op, grads, vols, gp),
                               lambda: P.drift_fill_plain(b.op, grads, vols, gp), tol))
            coef = f(ssim.knp_sys.coef[t])[:2]
            M, K = f(tg.M), f(tg.kst)
            rows.append(_check("K3 knp_apply_batch", v["variant"] + " B=2",
                               lambda: P.knp_apply_batch(X, b.op, coef, M, K, Dr),
                               lambda: P.knp_apply_batch_plain(X, b.op, coef, M, K, Dr), tol))
        for mi, mb in ssim.mems.items():
            xm = f(rnd(mb["n_mem"]))
            Mv = f(mb["M"])
            rows.append(_check("K2 surface_mass", f"membrane {mi}",
                               lambda: P.surface_mass(xm, mb["op"], Mv, 2.0),
                               lambda: P.surface_mass_plain(xm, mb["op"], Mv, 2.0), tol))
            Xm = f(rnd(3, mb["n_mem"]))
            rows.append(_check("K9 facet_gather", f"membrane {mi} F=3",
                               lambda: A.facet_gather(Xm, mb["op"].cells),
                               lambda: A.facet_gather_plain(Xm, mb["op"].cells), tol))
            V = A.facet_gather(Xm, mb["op"].cells).contiguous()
            rows.append(_check("K10 facet_scatter", f"membrane {mi} F=3",
                               lambda: A.facet_scatter(V, mb["op"]),
                               lambda: A.facet_scatter_plain(V, mb["op"]), tol))
        if bufs is not None:
            for j, (win, (b1, b2)) in enumerate(zip(op.wins, bufs)):
                w = win if dt == ssim.dtype else dataclasses.replace(win, val=win.val.to(dt))
                b1, b2 = f(b1), f(b2)
                hops = dict(hop_lo=m.wins[j].hop_lo, hop_hi=m.wins[j].hop_hi)
                rows.append(_check("K7 banded_matvec", f"EMI level 0 window {j}",
                                   lambda: BD.banded_matvec(w, b1, m.Bd),
                                   lambda: BD.banded_matvec_plain(w, b1, m.Bd), tol, **hops))
                rows.append(_check("K8 banded_matvec_batch", f"EMI level 0 window {j} B=2",
                                   lambda: BD.banded_matvec_batch(w, b2, m.Bd),
                                   lambda: BD.banded_matvec_batch_plain(w, b2, m.Bd), tol,
                                   **hops))
            if far is not None and op.far is not None:
                F = dataclasses.replace(op.far, val=op.far.val.to(dt))
                xc, y0 = f(far).contiguous(), f(rnd(2, m.Bd))
                rows.append(_check("K5/K6b csr_add", "EMI level 0 far add B=2",
                                   lambda: E.csr_add(F, xc, y0.clone()),
                                   lambda: E.csr_add_plain(F, xc, y0.clone()), tol))
    return rows
