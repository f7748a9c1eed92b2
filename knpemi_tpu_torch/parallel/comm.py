"""Ranks and collectives of the multi-device modes, on ``torch.distributed``.

The JAX package runs one program over a device mesh, its collectives XLA
operations (``psum``, ``all_gather``, ``ppermute``).  Here every device
is driven by a host process of its own, a *rank*, as PyTorch does across
GPUs: the coupled step is bound by its host (a few Krylov iterations a
step, each reading its stopping test back), so a card needs a host
process to keep it fed.

* :class:`Comm` is one rank's view: ``rank``, ``world``, ``backend``
  (``"nccl"`` or ``"gloo"``) and ``device``, with the few collectives the
  modes use -- a sum :meth:`Comm.all_reduce`, :meth:`Comm.all_gather` of
  blocks of one length (:meth:`Comm.all_gather_v` pads ragged ones), the
  neighbour exchange :meth:`Comm.exchange` (``ppermute``'s counterpart:
  ``send`` / ``recv`` pairs in one ``batch_isend_irecv``), and
  :meth:`Comm.scatter_object` / :meth:`Comm.broadcast_object` for the
  host set-up.  Each call names its site; ``Comm.counts`` keeps, per
  site, the calls, the bytes a rank sent and the bytes it staged
  through the host.
* NCCL takes one rank per card and CUDA tensors.  Gloo takes CPU tensors
  only for ``all_gather`` and ``send`` / ``recv``, so with gloo on CUDA
  tensors every collective copies to the host and back, explicitly,
  and counts those bytes as staged: the declared transport of N ranks
  sharing one card, which the caller picks (never a branch taken on an
  error).
* :func:`launch` starts ``world`` ranks with the ``spawn`` method, meets
  them through a ``file://`` rendezvous in a temporary directory (no
  network), runs ``fn(comm, *args)`` in each and returns every rank's
  result.  Rank r takes ``cuda:(r % device_count)``.  The whole launch
  has a deadline: when a rank fails or the deadline passes, every rank
  is stopped and ``launch`` raises with that rank's traceback.  The
  CUDA kernels and the native host toolkit are built before the ranks
  start, so that no two ranks compile into ``knpemi_tpu_torch/build/`` at
  once.  ``fn`` must be importable by a child that imports torch and
  this package alone (``parallel/programs.py`` holds the rank programs).
"""

from __future__ import annotations

import contextlib
import os
import queue
import shutil
import tempfile
import time
import traceback
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..systems.types import resolve_device

BACKENDS = ("nccl", "gloo")


class Comm:
    """One rank's collectives (see the module docstring), in an initialised
    process group (a rank of :func:`launch`): even one rank goes through
    its backend."""

    def __init__(self, rank: int, world: int, backend: str, device, group=None):
        """``group``: the process group of the collectives (None: the
        default one); ``rank`` and ``world`` are this rank's within it."""
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        self.rank, self.world, self.backend = int(rank), int(world), backend
        # the port's device rule: None means CUDA, which raises without it
        self.device = resolve_device(device)
        if backend == "nccl" and self.device.type != "cuda":
            raise ValueError("nccl needs CUDA devices")
        # gloo on CUDA tensors stages every collective through the host
        self.staged = backend == "gloo" and self.device.type == "cuda"
        # site -> {"calls", "bytes" sent by this rank, "staged" host bytes}
        self.counts: Dict[str, Dict[str, int]] = defaultdict(
            lambda: {"calls": 0, "bytes": 0, "staged": 0})
        self.group = group
        if not (dist.is_available() and dist.is_initialized()):
            raise ValueError("Comm needs an initialised process group (use launch)")

    # -- bookkeeping ------------------------------------------------------
    def _count(self, site: str, nbytes: int, staged: int = 0):
        c = self.counts[site]
        c["calls"] += 1
        c["bytes"] += int(nbytes)
        c["staged"] += int(staged)

    def reset_counts(self):
        self.counts.clear()

    def totals(self) -> Dict[str, int]:
        """Calls, bytes and staged bytes summed over every site."""
        out = {"calls": 0, "bytes": 0, "staged": 0}
        for c in self.counts.values():
            for k in out:
                out[k] += c[k]
        return out

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the transport takes it (a host copy under staging)."""
        return t.detach().to("cpu", copy=True) if self.staged else t.contiguous()

    def _back(self, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return t.to(like.device) if self.staged else t

    @staticmethod
    def _nbytes(t: torch.Tensor) -> int:
        return t.numel() * t.element_size()

    # -- collectives ------------------------------------------------------
    def all_reduce(self, t: torch.Tensor, site: str) -> torch.Tensor:
        """The sum of ``t`` over the ranks, as a new tensor."""
        buf = self._out(t).clone() if not self.staged else self._out(t)
        n = self._nbytes(buf)
        dist.all_reduce(buf, group=self.group)
        self._count(site, n, 2 * n if self.staged else 0)
        return self._back(buf, t)

    def all_gather(self, t: torch.Tensor, site: str) -> List[torch.Tensor]:
        """Every rank's ``t`` (one shape on every rank), in rank order."""
        src = self._out(t)
        outs = [torch.empty_like(src) for _ in range(self.world)]
        dist.all_gather(outs, src, group=self.group)
        n = self._nbytes(src)
        self._count(site, n, n * (1 + self.world) if self.staged else 0)
        return [self._back(o, t) for o in outs]

    def all_gather_v(self, t: torch.Tensor, sizes: Sequence[int], site: str) -> torch.Tensor:
        """Ragged blocks along the last axis, rank r's of length
        ``sizes[r]``, concatenated in rank order: each block padded to the
        longest for the gather, the padding dropped after."""
        L = max(sizes)
        pad = L - t.shape[-1]
        src = t if pad == 0 else torch.nn.functional.pad(t, (0, pad))
        parts = self.all_gather(src, site)
        return torch.cat([p[..., :s] for p, s in zip(parts, sizes)], dim=-1)

    def exchange(self, sends: Dict[int, torch.Tensor], recvs: Dict[int, tuple],
                 like: torch.Tensor, site: str) -> Dict[int, torch.Tensor]:
        """Point-to-point messages in one ``batch_isend_irecv``: ``sends``
        {peer: tensor}, ``recvs`` {peer: shape} (dtype and device of
        ``like``).  Returns {peer: received tensor}.  Empty messages are
        neither sent nor received (both sides know their sizes)."""
        sends = {p: t for p, t in sends.items() if t.numel()}
        recvs = {p: s for p, s in recvs.items() if _numel(s)}
        if not sends and not recvs:
            return {}
        dev = torch.device("cpu") if self.staged else like.device
        out = {p: torch.empty(s, dtype=like.dtype, device=dev) for p, s in recvs.items()}
        srcs = {p: self._out(t) for p, t in sends.items()}
        ops = [dist.P2POp(dist.isend, t, p, group=self.group) for p, t in srcs.items()]
        ops += [dist.P2POp(dist.irecv, t, p, group=self.group) for p, t in out.items()]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        n = sum(self._nbytes(t) for t in srcs.values())
        m = sum(self._nbytes(t) for t in out.values())
        self._count(site, n, n + m if self.staged else 0)
        return {p: self._back(t, like) for p, t in out.items()}

    def scatter_object(self, objs: Optional[list], site: str = "setup"):
        """Rank r receives ``objs[r]`` of the list rank 0 passes."""
        out = [None]
        dist.scatter_object_list(out, objs if self.rank == 0 else None, src=0,
                                 group=self.group)
        self._count(site, 0)
        return out[0]

    def broadcast_object(self, obj, site: str = "setup"):
        """Rank 0's ``obj`` on every rank."""
        box = [obj if self.rank == 0 else None]
        dist.broadcast_object_list(box, src=0, group=self.group)
        self._count(site, 0)
        return box[0]

    def barrier(self):
        if self.backend == "nccl":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


# ---------------------------------------------------------------------------
# launching ranks
# ---------------------------------------------------------------------------
def rank_device(device, rank: int) -> torch.device:
    """The device of rank ``rank``: the CPU, or ``cuda:(rank % count)``."""
    device = torch.device(device)
    if device.type == "cpu":
        return device
    return torch.device("cuda", rank % torch.cuda.device_count())


def check_launch(world: int, backend: str, device) -> torch.device:
    """The device rule and the transport rule of :func:`launch`, before
    any process starts: ``device=None`` means CUDA and raises without it;
    NCCL needs one card per rank (it refuses two ranks on one GPU).
    Returns the device kind the ranks take."""
    if world < 1:
        raise ValueError(f"world must be at least 1, got {world}")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the ranks on the CPU")
        device = torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"ranks run on 'cuda' or 'cpu', got {device}")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("nccl needs CUDA devices; use gloo on the CPU")
        cards = torch.cuda.device_count()
        if world > cards:
            raise ValueError(
                f"nccl needs one card per rank: {world} ranks, {cards} card(s); "
                "use gloo for several ranks on one card")
    return torch.device(device.type)


def _rank_main(rank, world, backend, kind, init_file, fn, args, threads, results):
    try:
        if threads:
            torch.set_num_threads(threads)
        dev = rank_device(kind, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        kw = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=f"file://{init_file}",
                                world_size=world, rank=rank, **kw)
        comm = Comm(rank, world, backend, dev)
        out = fn(comm, *args)
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@contextlib.contextmanager
def _no_main_import():
    """While ranks start: a spawned child would run the caller's main
    script again (as ``__mp_main__``) to find the functions it was given;
    the rank programs live in this package, so the children are told that
    there is no main module to run (a main module named ``__main__`` is
    left alone) and import torch and the port only."""
    import sys
    import types

    main = sys.modules["__main__"]
    spec = getattr(main, "__spec__", None)
    main.__spec__ = types.SimpleNamespace(name="__main__")
    try:
        yield
    finally:
        main.__spec__ = spec


def launch(fn: Callable, world: int, backend: str, device=None, args: tuple = (),
           deadline: float = 1800.0, threads: Optional[int] = None) -> list:
    """Run ``fn(comm, *args)`` on ``world`` ranks (see the module
    docstring) and return the ranks' results in rank order.  ``threads``
    sets ``torch.set_num_threads`` in every rank; ``deadline`` is the
    seconds the whole launch may take."""
    kind = check_launch(world, backend, device)
    if kind.type == "cuda":
        # every kernel and the host toolkit before the ranks: they must
        # not compile into the build directory at the same time
        from ..ops import _build
        from ..utils import native

        _build.build()
        native.build()
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="knpemi_ranks_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        r, world, backend, kind.type, os.path.join(tmp, "rendezvous"), fn, args,
        threads, results)) for r in range(world)]
    out: Dict[int, object] = {}
    t_end = time.monotonic() + deadline
    try:
        with _no_main_import():
            for p in procs:
                p.start()
        while len(out) < world:
            left = t_end - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"launch of {world} ranks passed its deadline of {deadline:.0f} s "
                    f"({len(out)} of {world} ranks done)")
            try:
                rank, ok, val = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and not p.is_alive() and p.exitcode not in (0, None)]
                if dead:
                    # a rank that died without reporting (a signal, os._exit)
                    time.sleep(0.5)
                    if results.empty():
                        raise RuntimeError(f"rank {dead[0]} exited with code "
                                           f"{procs[dead[0]].exitcode} and no result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{val}")
            out[rank] = val
        for p in procs:
            p.join(timeout=max(1.0, t_end - time.monotonic()))
    finally:
        started = [p for p in procs if p.pid is not None]
        for p in started:
            if p.is_alive():
                p.terminate()
        for p in started:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world)]
