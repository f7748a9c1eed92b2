#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (knpemi_tpu_torch) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --step-profile ROOT   # the port's kernels in the
                                                # flagship's step, for the
                                                # package under ROOT
    python3 chip_smoke.py --step-diff FILE      # the A/B of such lines
    python3 chip_smoke.py --phase-seconds FILE...  # seconds by phase of
                                                   # smoke runs' output

The second form compares two trees in one call when run for each in
turns (parent, change, change, parent): ``step_profile``'s device ms per
step and per device kernel.  The rest of this text is the first.

Phases, each printing JSON lines tagged with its number (the two
multigrid paths run one after the other, so the lines of phases 1, 3
and 4 come in two groups):

0. device and build: first a line of the card's name and power limit,
   the Python version and whether h5py and yaml import; then the torch
   and CUDA versions and the build of every CUDA kernel from ops/csrc;
1. kernels: each of the fourteen hand-written kernels against its plain
   PyTorch version on the card, in float32 and float64 (K7/K8 on the
   packed windows, also with bfloat16 values) — the seven assembly
   kernels of the batched step (K1 and K3 are applies of a subdomain's
   assembled P1 operator, K1f the fill of K1's values once per EMI
   solve, K2 the apply of a membrane's surface mass on its own P1
   operator, K10 a row walk of that operator's incidence list; K2 and
   K10 held to 1e-13 of max|y| in float64 and bitwise across two
   launches) at the shapes of the 3-D res-2 mesh, the five multigrid
   kernels at the shapes of the res-2 banded hierarchies' own operators
   (EMI for K4/K5/K7, KNP tag 0 at B = 2 and once at B = 1 and 8 for
   K6a/K6b/K8; K6a on the sliced form of a layout the batched cycle
   applies; K5/K6b on the transposed form of a restriction layout, held
   to 1e-13 of max|y| in float64 and bitwise across two launches, and
   timed beside K6a's kernel on the sliced ELL of the same P^T), and the
   single-ion KNP
   operator K11 (the same apply with two value streams) and its drift
   fill K11f on every subdomain of the astrocyte flagship, the l = 4 box
   and res 2, K11 also row by row against K3 (K1 and K1f too on every
   subdomain of all three; the fills, row by row from the operator's
   incidence list, held to 1e-13 of max|y| in float64 and bitwise across
   two launches); K3 on every subdomain of
   both at B = 1, 2, 3, full and mass-only; K6a on every sliced layout and
   K6b on every restriction layout of the l = 4 box's KNP hierarchies,
   K5 on the EMI hierarchy's; before each of the three flagship
   runs, every kernel of the batched step once more on that
   simulation's own operators: K1/K1f/K3/K4 on each of its three
   subdomains (per-tag diffusion coefficients), K2/K9/K10 on both
   membranes and, with mg_banded, K4-K8 on the layouts its four
   hierarchies took (K7/K8 on every banded window of the EMI and first
   KNP hierarchies, by both routes of reading x; the far remainder's add
   on K5/K6b's kernel on every banded operator with a far list, its own
   row ``K5/K6b csr_add`` in the kernels line); on the l = 4 box, the
   banded flagship's K4 (EMI level-0 P) and far-add rows and K11 / K11f's
   batched flagship rows (every other row is untimed), device times (L2
   flushed, by torch.profiler) of kernel, plain version and the PyTorch
   call that computes the same function (torch.mv / torch.sparse.mm on
   its CSR; for K1, K2 and K11 the CSR of the same P1 operator, for K3
   assembled from the port's host COO helpers, for K1f and K11f the CSR
   of the fill's frozen linear map; index_add_ for K10), the kernel's time from
   100 calls replayed as one CUDA graph, beside the bound, and each
   call's time with the host's; K1, K3 and K11 also with the bound of
   their slots and that of the earlier cell-loop formulation's bytes,
   K1f and K11f with the bound of the bytes their row fill reads
   (``nbytes_layout``: the incidence list and the gathered inputs once),
   K2 with that of M_Gamma's slots, which its apply reads; the launch
   floor (``floor_ms``: the flushed device time of a one-element fill),
   which every row of the kernels line carries beside its bound;
   after phase 3 the cost per solve (fill + applies) against the
   cell-loop kernels' recorded times, with the recorded times of the
   designs K3 and K6a replaced beside it (not measured in the run);
2. parity: 2 float64 steps of the 3-D res-1 scenario on the GPU and on
   the CPU, with ELL and with banded multigrid — equal Krylov iteration
   counts on all four, phi_M within 1e-9 V and concentrations within
   1e-9 relative between GPU and CPU — and per-ion with banded multigrid
   (single-vector KNP V-cycles through K7; counts equal GPU against
   CPU, the same gates); then 5 float32 res-1 steps with
   the fine smoothing slabs in float32 and in bfloat16 (mg_band_bf16);
   and 2 float64 steps of the astrocyte tissue scenario at mesh_n 20 on
   the GPU and on the CPU, ion-batched and per-ion — equal iteration
   counts GPU against CPU, phi_M within 1e-9 mV, c within 1e-9 relative;
   and 6 float64 res-1 steps in chunks of 2 with the EMI hierarchy
   refreshed every 2 steps (mg_refresh_every=2, synchronous), per
   multigrid layout, GPU against CPU: iterations equal, the same gates,
   2 refreshes installed and none skipped; and once more on the GPU with
   the refresh on its worker thread (mg_refresh_async): at least one
   installed, none skipped, no worker left, the same gates against the
   synchronous GPU run; then the solver options, float64, on the GPU and
   the CPU with the same gates: 1 step each on the 3-D res-1 case in
   both layouts of Chebyshev smoothing (degree 3), two sweeps a side, the
   KNP V(1,0) cycle, the W-cycle (gamma 2 on every built hierarchy) and
   compensated dots, 2 steps each on the 2-D res-1 case of the host LU
   (direct=True) and the deflated Jacobi CG (emi_precond='jacobi'); then one Chebyshev
   and one W-cycle of each layout's hierarchies on the 3-D res-0 l = 1
   box, GPU against CPU, within 1e-12 of max|y| (the W-cycle's EMI
   apply 1e-10: it amplifies roundoff).  The CPU legs of these cases run
   in a process of their own (``start_phase2_cpu``, WARM_THREADS
   threads) from the l = 4 box on, beside the card's runs, each writing
   its record and final state to a file (``interop.state_to_numpy``);
   phase 2 runs the card's legs and holds them against those files (a
   failed CPU leg fails the run with the process's output);
3. slice: the 3-D res-2 scenario (float32, g_syn_bar 10), 2 warm-up and
   10 timed steps, once per multigrid path (mg_banded=False, then
   mg_banded=True with the layout build_hierarchy chose per level);
   then the same scenario in the box of twice the length (l = 4, 1.1 M
   dofs/step), mg_banded=True, 2 warm-up and 5 timed steps: there the
   KNP transfers take the windowed-ELL layout too, so all twelve
   kernels of the batched step are on the path, and phase 1 is run once
   more on this simulation's own operators before it is driven (K5 and
   K6b on its restriction layouts): the kernel table's launches, times,
   bounds and errors all come from this one path.  The launch counts
   are set to 0 just before each timed run and read just after; every kernel the path can reach
   must have launched (all twelve in the long box), K7 or K8 on a
   banded path, and every step converged;
   then the astrocyte tissue flagship at full width (mesh_n 64, 840,015
   dofs/step, three subdomains, two membranes, float32, the tuned solver
   options, mg_banded=False): ion-batched for 12 warm-up steps (past the
   onset of the pulsed ECS source) and 10 timed steps, then per-ion
   (knp_batched=False, K11 once per GMRES iteration of every ion, K11f
   once per step and subdomain) for 12 + 5 steps; the source gate must
   be on in the timed window, K_e must have risen above its initial
   value, every run must launch K1f once per step and subdomain, the
   per-ion run must launch K11 and K11f and launch K3 only for the
   right-hand side's mass term, and
   phi_M of the two runs at step 17 must agree within 1e-3 relative L2;
   last the batched flagship with mg_banded=True for 12 + 5 steps (the
   per-ion and banded Simulations built from the batched build's mesh
   and geometry); the
   timed legs keep mg_refresh_every off, and after the timed steps of
   each batched run two steps from the state reached, which must agree
   bit for bit in every tensor of the state (where they differ, the
   first operation of the step whose output differs is printed and the
   run fails), on the banded run 4 steps continued against the same 4
   from the state saved to a checkpoint and loaded back (bitwise, or
   the run fails), then one refresh of the
   EMI hierarchy, its host payload and its install timed, with one
   step's EMI iterations before and after;
tools. inside the flagship, after the batched run's timed steps
   (``tools_phase``): ``tools/compare_solver_opts``'s ``compare`` from
   the state reached (step 22), 10 steps of the reference-parity options
   (KNP min_iter 5, restart 30, rtol 1e-7, EMI 1e-6) against 10 of TUNED,
   gated by the tool's 1e-5 relative field difference and by the tuned
   leg's first step being bitwise the simulation's own step from that
   state; ``tools/stress_mg_refresh``'s two legs on a Simulation built
   from the batched build's inputs (no mesh build; the ECS source times
   4, always on): 30 steps in chunks of 10, stale against refreshed
   every 10 steps (synchronously), both converged and finite, 2
   refreshes installed and none skipped, the ECS K+ maximum at least 1
   mM above its initial value, the per-chunk iterations printed; the
   launch counts of both (the kernels line's ``launches_tools``), every
   kernel the two reach launched;
resume. the checkpoint -> resume path at the flagship's width (mesh_n
   64, float32, the tuned options, mg_banded=True, no refresh) through
   the driver (drivers/run_stim_duration.py, traces and XDMF frames
   every 2 steps, a checkpoint every 4): a gold run of 12 steps on one
   build, a run stopped at step 6 on the same build, continued with
   resume=True on a second, with h5py built from the flagship mesh
   written to an XDMF file and read back (geometry array-equal to the
   synthetic build's); state, traces and every XDMF dataset must be bitwise equal
   between the two, and the resumed steps must run KNP iterations (the
   source turns on at step 10); without h5py the driver writes no XDMF
   series and the third build is the gold build's mesh and geometry
   with a Simulation of its own, and the line says so.
   Setup seconds a build, ms/step and iterations a leg, the bytes of a
   checkpoint and of a set of frames, a checkpoint's write and read
   seconds and 1 profiled step from the resumed state;
campaign. the campaign path on the flagship's tissue at mesh_n 20: (a)
   the driver with the campaign_300ms config (float32, a checkpoint every
   10 steps) to 1 ms, then resumed on a build of its own to 2 ms (20
   steps across the source onset), its verbose output kept as
   campaign.log, every kernel its hierarchies can reach launched; (b)
   tools/summarize_campaign on it (4 saves, t = 2 ms, the chunk lines of
   both legs read across the resume seam); (c) the float64 leg of
   tools/accuracy_flagship on the card, resumed at 1 ms, compared with
   (a)'s directory under the 30 ms envelope gates (a JSON line of its
   own); (d) (a)'s final state through the torch.distributed.checkpoint
   pair (io.save_checkpoint_dcp / load_checkpoint_dcp), bitwise;
mms. the manufactured-solution study on the card in float64
   (``systems/mms.py``): the 3-D case on the unit cube at M = 8, 16, 32
   (196,608 tetrahedra at 32) and the 2-D one at M = 8, 16, 32, each
   solved by the deflated-Jacobi CG and the Jacobi GMRES, ion-batched
   (K3) and, at M = 8 and 16, per ion (K11), on the host-assembled
   exact drift, rtol 1e-10; in 3-D also by the host LU at M = 8 and 16
   and on the CPU at M = 8.  Per field and M the L2 errors, the rates,
   iterations, setup and solve seconds.  Gates: the last rate above 1.6
   (3-D) / 1.8 (2-D) for every field; the per-ion errors within 1e-6 +
   1e-3 e of the batched ones and, at M = 16, both within as much of the
   direct ones; at M = 8 a second GPU run bitwise equal to the first,
   and GPU against CPU equal iterations and every field within 1e-9 of
   its max|u|; at the largest M of each dimension the
   path's kernels against their plain versions within 1e-13 of max|y|
   and bitwise across two launches, their launches not counted (the
   masked EMI operator, K1 and K2; K3 and K11 on the exact drift stream
   against the plain quadrature drift, and on the KNP system's streams);
   every M prints the sha256 of its host data by field; then the
   reference-scale ladder's first rungs (``tools/run_mms_ladder.py``'s
   ``ladder_rung``): 2-D M = 100 and 200 on the SA-AMG-preconditioned
   CG and batched GMRES at rtol 1e-10, the host LU and the CPU at M =
   100; gates: the rate 100 -> 200 above 1.9 for every field, the
   iterative errors within 1e-6 + 1e-3 e of the direct ones, GPU against
   CPU equal iterations and every field within 1e-9 of its max|u|; the
   iterations printed beside the JAX package's recorded ones; the
   launch counts, set to 0 before the phase, must show K1, K1f, K2, K3,
   K4 and K11;
drivers. the reference's other drivers (``knpemi_tpu_torch/drivers``),
   (a)-(f) right after phase 0, before any profiler session, and (g),
   (h) in a line of their own after the mms phase:
   (c) the benchmark scenario's kernels at its shapes, K1, K1f, K3 and
   K4 on the one cell and K2, K9 and K10 on each of its three membranes
   (5, 6, 7), float32 and float64, against their plain versions and
   bitwise across two launches where phase 1 asks it; (a)
   ``run_benchmark.solve_system`` at the driver's defaults (resolution
   0, float32) to 2 ms = 20 steps, the launch counts set to 0 just before
   and read just after (every kernel the path can reach must launch;
   the kernels line's ``launches_bench``): every field and probe trace
   finite, the ECS K_e probe above its initial 3.0930 mM once the source
   is on; (b) that scenario GPU float64 against CPU float64 for 4 steps
   across the source onset, phase 2's gates; (d) ``run_2d`` at
   resolution 1, 100 steps, against ``tests/data/golden_2d_res1.npz``
   with ``tests/test_golden_traces.py``'s gates (float64 a gate, float32
   read); (e) ``run_3d`` at its defaults; (f) 100 steps of
   ``run_calibration.run`` in float64 on the card against the CPU within
   1e-12 relative; (g) the native Vanek sweep against its plain twin on
   the batched flagship build's EMI level-0 strength graph: identical
   aggregates, both times; (h) every flagship build's host set-up with
   its ``emi_multigrid`` and ``knp_multigrid`` parts, the t = 0 EMI
   assembly's seconds and cache hit or miss and the sweeps' seconds;
   the banded flagship build assembles afresh (its cache entry is
   removed first) and the resume phase's gold leg, a build of the same
   options from the caches, must give bitwise equal hierarchy arrays
   and first step;
multi_device. the multi-device modes (``knpemi_tpu_torch/parallel``),
   after the flagship runs, every rank a process of its own: (a) SPMD,
   3-D res 1 float64, 2 steps, 4 ranks sharing the card over gloo (every
   collective staged through the host) and rank 0 alone in a one-rank
   NCCL group, each bitwise the single-device GPU step; (b) the sharded
   mode with the replicated hierarchy, the same case, within 1e-8 of the
   single-device GPU run with equal iterations; (c) the distributed
   V-cycle, the same case, the 4 ranks on the card against the same
   ranks on their CPUs (equal iterations, phi_M within 1e-9 V, c 1e-9
   relative); (d) the flagship sharded over 4 ranks on the card with the
   distributed V-cycle, rank 0's host set-up from the batched run's
   inputs: the batched run's state at step 17 carried in, steps 18-22
   held to its step 22 by the 1e-5 field-equivalence gate on phi_M and c,
   step 18 run again from the same state (the same bits), ms/step,
   collectives and bytes (sent, staged) a step, the set-up's parts and
   each rank's memory -- times of 4 processes sharing one card, not
   scaling numbers; the launch counts of rank 0 in the 5 steps (the
   kernels line's ``launches_sharded``; the sharded step's kernels must
   all launch); (e) rank 0's shards' kernels (K1/K1f, K3/K11f, K4's
   grad(phi) map, K2, K9/K10, K7/K8 on the EMI level-0 windows with their
   halo, the far add) against their plain twins (1e-5 / 1e-13 of max|y|)
   and bitwise across two launches;
4. profile, per flagship run: the
   step's four phases timed by host clock over 2 steps, then 1 step
   with each phase under a torch.profiler session of its own — device
   kernel time and busy share, kernels per step and per phase, the top
   kernels.

Host set-ups that do not need the card are built ahead on the CPU, in
processes of their own, so that the builds on the card read their
multigrid hierarchies and t = 0 EMI operators from the caches: phases 1
and 3's idealized builds while the drivers run, the sharded flagship's
distributed hierarchies while the flagship's per-ion and banded runs
go on (each line that uses them says how long the warming took and how
long the run waited for it).

Then the kernel table as one JSON line of fourteen entries (the twelve
kernels of the batched step from the long box, K11 and K11f from the
per-ion flagship run; every row also with its launches in the mms
phase, in the benchmark scenario's run, on rank 0 of the sharded
flagship, in the campaign phase and in the tools phase), the cost per solve of the
P1 operator's fill and applies (K1, K11, and K3 with its drift fill and
mass term), the card's name and power limit, and the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
Any failure raises and the script exits non-zero without that line; it
also exits non-zero when CUDA is unavailable or when the package is not
beside it.
"""

from __future__ import annotations

import contextlib
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# peak rates outside the tensor cores (NVIDIA H100 SXM data sheet)
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
TOL = {"float32": 1e-5, "float64": 1e-12}  # kernel vs plain, x max|y|
# the fills, K2 and K10 sum each row in the plain version's order, without atomics
FILL_TOL = {"float32": 1e-5, "float64": 1e-13}
EXACT = {"float32": 0.0, "float64": 0.0}  # K9 copies: the same bits
CELL_KERNELS = ("K1", "K1f", "K3", "K4")  # of the assembly kernels; the others: membranes
P1_KERNELS = ("K1", "K1f")  # of the cell kernels: the P1 operator's
# device ms (L2 flushed) of the cell-loop K1 (l = 4 box, tag 0) and K11
# (flagship ECS, first ion) that the P1 operator's kernels replaced, as
# recorded in PERF.md's kernel table: the per-solve comparison's base.
# Not measured by this script: those kernels are no longer in the tree.
CELL_LOOP_MS = {"K1": 0.0601, "K11": 0.0592}
CELL_LOOP_SOURCE = ("recorded, not measured in this run: PERF.md's kernel table, "
                    "the cell-loop kernels' device ms on an NVIDIA H100 80GB HBM3 "
                    "at 700 W")
# device ms (L2 flushed) of the designs that K3 and K6a replaced, on the
# kernel table's shapes (l = 4 box: K3 on tag 0 at B = 2, K6a on KNP tag 0
# level 0's a_ellw at B = 2), as recorded in PERF.md's kernel table: K3's
# cell loop read 0.0930 in one call and 0.0464 in the next, code unchanged
EARLIER_MS = {"K3": [0.0464, 0.0930], "K6a": [0.0514]}
EARLIER_SOURCE = ("recorded, not measured in this run: PERF.md's kernel table, the "
                  "replaced designs' device ms on an NVIDIA H100 80GB HBM3 at 700 W")


def environment(smi: str) -> dict:
    """The first line: the card, Python, and whether h5py (the XDMF
    output) and yaml (the driver's config files) import here."""
    import importlib

    found = {}
    for name in ("h5py", "yaml"):
        try:
            found[name] = getattr(importlib.import_module(name), "__version__", "present")
        except ImportError:
            found[name] = None
    return dict(phase=0, case="environment", nvidia_smi=smi, python=sys.version.split()[0],
                **found)


# the script's clock: every phase's line carries the seconds since import
# (``script_s``), where the time limit goes
_T0 = time.perf_counter()


def emit(obj):
    if "phase" in obj:
        obj = {**obj, "script_s": time.perf_counter() - _T0}
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def cuda_ms(fn, reps: int = 100, warm: int = 5) -> float:
    """Mean device time of fn() over reps launches, by CUDA events."""
    import torch

    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(fn, reps: int = 100) -> float:
    """Device time per call of fn() from ``reps`` calls captured in one CUDA
    graph and replayed (mean of 3 replays, by CUDA events): the kernels
    back to back without the host's time between launches, the inputs in
    whatever state the previous call leaves L2."""
    import torch

    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(3):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(stop) / (3 * reps)


_FLUSH = {}  # the 256 MB buffer and the profiler keys of its kernel


def _flush_l2():
    """Read and write 256 MB with one elementwise kernel: five times what
    the 50 MB L2 holds, through the SMs, so that L2 keeps nothing else."""
    import torch

    if "buf" not in _FLUSH:
        _FLUSH["buf"] = torch.zeros(256 << 20, dtype=torch.uint8, device="cuda")
    _FLUSH["buf"].bitwise_not_()


def _device_events(fn, reps: int):
    """[(profiler key, start us, duration us)] of the device events of reps
    calls of fn(), each after an L2 flush.  The card is kept busy for ~5 ms
    first (flushes, queued before the profiler starts), so that its clocks
    have risen from idle.  Device events alone: the host's events, which
    no reading here uses, took most of a session's post-processing."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(30):
        _flush_l2()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            _flush_l2()
            fn()
        torch.cuda.synchronize()
    return [(e.key, e.time_range.start, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def device_ms(fn, reps: int = 30):
    """Median over reps calls of the device time of the kernels, copies and
    sets that one fn() call launches, by torch.profiler, each call after a
    pass that evicts L2 (the pass's own kernel left out): what a caller
    pays who finds the inputs in device memory, not in L2, without the
    host's time between launches.  None where the profiler reports no
    device time."""
    import statistics

    for _ in range(3):  # the process's first profiler session may record no device event
        if _FLUSH.get("keys"):
            break
        _FLUSH["keys"] = {key for key, _, _ in _device_events(lambda: None, 3)}
    fn()
    calls = []  # device us per call: each flush opens the next call
    for key, _, us in sorted(_device_events(fn, reps), key=lambda e: e[1]):
        if key in _FLUSH["keys"]:
            calls.append(0.0)
        elif calls:
            calls[-1] += us
    calls = [t for t in calls if t > 0]  # the warm-up flushes launch no call
    return statistics.median(calls) / 1e3 if calls else None


def _map_in(m, dtype):
    """A coefficient map (``ops/ell.py``'s sliced form) with its values in
    ``dtype``."""
    import dataclasses

    return dataclasses.replace(m, sval=m.sval.to(dtype))


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _lazy(build, call):
    """A library call whose operand ``build()`` makes at its first use, so
    that only the timed cases pay for assembling it."""
    held = []

    def run():
        if not held:
            held.append(build())
        return call(held[0])
    return run


def _device_csr(rows, cols, vals, shape, dtype, device):
    """The CSR matrix on the device of numpy COO triplets, duplicates summed."""
    import numpy as np
    import torch

    idx = torch.as_tensor(np.stack([rows.ravel(), cols.ravel()]).astype(np.int64),
                          device=device)
    v = torch.as_tensor(vals.ravel(), device=device).to(dtype)
    return torch.sparse_coo_tensor(idx, v, shape).coalesce().to_sparse_csr()


def _p1_csr(op, vals):
    """The P1 operator ``op`` with slot values ``vals`` (the row-sum form)
    as a CSR matrix of their type on their device."""
    A = op.scipy_csr(vals).tocoo()
    return _device_csr(A.row, A.col, A.data, A.shape, vals.dtype, vals.device)


def _knp_coo(cells, grads, vols, w, coefs, n: int):
    """COO of dt_inv M + D K + zpsiD Drift(w) per row (dt_inv, D, zpsiD) of
    ``coefs``, block-diagonal over the rows: the operators of K3 (all rows)
    and K11 (one row), from the port's host COO helpers and the P1 drift
    element coef * vol * (w . g_i) / k."""
    import numpy as np

    from knpemi_tpu_torch.solvers import direct as D

    r, c, Me = D._mass_coo(cells, vols)
    _, _, Ke = D._stiffness_coo(cells, grads, vols)
    k = cells.shape[1]
    De = np.repeat((vols[:, None] * np.einsum("cd,ckd->ck", w, grads) / k)[:, :, None],
                   k, axis=2)
    rows, cols, vals = [], [], []
    for b, (dt_inv, Dc, zpsiD) in enumerate(coefs):
        rows.append(r + b * n)
        cols.append(c + b * n)
        vals.append(dt_inv * Me + Dc * Ke + zpsiD * De)
    return np.concatenate(rows), np.concatenate(cols), np.concatenate(vals)


def _knp_csr(cells, grads, vols, w, coefs, n: int, dtype):
    """:func:`_knp_coo`'s operator from device tensors, as a CSR on their
    device."""
    host = lambda t: t.detach().cpu().numpy()
    N = len(coefs) * n
    return _device_csr(*_knp_coo(host(cells), host(grads.double()), host(vols.double()),
                                 host(w.double()), coefs, n), (N, N), dtype, cells.device)


def _fill_map_csr(op, grads, vols=None):
    """A fill's frozen linear map as a CSR on the card, the library
    yardstick of K1f and K11f: K1f's is slots x nc, g_ci . g_cj at (the
    slot of (v_i, v_j), c) for i != j, so that vals = S wv; K11f's (with
    ``vols``) is slots x nc dim, vol_c g_cid / k (k times that at the
    diagonal slot) at (the slot of (v_i, v_j), c dim + d), so that Dr =
    S vec(w)."""
    import torch

    nc, k = op.cells.shape
    dim, dev = grads.shape[-1], grads.device
    v = op.cells.long()[:, :, None]
    slots = op.slot_ptr.long()[v // 32] + 32 * op.pos.long() + v % 32  # (nc, k, k)
    cell = torch.arange(nc, device=dev)
    if vols is None:
        off = ~torch.eye(k, dtype=torch.bool, device=dev)
        rows = slots[:, off]
        vals = (grads[:, :, None, :] * grads[:, None, :, :]).sum(-1)[:, off]
        cols, n_cols = cell[:, None].expand_as(rows), nc
    else:
        scale = 1.0 + (k - 1) * torch.eye(k, dtype=grads.dtype, device=dev)
        rows = slots[..., None].expand(nc, k, k, dim)
        vals = (vols[:, None, None, None] / k) * grads[:, :, None, :] * scale[None, :, :, None]
        cols = (cell[:, None, None, None] * dim
                + torch.arange(dim, device=dev)).expand(nc, k, k, dim)
        n_cols = nc * dim
    rows, order = rows.reshape(-1).sort()
    crow = torch.zeros(op.slots + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.bincount(rows, minlength=op.slots).cumsum(0)
    return torch.sparse_csr_tensor(crow, cols.reshape(-1)[order], vals.reshape(-1)[order],
                                   size=(op.slots, n_cols))


def _fill_extra(op, es, *inputs, scratch: int = 0):
    """What a fill case records beside its bound: the bytes the row fill
    reads and writes (the incidence list, the gathered inputs once, every
    slot written, a scratch array written and read once), the gate
    (FILL_TOL), two launches compared bit for bit, and the list's size."""
    return dict(nbytes_layout=_nbytes(op.inc_ptr, op.inc, op.pos, op.slot_ptr, *inputs)
                + op.slots * es + 2 * scratch,
                tol=FILL_TOL, repeat=True,
                shape=dict(nc=op.cells.shape[0], slots=op.slots, kmax=op.kmax,
                           incidence_entries=op.inc.numel(),
                           incidence_bytes=_nbytes(op.inc_ptr, op.inc)))


def kernel_cases(sim, dtype, tag: int = 0, mem: int = 1):
    """The seven assembly kernels at the main path's shapes — the cell
    kernels K1, K1f, K3, K4 on subdomain ``tag`` (with its own diffusion
    coefficients), the facet kernels K2, K9, K10 on membrane ``mem`` — on
    random inputs made from a seed: dicts of name, kern / plain / lib
    (calls without arguments; lib may be None), nbytes (inputs read once
    + output written once) and ops.  K1 applies the values the plain K1f
    fills; its bound counts the operator's nonzeros (a column and a value
    each), ``nbytes_slots`` the pattern's slots with their padding,
    ``bytes_cell_loop`` what the earlier one-thread-per-cell K1 read and
    wrote; K1f's bound writes one value per nonzero, ``nbytes_slots`` one
    per slot.  K2 applies the membrane's surface mass M_Gamma (the EMI
    system's values, times C_phi); its bound counts the smaller of the
    facet form's bytes (facet dofs and weights) and M_Gamma's nonzeros,
    ``nbytes_layout`` the apply's own (M_Gamma's slots).  K10 walks the membrane operator's incidence list; its
    bound reads V and the list once and writes Y once.  K2 and K10 sum
    without atomics: FILL_TOL, and two launches give the same bits."""
    import torch

    from knpemi_tpu_torch.ops import assembly as A
    from knpemi_tpu_torch.ops import ell as TE
    from knpemi_tpu_torch.ops import p1op as P

    dev = sim.device
    g = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *shape: torch.randn(*shape, generator=g, device=dev, dtype=dtype)
    pos = lambda *shape: 1.0 + torch.rand(*shape, generator=g, device=dev, dtype=dtype)
    f = lambda t: t.to(dtype)
    es = torch.empty((), dtype=dtype).element_size()

    es_, ks = sim.emi_sys.sub[tag], sim.knp_sys.sub[tag]
    mb_e = sim.emi_sys.mem[mem]
    op, op_m = es_["op"], mb_e["op"]
    cells, grads, vols = op.cells, f(es_["grads"]), f(es_["vols"])
    nc, k = cells.shape
    dim = grads.shape[-1]
    n = es_["n_dofs"]
    fd = op_m.cells  # the facets' dofs
    nf, kf = fd.shape
    n_mem = mb_e["n_mem"]
    Ns = sim.knp_sys.n_solved
    F = 3 * len(sim.ions) + 2

    x, wv = rnd(n), vols * pos(nc)
    vals = P.emi_fill_plain(op, grads, wv)  # K1's values for this wv
    # phi of the main path's size (mV), and K3's grad(phi) per cell from it
    # as the main path forms it: the drift term is then a visible share of
    # K3's output, not one below the float32 tolerance
    gmap, phi = _map_in(ks["grad"], dtype), 1e-3 * rnd(n)
    X, coef = rnd(Ns, n), f(ks["coef"])
    w = TE.ellw_matvec_plain(gmap, phi).reshape(nc, dim)
    Dr = P.drift_fill_plain(op, grads, vols, w)  # K3's drift values for this w
    xm, Mg, C_phi = rnd(n_mem), f(mb_e["M"]), sim.params.C_phi
    Xm, V = rnd(F, n_mem), rnd(2 * Ns, nf, kf)
    csr = _csr_of_sliced(gmap)
    fdl = fd.long()
    # K9 once more on the membrane less its last facet, or its last two,
    # whichever leaves nf k not a multiple of 4: the kernel's scalar tail
    fd_odd = fd[: nf - 1 if (nf - 1) * kf % 4 else nf - 2]
    scat = lambda: torch.zeros(2 * Ns, n_mem, dtype=dtype, device=dev).index_add_(
        1, fdl.reshape(-1), V.reshape(2 * Ns, -1))

    def case(name, kern, plain, lib, inputs, n_out, ops, nbytes=None, **extra):
        on = f"tag {tag}" if name.split()[0] in CELL_KERNELS else f"membrane {mem}"
        return dict(name=name, variant=on,
                    kern=lambda: kern(*inputs),
                    plain=lambda: plain(*inputs), lib=lib,
                    nbytes=nbytes or _nbytes(*inputs) + n_out * es, ops=ops, **extra)

    # the library yardsticks: torch.mv on the CSR of each operator (K1, K2:
    # the same P1 operator's; K3: from the port's host COO helpers,
    # block-diagonal over the ions)
    host = lambda t: t.detach().cpu().numpy()
    lib_k1 = _lazy(lambda: _p1_csr(op, vals), lambda csr: torch.mv(csr, x))
    lib_k2 = _lazy(lambda: _p1_csr(op_m, C_phi * Mg), lambda csr: torch.mv(csr, xm))
    lib_k3 = _lazy(lambda: _knp_csr(cells, grads, vols, w, host(coef.double()), n, dtype),
                   lambda csr: torch.mv(csr, X.reshape(-1)).reshape(Ns, n))
    k3_in = (X, op, coef, f(ks["M"]), f(ks["kst"]), Dr)
    return [
        case("K1 emi_stiffness", P.emi_stiffness, P.emi_stiffness_plain, lib_k1,
             (x, op, vals), n, 2 * op.nnz,
             nbytes=op.nnz * (4 + es) + 2 * n * es,
             nbytes_slots=op.slots * (4 + es) + _nbytes(op.slot_ptr) + 2 * n * es,
             bytes_cell_loop=_nbytes(cells, grads, wv) + 2 * n * es,
             shape=dict(n=n, nc=nc, nnz=op.nnz, slots=op.slots,
                        slots_per_nonzero=op.slots / op.nnz, pattern_bytes=op.nbytes)),
        case("K1f emi_fill", P.emi_fill, P.emi_fill_plain,
             _lazy(lambda: _fill_map_csr(op, grads), lambda csr: torch.mv(csr, wv)),
             (op, grads, wv), op.slots, nc * k * k * (2 * dim + 1),
             nbytes=_nbytes(op.cells, op.pos, grads, wv) + op.nnz * es,
             nbytes_slots=_nbytes(op.cells, op.pos, op.slot_ptr, grads, wv) + op.slots * es,
             # K1f stages the cells' pair values: k (k - 1) / 2 a cell
             **_fill_extra(op, es, grads, wv, scratch=nc * k * (k - 1) // 2 * es)),
        case("K2 surface_mass", P.surface_mass, P.surface_mass_plain, lib_k2,
             (xm, op_m, Mg, C_phi), n_mem, 2 * op_m.nnz,
             # the function's least bytes: x read and y written once, and the
             # smaller of the facet form (facet_dofs and one weight a facet)
             # and M_Gamma's nonzeros (a column and a value each), which the
             # apply reads (nbytes_layout)
             nbytes=2 * n_mem * es + min(nf * (4 * kf + es), op_m.nnz * (4 + es)),
             nbytes_layout=op_m.nnz * (4 + es) + _nbytes(op_m.slot_ptr) + 2 * n_mem * es,
             tol=FILL_TOL, repeat=True,
             shape=dict(n=n_mem, nf=nf, k=kf, nnz=op_m.nnz, slots=op_m.slots,
                        pattern_bytes=op_m.nbytes)),
        case("K3 knp_apply_batch", P.knp_apply_batch, P.knp_apply_batch_plain, lib_k3,
             k3_in, Ns * n, 2 * Ns * op.nnz * 4, **_k3_bytes(op, Ns, n, es, False),
             # K3 without its drift term, for the share the term carries
             no_drift=lambda: P.knp_apply_batch_plain(*k3_in[:5], torch.zeros_like(Dr)),
             # the drift fill (K11f) that precedes a solve's applies
             also_time={"fill_ms": lambda: P.drift_fill(op, grads, vols, w)}),
        # K4 on the grad(phi) map: a column and a value per nonzero, phi and
        # grad(phi) once; the padding slots of its slices come on top
        case("K4 ellw_matvec", TE.ellw_matvec, TE.ellw_matvec_plain,
             lambda: torch.mv(csr, phi), (gmap, phi), gmap.n_rows, 2 * gmap.nnz,
             nbytes=gmap.nnz * (4 + es) + (gmap.n_rows + n) * es,
             nbytes_slots=gmap.scol.numel() * (4 + es) + _nbytes(gmap.slot_ptr)
             + (gmap.n_rows + n) * es,
             bytes_padded=gmap.n_rows * gmap.K * (4 + es) + (gmap.n_rows + n) * es,
             tol=FILL_TOL, repeat=True,
             # the design alternative: K6a's kernel at B = 1 on the same form
             also_time={"k6a_b1_ms": lambda: TE.ellw_matvec_batch(gmap, phi[None])},
             shape=dict(rows=gmap.n_rows, cols=n, nnz=gmap.nnz, slots=gmap.scol.numel(),
                        slots_per_nnz=gmap.scol.numel() / gmap.nnz, K_padded=gmap.K,
                        source=f"tag {tag} grad(phi) map")),
        # K9 is a copy: bitwise equal to its plain version
        case("K9 facet_gather", A.facet_gather, A.facet_gather_plain,
             lambda: Xm[:, fdl], (Xm, fd), F * nf * kf, 0, tol=EXACT, repeat=True,
             shape=dict(F=F, nf=nf, k=kf, n_mem=n_mem, slots_mod_4=nf * kf % 4)),
        dict(case("K9 facet_gather", A.facet_gather, A.facet_gather_plain, None,
                  (Xm, fd_odd), F * fd_odd.shape[0] * kf, 0, tol=EXACT, repeat=True,
                  time=False, shape=dict(F=F, nf=fd_odd.shape[0], k=kf, n_mem=n_mem,
                                         slots_mod_4=fd_odd.shape[0] * kf % 4)),
             variant=f"membrane {mem}, nf k mod 4 = {fd_odd.shape[0] * kf % 4}"),
        case("K10 facet_scatter", A.facet_scatter, A.facet_scatter_plain, scat,
             (V, op_m), 2 * Ns * n_mem, 2 * Ns * nf * kf,
             nbytes=_nbytes(V, op_m.inc_ptr, op_m.inc) + 2 * Ns * n_mem * es,
             tol=FILL_TOL, repeat=True,
             shape=dict(n=n_mem, nf=nf, k=kf, F=2 * Ns,
                        incidence_entries=op_m.inc.numel())),
    ]


def _k3_bytes(op, B: int, n: int, es: int, mass_only: bool) -> dict:
    """K3's bytes: a column and three values (the mass-only apply: one)
    per nonzero, X read and Y written once, coef; beside it the same by
    the sliced ELL's slots with their padding, and the bytes of the
    cell-loop formulation it replaced (cells, grads, vols, w; X, Y)."""
    streams = 1 if mass_only else 3
    vec = 2 * B * n * es + 3 * B * es
    nc, k = op.cells.shape
    dim = 2 if k == 3 else 3
    return dict(nbytes=op.nnz * (4 + streams * es) + vec,
                nbytes_slots=op.slots * (4 + streams * es) + _nbytes(op.slot_ptr) + vec,
                bytes_cell_loop=nc * (4 * k + es * (k * dim + 1 + dim)) + vec,
                shape=dict(n=n, nc=nc, B=B, nnz=op.nnz, slots=op.slots,
                           slots_per_nonzero=op.slots / op.nnz, mass_only=mass_only))


def k3_cases(sim, dtype, phi_scale: float, Bs=(1, 2, 3), timed=()):
    """K3 on every subdomain of ``sim`` at B = ``Bs`` ions, the full apply
    (the unit mass, the unit stiffness and the drift of a w = grad(phi)
    formed by K4's plain version from a random phi of ``phi_scale``, 1 mV
    in the scenario's unit) and the right-hand side's mass-only apply, each against its
    plain version; ``timed``: the (tag, B, mass_only) to time.  Library:
    torch.mv on the block-diagonal CSR of the same operator from the
    port's host COO helpers."""
    import torch

    from knpemi_tpu_torch.ops import ell as TE
    from knpemi_tpu_torch.ops import p1op as P

    dev = sim.device
    g = torch.Generator(device=dev).manual_seed(3)
    rnd = lambda *shape: torch.randn(*shape, generator=g, device=dev, dtype=dtype)
    es = torch.empty((), dtype=dtype).element_size()
    host = lambda t: t.detach().cpu().numpy()
    cases = []
    for t, s in sim.knp_sys.sub.items():
        op, grads, vols = s["op"], s["grads"].to(dtype), s["vols"].to(dtype)
        nc, dim, n = op.cells.shape[0], grads.shape[-1], s["n_dofs"]
        phi = phi_scale * rnd(n)
        w = TE.ellw_matvec_plain(_map_in(s["grad"], dtype), phi).reshape(nc, dim)
        Dr = P.drift_fill_plain(op, grads, vols, w)
        M, Kst = s["M"].to(dtype), s["kst"].to(dtype)
        for B in Bs:
            X = rnd(B, n)
            coef = s["coef"].to(dtype)[torch.arange(B, device=dev) % s["coef"].shape[0]]
            for mass_only in (False, True):
                c = coef * torch.tensor([1.0, 0.0, 0.0], dtype=dtype, device=dev) \
                    if mass_only else coef
                args = (X, op, c, M) if mass_only else (X, op, c, M, Kst, Dr)
                w_lib = torch.zeros_like(w) if mass_only else w
                lib = _lazy(lambda op=op, grads=grads, vols=vols, w=w_lib, c=c, n=n: _knp_csr(
                                op.cells, grads, vols, w, host(c.double()), n, dtype),
                            lambda csr, X=X, n=n, B=B: torch.mv(csr, X.reshape(-1)).reshape(B, n))
                case = dict(
                    name="K3 knp_apply_batch",
                    variant=f"tag {t} B={B}" + (" mass-only" if mass_only else ""),
                    kern=lambda args=args: P.knp_apply_batch(*args),
                    plain=lambda args=args: P.knp_apply_batch_plain(*args),
                    lib=lib, ops=2 * B * op.nnz * (1 if mass_only else 4),
                    time=(t, B, mass_only) in timed,
                    **_k3_bytes(op, B, n, es, mass_only))
                if not mass_only:
                    case["no_drift"] = lambda args=args: P.knp_apply_batch_plain(
                        *args[:5], torch.zeros_like(args[5]))
                cases.append(case)
    return cases


def k11_cases(sim, dtype, phi_scale: float):
    """K11 and its drift fill K11f on every subdomain of ``sim``: K11 once
    per solved ion's scalars on tag 0 and with the first ion's on the
    others, on random x; w = grad(phi) per cell from a random phi of
    ``phi_scale`` (1 mV in the scenario's unit), formed by K4's plain
    version as the main path forms it, so that the drift term is a
    visible share of the output.  Each ion's constant values P_b are
    assembled for the check (not kept in ``sim``) from the geometry as
    the device holds it, the drift values Dr filled by the plain K11f.
    Each subdomain also holds K11 against K3: both rows of a B = 2 call
    against two K11 calls.  The library yardstick is torch.mv on the CSR
    of the same operator (P_b + z psi D Dr); the port's own K3 at B = 1
    is timed beside it.  Bounds as in :func:`kernel_cases`, with two
    value streams."""
    import torch

    from knpemi_tpu_torch.ops import ell as TE
    from knpemi_tpu_torch.ops import p1op as P
    from knpemi_tpu_torch.solvers import direct
    from knpemi_tpu_torch.systems.knp import ion_operator_values

    dev = sim.device
    g = torch.Generator(device=dev).manual_seed(2)
    rnd = lambda *shape: torch.randn(*shape, generator=g, device=dev, dtype=dtype)
    es = torch.empty((), dtype=dtype).element_size()
    dname = str(dtype).replace("torch.", "")
    ks, p = sim.knp_sys, sim.params
    cases = []
    for t, s in ks.sub.items():
        op, cells = s["op"], s["cells"]
        grads, vols = s["grads"].to(dtype), s["vols"].to(dtype)
        nc, k = cells.shape
        dim, n = grads.shape[-1], s["n_dofs"]
        phi = phi_scale * rnd(n)
        w = TE.ellw_matvec_plain(_map_in(s["grad"], dtype), phi).reshape(nc, dim)
        scal = [(1.0 / p.dt, ion.D[t], ion.z * p.psi * ion.D[t]) for ion in sim.ions[:-1]]
        # from the geometry as the device holds it (in the run dtype), and
        # K3's mass and stiffness streams from the same: the row-by-row
        # check then compares the two applies, not two roundings of it
        cells_h, gh, vh = (sim.geom.subdomains[t].cells, grads.double().cpu().numpy(),
                           vols.double().cpu().numpy())
        Pv = ion_operator_values(op, cells_h, gh, vh, 1.0 / p.dt, [sc[1] for sc in scal],
                                 dtype)
        M3 = P.mass_values(op, cells_h, vh, dtype)
        K3s = torch.as_tensor(op.assemble(direct._stiffness_coo(cells_h, gh, vh)[2])[0],
                              dtype=dtype, device=dev)
        Dr = P.drift_fill_plain(op, grads, vols, w)
        X = rnd(len(scal), n)
        geo = (cells, grads, vols, w)
        # K11 against K3, row by row
        coef_all = torch.tensor(scal, dtype=dtype, device=dev)
        k3 = lambda X, c, op=op, M=M3, Kst=K3s, Dr=Dr: P.knp_apply_batch(X, op, c, M, Kst, Dr)
        Y3 = k3(X, coef_all)
        for b, sc in enumerate(scal):
            y11 = P.knp_apply(X[b].contiguous(), op, Pv[b], Dr, sc[2])
            err, scale = float((y11 - Y3[b]).abs().max()), float(Y3[b].abs().max())
            if not err <= TOL[dname] * scale:
                raise AssertionError(f"K11 vs K3 row {b}, tag {t}, {dname}: {err:.3e} "
                                     f"exceeds {TOL[dname]:.0e} x {scale:.3e}")
        for b, sc in enumerate(scal if t == 0 else scal[:1]):
            x, Pb, zpsiD = X[b].contiguous(), Pv[b], sc[2]
            coef1 = torch.tensor([sc], dtype=dtype, device=dev)
            lib = _lazy(lambda op=op, Pb=Pb, Dr=Dr, zpsiD=zpsiD: _p1_csr(op, Pb + zpsiD * Dr),
                        lambda csr, x=x: torch.mv(csr, x))
            args = (x, op, Pb, Dr, zpsiD)
            cases.append(dict(
                name="K11 knp_apply", variant=f"tag {t} ion {sim.ions[b].name}",
                kern=lambda args=args: P.knp_apply(*args),
                plain=lambda args=args: P.knp_apply_plain(*args),
                lib=lib,
                no_drift=lambda args=args: P.knp_apply_plain(
                    *args[:3], torch.zeros_like(args[3]), args[4]),
                min_drift_share=1e-3,
                # the port's K3 at B = 1 on the same operator, and one K3
                # launch for all solved ions: what the batched solve pays
                # where the per-ion solve pays one K11 launch per ion
                also_time={
                    "k3_b1_ms": lambda x=x, k3=k3, c=coef1: k3(x[None], c)[0],
                    "k3_all_ions_ms": lambda X=X, k3=k3, c=coef_all: k3(X, c)},
                nbytes=op.nnz * (4 + 2 * es) + 2 * n * es,
                nbytes_slots=op.slots * (4 + 2 * es) + _nbytes(op.slot_ptr) + 2 * n * es,
                bytes_cell_loop=_nbytes(x, *geo) + n * es,
                ops=4 * op.nnz,
                shape=dict(n=n, nc=nc, k=k, dim=dim, nnz=op.nnz, slots=op.slots,
                           slots_per_nonzero=op.slots / op.nnz, scalars=list(sc)),
            ))
        cases.append(dict(
            name="K11f drift_fill", variant=f"tag {t}",
            kern=lambda op=op, grads=grads, vols=vols, w=w: P.drift_fill(op, grads, vols, w),
            plain=lambda op=op, grads=grads, vols=vols, w=w: P.drift_fill_plain(
                op, grads, vols, w),
            lib=_lazy(lambda op=op, grads=grads, vols=vols: _fill_map_csr(op, grads, vols),
                      lambda csr, w=w: torch.mv(csr, w.reshape(-1))),
            nbytes=_nbytes(op.cells, op.pos, grads, vols, w) + op.nnz * es,
            nbytes_slots=_nbytes(op.cells, op.pos, op.slot_ptr, grads, vols, w)
            + op.slots * es,
            ops=nc * k * (2 * dim + 1 + k),
            # K11f stages the cells' drift values: k a cell
            **_fill_extra(op, es, grads, vols, w, scratch=nc * k * es)))
    return cases


def _first_layout(levels, kind, roles):
    """(level, role, layout) of the first operator stored as ``kind``
    ('band' or 'ellw'), fine level and listed roles first."""
    for i, lv in enumerate(levels):
        for w in roles:
            if lv[f"{w}_{kind}"] is not None:
                return i, w, lv[f"{w}_{kind}"]
    return None


def _ellw_case_source(mg, dtype, roles):
    """A windowed-ELL operator of this hierarchy for the K5/K6 checks: the
    first one the build chose for one of ``roles`` (the roles in which
    the cycle hands an operator to the kernel under check) or, where it
    chose none, the layout that build_ellw gives the finest prolongator
    it accepts."""
    import numpy as np
    import scipy.sparse as sp

    from knpemi_tpu_torch.ops.ell import build_ellw

    found = _first_layout(mg.levels, "ellw", roles)
    if found is not None:
        i, w, e = found
        return e, f"level {i} {w}_ellw as built"
    for i, lv in enumerate(mg.levels):
        cols, vals = lv["p_cols"].cpu().numpy(), lv["p_vals"].double().cpu().numpy()
        rows = np.repeat(np.arange(cols.shape[0]), cols.shape[1])
        P = sp.coo_matrix((vals.ravel(), (rows, cols.ravel())),
                          shape=(cols.shape[0], mg.levels[i + 1]["n"]
                                 if i + 1 < len(mg.levels) else mg.coarse_V.shape[0]))
        P = P.tocsr()
        P.eliminate_zeros()
        host = build_ellw(P)
        if host is not None:
            return host.device(dtype, lv["p_vals"].device, sliced=True, transposed=True), (
                f"no {'/'.join(roles)} ellw operator in this build: "
                f"build_ellw of level {i} P")
    raise AssertionError("build_ellw refuses every prolongator of the hierarchy")


def _pt_layouts(mgs):
    """[(label, device ELLW)] of every layout the cycles of ``mgs`` ({name:
    DeviceMG}) restrict through (those with the transposed form K5/K6b
    read), fine level first; a layout shared by two levels once."""
    out, seen = [], set()
    for name, mg in mgs.items():
        for i, lv in enumerate(mg.levels):
            e = lv["pt_ellw"]
            if e is not None and id(e) not in seen:
                seen.add(id(e))
                out.append((f"{name} level {i} pt_ellw", e))
    return out


def _sliced_transpose(e):
    """The sliced ELL of A^T (K6a's layout and kernel, one thread per row of
    A^T) built from ``e``'s transposed form: the design alternative the
    restriction is timed against, not a route of the port."""
    import dataclasses

    import numpy as np
    import torch

    from knpemi_tpu_torch.ops import ell as TE

    ptr = e.trow_ptr.long().cpu().numpy()
    count = np.diff(ptr)
    Kt = max(int(count.max()), 1)
    rows = np.repeat(np.arange(e.n_cols), count)
    slot = np.arange(len(rows)) - ptr[rows]
    cols = np.zeros((e.n_cols, Kt), np.int32)
    vals = np.zeros((e.n_cols, Kt), e.tval.cpu().numpy().dtype)
    cols[rows, slot] = e.tcol.cpu().numpy()
    vals[rows, slot] = e.tval.cpu().numpy()
    sptr, scol, sval, nnz = TE.sliced_ell(cols, vals, e.n_rows)[:4]
    dev = e.tval.device
    return dataclasses.replace(
        e, n_rows=e.n_cols, n_cols=e.n_rows, K=Kt,
        slot_ptr=torch.as_tensor(sptr.astype(np.int32), device=dev),
        scol=torch.as_tensor(scol, device=dev), sval=torch.as_tensor(sval, device=dev),
        nnz=nnz, slot_ptr_host=sptr, trow_ptr=None, tcol=None, tval=None)


def restrict_cases(layouts, dtype, Bs, timed: bool = True):
    """K5 (B = None: the single-vector wrapper) and K6b (B >= 1) on each
    windowed-ELL layout of ``layouts`` ([(label, device ELLW)]), from its
    transposed form, inputs from a seed.  Each is held against the plain
    version (float64 to 1e-13 of max|y|) and launched twice, bitwise
    equal (``deterministic``).  Bound: an index and a value per nonzero,
    R read and Y written once; by slots: the row pointers beside them.
    The first layout's first B is timed (with ``timed``), and beside it
    the design alternative, K6a on the sliced ELL of A^T
    (``sliced_transpose_ms``)."""
    import dataclasses

    import torch

    from knpemi_tpu_torch.ops import ell as TE

    dev = layouts[0][1].tval.device
    g = torch.Generator(device=dev).manual_seed(2)
    rnd = lambda *shape: torch.randn(*shape, generator=g, device=dev, dtype=dtype)
    es = torch.empty((), dtype=dtype).element_size()
    cases = []
    for k, (src, e) in enumerate(layouts):
        e = dataclasses.replace(e, tval=e.tval.to(dtype))
        nnz, nc, nf = e.tcol.numel(), e.n_cols, e.n_rows
        csr = torch.sparse_csr_tensor(e.trow_ptr.long(), e.tcol.long(), e.tval,
                                      size=(nc, nf))
        count = (e.trow_ptr[1:] - e.trow_ptr[:-1]).double()
        # slots a nonzero of the sliced ELL of A^T: each slice of 32 rows
        # as wide as its longest
        pad = torch.nn.functional.pad(count, (0, -nc % TE.SLICE))
        sliced_slots = float(pad.reshape(-1, TE.SLICE).amax(dim=1).sum()) * TE.SLICE
        alt = []  # the sliced-A^T layout, built at its first timing
        for j, B in enumerate(Bs):
            nb = B or 1
            R = rnd(nf) if B is None else rnd(B, nf)
            vec = nb * (nf + nc) * es
            if B is None:
                name, kern, plain = "K5 ellw_rmatvec", TE.ellw_rmatvec, TE.ellw_rmatvec_plain
                lib = lambda R=R: torch.mv(csr, R)
            else:
                name, kern, plain = ("K6b ellw_rmatvec_batch", TE.ellw_rmatvec_batch,
                                     TE.ellw_rmatvec_batch_plain)
                lib = lambda R=R: torch.sparse.mm(csr, R.T)

            def alt_ms(R=R):
                if not alt:
                    alt.append(_sliced_transpose(e))
                return TE.ellw_matvec_batch(alt[0], R.reshape(-1, nf))
            cases.append(dict(
                name=name, variant=f"B={nb}", kern=lambda e=e, R=R, f=kern: f(e, R),
                plain=lambda e=e, R=R, f=plain: f(e, R), lib=lib,
                time=timed and k == 0 and j == 0, repeat=True, tol={"float64": 1e-13},
                nbytes=nnz * (4 + es) + vec, ops=2 * nnz * nb,
                nbytes_slots=nnz * (4 + es) + _nbytes(e.trow_ptr) + vec,
                also_time={"sliced_transpose_ms": alt_ms},
                shape=dict(rows=nf, cols=nc, coarse_rows=nc, nnz=nnz,
                           mean_row=float(count.mean()), max_row=int(count.max()),
                           G=e.tgroup, lanes_per_nonzero=e.tgroup * nc / max(nnz, 1),
                           slots_per_nonzero_row_major_replaced=nf * e.K / max(nnz, 1),
                           slots_per_nonzero_sliced_transpose=sliced_slots / max(nnz, 1),
                           source=src)))
    return cases


def _csr_of_sliced(e):
    """The sparse matrix a sliced-ELL device form stores, from its nonzero
    slots, as a CSR on its device."""
    import torch

    from knpemi_tpu_torch.ops import ell as TE

    keep = e.sval != 0
    rows = TE._sliced_rows(e)[keep]
    return torch.sparse_coo_tensor(torch.stack([rows, e.scol.long()[keep]]), e.sval[keep],
                                   (e.n_rows, e.n_cols)).coalesce().to_sparse_csr()


def _sliced_layouts(mgs, roles=("a", "p", "ap")):
    """[(label, device ELLW)] of every layout with a sliced form (what K4
    and K6a read) in the hierarchies ``mgs`` ({name: DeviceMG}), fine level and
    roles a, p, ap first; a layout shared by two roles once."""
    out, seen = [], set()
    for name, mg in mgs.items():
        for i, lv in enumerate(mg.levels):
            for w in roles:
                e = lv[f"{w}_ellw"]
                if e is not None and e.slot_ptr is not None and id(e) not in seen:
                    seen.add(id(e))
                    out.append((f"{name} level {i} {w}_ellw", e))
    return out


def _csr_of_window(win, n, m, dtype):
    """The sparse matrix one packed window of a banded operator stores,
    from its nonzero slots."""
    import torch

    from knpemi_tpu_torch.ops import banded as TB

    keep = win.val != 0
    rows = TB._slot_rows(win)[keep]
    cols = win.w0.long()[rows // win.R] + (win.off.long()[keep] & 0xFFFF)
    inside = (rows < n) & (cols < m)
    return torch.sparse_coo_tensor(
        torch.stack([rows[inside], cols[inside]]), win.val[keep][inside].to(dtype),
        (n, m)).coalesce().to_sparse_csr()


def _bands(levels, every: bool):
    """(level, role, window index, band) of the banded operators: every
    window of every level and role, or only the first window of the first
    banded operator (fine level and roles a, ap, p, pt first)."""
    out = [(i, w, j, lv[f"{w}_band"]) for i, lv in enumerate(levels)
           for w in ("a", "ap", "p", "pt") if lv[f"{w}_band"] is not None
           for j in range(len(lv[f"{w}_band"]["windows"]))]
    return out if every else out[:1]


def _far_bands(mg):
    """[(label, band)] of every banded operator of a DeviceMG that has a far
    remainder (the entries its windows do not cover), fine level first."""
    return [(f"level {i} {w}_band", lv[f"{w}_band"]) for i, lv in enumerate(mg.levels)
            for w in ("a", "ap", "p", "pt")
            if lv[f"{w}_band"] is not None and lv[f"{w}_band"]["far"] is not None]


def far_cases(mg, hname: str, dtype, Bs, seed: int = 3):
    """The far remainder's add Y += F X (``ell.csr_add``: K5's kernel on one
    vector, B = None, K6b's on a batch of B) on every banded operator of
    ``mg`` that has one, inputs from a seed.  Each is held against the
    plain version (float64 to 1e-13 of max|y|) and launched twice,
    bitwise equal; each check adds into a copy of Y, the timed calls into
    one Y of their own.  The first operator's first B is timed.  Bound:
    the entries (an index and a value each), the columns of X they read
    and the rows of Y they add to, read and written once (``nbytes_slots``:
    row_ptr beside them); the library call is torch.addmv / torch.addmm
    on the CSR of F."""
    import dataclasses

    import torch

    from knpemi_tpu_torch.ops import ell as TE

    bands = _far_bands(mg)
    if not bands:
        return []
    dev = bands[0][1]["far"].val.device
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, generator=g, device=dev, dtype=dtype)
    es = torch.empty((), dtype=dtype).element_size()
    cases = []
    for k, (src, band) in enumerate(bands):
        f = dataclasses.replace(band["far"], val=band["far"].val.to(dtype))
        n, m = f.n_rows, f.n_cols
        ptr = f.row_ptr.long()
        nnz = int(ptr[-1])
        csr = torch.sparse_csr_tensor(ptr, f.col[:nnz].long(), f.val[:nnz], size=(n, m))
        live = int((ptr[1:] > ptr[:-1]).sum())
        used = int(torch.unique(f.col[:nnz]).numel())
        for j, B in enumerate(Bs):
            nb = B or 1
            X, Y = (rnd(m), rnd(n)) if B is None else (rnd(B, m), rnd(B, n))
            Yt = Y.clone()
            if B is None:
                name, what = "K5 ellw_rmatvec", "one vector"
                lib = lambda X=X, Y=Y, csr=csr: torch.addmv(Y, csr, X)
            else:
                name, what = "K6b ellw_rmatvec_batch", f"B={B}"
                lib = lambda X=X, Y=Y, csr=csr: torch.addmm(Y.T, csr, X.T)
            vec = nb * (used + 2 * live) * es
            cases.append(dict(
                name=name, variant=f"far add {what} {hname} {src}",
                kern=lambda f=f, X=X, Y=Y: TE.csr_add(f, X, Y.clone()),
                plain=lambda f=f, X=X, Y=Y: TE.csr_add_plain(f, X, Y.clone()),
                timed=dict(kern=lambda f=f, X=X, Y=Yt: TE.csr_add(f, X, Y),
                           plain=lambda f=f, X=X, Y=Yt: TE.csr_add_plain(f, X, Y)),
                lib=lib, time=k == 0 and j == 0, repeat=True, tol={"float64": 1e-13},
                nbytes=nnz * (4 + es) + vec, ops=(2 * nnz + live) * nb,
                nbytes_slots=nnz * (4 + es) + _nbytes(f.row_ptr) + vec,
                shape=dict(rows=n, cols=m, nnz=nnz, capacity=f.col.numel(),
                           live_rows=live, columns_read=used, G=f.group,
                           source=f"{hname} {src}")))
    return cases


def mg_kernel_cases(sim, dtype, knp_tag: int = 0, emi: bool = True,
                    as_built_only: bool = False, all_bands: bool = False):
    """The multigrid kernels at the shapes of ``sim``'s banded
    hierarchies: with ``emi``, K4 (the single-vector gather on a level
    operator or prolongator), K5 and K7 on operators of the EMI
    hierarchy; K6a, K6b and K8 on operators of the KNP hierarchy of
    ``knp_tag`` at B = 2 (the solved ions) and once at B = 8 (K6b also
    at 3); the restrictions K5 and K6b on the transposed form of a pt
    layout (:func:`restrict_cases`; with ``all_bands`` on every one), K4
    and K6a on a level operator or prolongator; last, the far remainder's
    add on K5's and K6b's kernel (:func:`far_cases`) on every banded
    operator of these hierarchies that has one.  A hierarchy that
    stores no operator in a kernel's layout gets, for the windowed-ELL
    kernels, the layout build_ellw gives one of its prolongators, and for
    the banded ones an error — or, with ``as_built_only``, no case: the
    caller then checks which kernels its cases cover.  K7/K8 run on the
    first banded window (fine level first) or, with ``all_bands``, on
    every window of every level and role, each with its values in the
    run dtype and in bfloat16, by both routes of reading x.  Bounds count
    what the matrix needs: K7/K8 a value and a 2-byte offset per nonzero,
    the window starts and the vectors; K4-K6 an index and a value per
    nonzero and the vectors.  The kernels read padding slots too, whose
    bytes stand beside the bound as ``bytes_padded`` (``nbytes_slots``
    for K6a and the restrictions)."""
    import dataclasses

    import torch

    from knpemi_tpu_torch.ops import banded as TB
    from knpemi_tpu_torch.ops import ell as TE

    dev = sim.device
    g = torch.Generator(device=dev).manual_seed(1)
    rnd = lambda *shape: torch.randn(*shape, generator=g, device=dev, dtype=dtype)
    es = torch.empty((), dtype=dtype).element_size()
    emi_mg, knp = sim.emi_solver.mg, sim.knp_solver.mg[knp_tag]
    cases = []

    def k4_cases(mg, hname):
        """K4 on every windowed-ELL layout the single-vector cycle of ``mg``
        applies forward (A, P, AP; with ``as_built_only``, none where the
        build chose none, else the layout build_ellw gives a prolongator),
        each timed; float64 to 1e-13 of max|y| and two launches bitwise
        equal."""
        layouts = _sliced_layouts({hname: mg})
        if not layouts:
            if as_built_only:
                return
            e, src = _ellw_case_source(mg, dtype, ("a", "p", "ap"))
            layouts = [(f"{hname} {src}", e)]
        for src, e in layouts:
            e = dataclasses.replace(e, sval=e.sval.to(dtype))
            csr = _csr_of_sliced(e)
            x = rnd(e.n_cols)
            vec = (e.n_rows + e.n_cols) * es
            slots = e.scol.numel()
            cases.append(dict(
                name="K4 ellw_matvec", variant=src,
                kern=lambda e=e, x=x: TE.ellw_matvec(e, x),
                plain=lambda e=e, x=x: TE.ellw_matvec_plain(e, x),
                lib=lambda csr=csr, x=x: torch.mv(csr, x),
                nbytes=e.nnz * (4 + es) + vec, ops=2 * e.nnz,
                nbytes_slots=slots * (4 + es) + _nbytes(e.slot_ptr) + vec,
                # what the earlier row-major form read: K (a power of two of
                # at least 8) slots a row
                bytes_padded=e.n_rows * e.K * (4 + es) + vec,
                tol={"float64": 1e-13}, repeat=True,
                # the design alternative: K6a's kernel at B = 1 on the same form
                also_time={"k6a_b1_ms": lambda e=e, x=x: TE.ellw_matvec_batch(e, x[None])},
                shape=dict(rows=e.n_rows, cols=e.n_cols, K_padded=e.K, nnz=e.nnz,
                           slots=slots, slots_per_nnz=slots / max(e.nnz, 1),
                           slots_per_nnz_padded=e.n_rows * e.K / max(e.nnz, 1),
                           source=src)))

    def rst_cases(mgs, Bs):
        """K5/K6b on the first restriction layout of ``mgs`` or, with
        ``all_bands``, on every one; where none was built, on the layout
        build_ellw gives a prolongator (none with ``as_built_only``)."""
        layouts = _pt_layouts(mgs)
        if not layouts:
            if as_built_only:
                return
            first = next(iter(mgs))
            e, src = _ellw_case_source(mgs[first], dtype, ("pt",))
            layouts = [(f"{first} {src}", e)]
        cases.extend(restrict_cases(layouts if all_bands else layouts[:1], dtype, Bs))

    def band_cases(name, mg, hname, batch, Bs):
        bands = _bands(mg.levels, all_bands)
        if not bands and as_built_only:
            return
        if not bands:
            raise AssertionError(f"{name}: no banded operator in the hierarchy")
        mv = TB.banded_matvec_batch if batch else TB.banded_matvec
        pl = TB.banded_matvec_batch_plain if batch else TB.banded_matvec_plain
        for k, (i, w, j, band) in enumerate(bands):
            # timed: the first (the kernel table's row) and level 1's A
            timed = k == 0 or (i, w, j) == (1, "a", 0)
            win_run = band["windows"][j]
            win_run = dataclasses.replace(win_run, val=win_run.val.to(dtype))
            n, m, W, R = band["n"], band["m"], win_run.W, win_run.R
            csr = _csr_of_window(win_run, n, m, dtype)
            for B in Bs:
                V = rnd(B, m) if batch else rnd(m)
                for win in (win_run, dataclasses.replace(
                        win_run, val=win_run.val.to(torch.bfloat16))):
                    ves = win.val.element_size()
                    sname = str(win.val.dtype).replace("torch.", "")
                    lib = (lambda V=V, csr=csr: torch.sparse.mm(csr, V.T)) if batch else (
                        lambda V=V, csr=csr: torch.mv(csr, V))
                    # both ways of reading x, each held against the plain version
                    routes = {"l2": lambda s=win, V=V, n=n: mv(s, V, n, route="l2")}
                    if B * W * es <= TB.STAGE_MAX_BYTES:
                        routes["staged"] = lambda s=win, V=V, n=n: mv(s, V, n, route="staged")
                    slots = win.val.numel()
                    cases.append(dict(
                        name=name, variant=f"B={B} slab={sname}",
                        kern=lambda s=win, V=V, n=n: mv(s, V, n),
                        plain=lambda s=win, V=V, n=n: pl(s, V, n),
                        # the library call works on the run-dtype matrix
                        lib=lib if win is win_run else None,
                        routes=routes, time=timed,
                        # the nonzeros (a value and a 2-byte offset each),
                        # the window starts, x and y: what this matrix needs
                        nbytes=win.nnz * (ves + 2) + _nbytes(win.w0) + B * (m + n) * es,
                        ops=2 * win.nnz * B,
                        # what the kernel reads beside that: the padding slots
                        # and slot_ptr; and the dense slab of the earlier design
                        bytes_padded=slots * (ves + 2) + _nbytes(win.slot_ptr, win.w0)
                        + B * (m + n) * es,
                        bytes_dense_slab=win.NB * W * R * ves + _nbytes(win.w0)
                        + B * (m + n) * es,
                        shape=dict(NB=win.NB, R=R, W=W, n=n, m=m, nnz=win.nnz,
                                   slots=slots, slots_per_nonzero=slots / max(win.nnz, 1),
                                   packed_bytes=win.nbytes,
                                   source=f"{hname} level {i} {w}_band window {j}")))

    def k6a_cases(mgs, Bs):
        """K6a on the sliced form of the first batched windowed-ELL layout
        of ``mgs`` or, with ``all_bands``, of every one."""
        layouts = _sliced_layouts(mgs)
        if not layouts:
            if as_built_only:
                return
            first = next(iter(mgs))
            e, src = _ellw_case_source(mgs[first], dtype, ("a", "p", "ap"))
            layouts = [(f"{first} {src}", e)]
        for k, (src, e) in enumerate(layouts if all_bands else layouts[:1]):
            e = dataclasses.replace(e, sval=e.sval.to(dtype))
            csr = _csr_of_sliced(e)
            rows = TE._sliced_rows(e)[e.sval != 0]
            count = torch.bincount(rows, minlength=e.n_rows)[: e.n_rows].double()
            slots = e.scol.numel()
            for B in Bs:
                X = rnd(B, e.n_cols)
                vec = B * (e.n_cols + e.n_rows) * es
                cases.append(dict(
                    name="K6a ellw_matvec_batch", variant=f"B={B}",
                    kern=lambda e=e, X=X: TE.ellw_matvec_batch(e, X),
                    plain=lambda e=e, X=X: TE.ellw_matvec_batch_plain(e, X),
                    lib=lambda X=X, csr=csr: torch.sparse.mm(csr, X.T),
                    time=k == 0 and B == 2,
                    nbytes=e.nnz * (4 + es) + vec, ops=2 * e.nnz * B,
                    nbytes_slots=slots * (4 + es) + _nbytes(e.slot_ptr) + vec,
                    bytes_padded=e.n_rows * e.K * (4 + es) + vec,
                    shape=dict(rows=e.n_rows, cols=e.n_cols, K=e.K, nnz=e.nnz, slots=slots,
                               mean_row=float(count.mean()), max_row=int(count.max()),
                               slots_per_nonzero_row_major=e.n_rows * e.K / max(e.nnz, 1),
                               slots_per_nonzero_sliced=slots / max(e.nnz, 1),
                               source=src)))

    kname = f"KNP tag {knp_tag}"
    if emi:
        rst_cases({"EMI": emi_mg}, (None,))
    knp_mgs = {kname: knp}
    if all_bands:
        knp_mgs.update({f"KNP tag {t}": mg for t, mg in sorted(sim.knp_solver.mg.items())
                        if t != knp_tag})
    k6a_cases(knp_mgs, (2, 1, 8))  # B = 2 first: the kernel table's row
    rst_cases(knp_mgs, (2, 3, 8))
    if emi:
        band_cases("K7 banded_matvec", emi_mg, "EMI", False, (1,))
    band_cases("K8 banded_matvec_batch", knp, kname, True, (2, 8))
    if emi:
        # after the others: the order of the random inputs above is kept
        k4_cases(emi_mg, "EMI")
        cases.extend(far_cases(emi_mg, "EMI", dtype, (None,)))
    for hname, mg in knp_mgs.items():
        cases.extend(far_cases(mg, hname, dtype, (2, 1, 8)))
    return cases


def check_cases(cases, dtype, time_them: bool):
    """Run each case's kernel against its plain version (tolerance TOL of
    the vector dtype, times max|y|), and each other route of the kernel
    too; with ``time_them`` also time, for the cases not marked
    ``time=False``, kernel, routes, plain version and library call and
    compute the bound.  Times: ``ms``, ``plain_ms``, ``library_ms`` are
    device times with L2 flushed (:func:`device_ms`; the time per call by
    CUDA events where the profiler sees no device time); ``graph_ms`` the
    kernel's time per call from 100 calls replayed as one CUDA graph
    (:func:`graph_ms`); ``call_ms`` and ``library_call_ms`` the time per
    call of back-to-back calls by CUDA events, the host's time between
    launches included."""
    import torch

    dname = str(dtype).replace("torch.", "")
    dev_ms = lambda fn: device_ms(fn) or cuda_ms(fn, reps=20)
    rows = []
    for c in cases:
        label = " ".join(filter(None, [c["name"], c.get("variant"), dname]))
        y_ref = None
        row = dict(name=c["name"], dtype=dname)
        tol = c.get("tol", {}).get(dname, TOL[dname])
        for route, fn in [(None, c["kern"]), *c.get("routes", {}).items()]:
            y = fn()
            torch.cuda.synchronize()
            if y_ref is None:
                y_ref = c["plain"]()
                scale = float(y_ref.abs().max()) or 1.0
            err = float((y - y_ref).abs().max())
            if y.shape != y_ref.shape or not (err <= tol * scale) \
                    or not bool(torch.isfinite(y).all()):
                raise AssertionError(
                    f"{label} {route or ''}: max|kernel - plain| = {err:.3e} exceeds "
                    f"{tol:.0e} x max|y| = {tol * scale:.3e}")
            row["max_abs_err" if route is None else f"max_abs_err_{route}"] = err
            if route is None and c.get("repeat"):
                # a second launch on the same inputs: the same bits
                row["deterministic"] = bool(torch.equal(c["kern"](), y))
                if not row["deterministic"]:
                    raise AssertionError(f"{label}: two launches differ")
        row["max_abs_y"] = scale
        for key in ("variant", "shape", "bytes_padded"):
            if key in c:
                row[key] = c[key]
        if "no_drift" in c:
            # share of the operator's output that the drift term carries
            row["drift_share"] = float((y_ref - c["no_drift"]()).abs().max()) / scale
            if row["drift_share"] < c.get("min_drift_share", 0.0):
                raise AssertionError(f"{label}: the drift term is only "
                                     f"{row['drift_share']:.3e} of max|y|")
        if time_them and c.get("time", True):
            t_bytes = c["nbytes"] / HBM_BYTES_PER_S * 1e3
            t_ops = c["ops"] / PEAK_FLOPS[dname] * 1e3
            # an in-place case times calls on inputs of their own
            kern, plain = (c.get("timed", {}).get(k, c[k]) for k in ("kern", "plain"))
            row.update(
                ms=dev_ms(kern), graph_ms=graph_ms(kern), call_ms=cuda_ms(kern),
                plain_ms=dev_ms(plain),
                library_ms=None if c["lib"] is None else dev_ms(c["lib"]),
                library_call_ms=None if c["lib"] is None else cuda_ms(c["lib"], reps=20),
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=c["nbytes"], ops=c["ops"],
            )
            for key, out in (("bytes_dense_slab", "dense_slab_bound_ms"),
                             ("nbytes_slots", "bound_slots_ms"),
                             ("nbytes_layout", "bound_layout_ms"),
                             ("bytes_cell_loop", "cell_loop_bound_ms")):
                if key in c:
                    row[out] = c[key] / HBM_BYTES_PER_S * 1e3
            if "nbytes_layout" in c:
                row["nbytes_layout"] = c["nbytes_layout"]
            for route, fn in c.get("routes", {}).items():
                row[f"ms_{route}"] = dev_ms(fn)
            for key, fn in c.get("also_time", {}).items():
                row[key] = dev_ms(fn)
        rows.append(row)
    # the flush buffer must not count in a later run's peak memory
    _FLUSH.pop("buf", None)
    return rows


def check_kernels(sim, dtype, time_them: bool):
    return check_cases(kernel_cases(sim, dtype), dtype, time_them)


def check_mg_kernels(sim, dtype, time_them: bool, all_bands: bool = False):
    return check_cases(mg_kernel_cases(sim, dtype, all_bands=all_bands), dtype, time_them)


def check_k11(sim, dtype, time_them: bool, phi_scale: float):
    return check_cases(k11_cases(sim, dtype, phi_scale), dtype, time_them)


def p1_elsewhere(sim, dtype):
    """K1 and K1f on every subdomain of ``sim`` but the first (which
    :func:`check_kernels` holds), untimed."""
    return check_cases(
        [c for t in sorted(sim.knp_sys.sub)[1:] for c in kernel_cases(sim, dtype, tag=t)
         if c["name"].split()[0] in P1_KERNELS], dtype, time_them=False)


def check_all_operators(sim, dtype, time_them: bool, timed=None):
    """Every kernel of the batched step at every shape ``sim`` gives it:
    the cell kernels K1, K1f, K3, K4 on each subdomain, the facet kernels K2,
    K9, K10 on each membrane and, with mg_banded, the multigrid kernels
    on the layouts the EMI hierarchy and each subdomain's KNP hierarchy
    took (those layouts only; the kernels they cover must be the ones
    the step can reach) — K7/K8 on every banded window of every level of
    the EMI hierarchy and of the first subdomain's KNP hierarchy.
    ``timed``: with ``time_them``, the cases to time (None: all)."""
    tags, mems = sorted(sim.knp_sys.sub), sorted(sim.emi_sys.mem)
    on_cells = lambda c: c["name"].split()[0] in CELL_KERNELS
    cases = []
    for t in tags:
        cases += filter(on_cells, kernel_cases(sim, dtype, tag=t, mem=mems[0]))
    for m in mems:
        cases += [c for c in kernel_cases(sim, dtype, tag=tags[0], mem=m)
                  if not on_cells(c)]
    if sim.opts.mg_banded:
        for i, t in enumerate(tags):
            cases += mg_kernel_cases(sim, dtype, knp_tag=t, emi=i == 0,
                                     as_built_only=True, all_bands=i == 0)
        covered = {c["name"].split()[0] for c in cases}
        missed = {k for k in reachable_kernels(sim) if k not in K11_CASES} - covered
        if missed:
            raise AssertionError(f"no phase-1 case for {sorted(missed)}")
    if timed is not None:
        cases = [c if timed(c) else {**c, "time": False} for c in cases]
    return check_cases(cases, dtype, time_them)


def kernels_line_case(c) -> bool:
    """The banded flagship's cases whose times the kernels line and the
    kernel table read: K4 on the EMI level-0 P and the far adds."""
    v = c.get("variant", "")
    return (c["name"] == "K4 ellw_matvec" and v == "EMI level 0 p_ellw") or \
        v.startswith("far add")


def max_rel(a, b):
    import torch

    return float(((a - b).abs() / b.abs().clamp_min(1e-300)).max())


def gpu_vs_cpu(g, c, label: str, unit: str = "V"):
    """max|d phi_M| and max relative d c between a GPU state ``g`` and a CPU
    state ``c``: the phase-2 gates, 1e-9 each."""
    dphi = max(float((g.phi_M[m].cpu() - c.phi_M[m]).abs().max()) for m in c.phi_M)
    dc = max(max_rel(g.c[t].cpu(), c.c[t]) for t in c.c)
    if not (dphi <= 1e-9 and dc <= 1e-9):
        raise AssertionError(f"{label}: GPU vs CPU: max|d phi_M| {dphi:.3e} {unit}, "
                             f"max rel d c {dc:.3e} (gates 1e-9)")
    return dphi, dc


def shared_mesh(build_idealized):
    """``build_idealized`` for the res-2 runs and phase 2: a case (dim,
    resolution, l, g_syn_bar, dtype) is built once in full; its later
    builds with solver options take a copy of that build's mesh, geometry
    and membrane models (:func:`simulation_inputs`) and build the
    Simulation anew with their options on their device -- the same
    Simulation, bitwise, less the mesh and geometry's seconds a build."""
    import copy

    from knpemi_tpu_torch.parallel.programs import simulation_inputs, simulation_of

    inputs = {}

    def build(**kw):
        key = tuple(sorted((k, v) for k, v in kw.items()
                           if k not in ("device", "solver_options")))
        if kw.get("solver_options") is None or key not in inputs:
            sim = build_idealized(**kw)
            inputs.setdefault(key, simulation_inputs(sim))
            return sim
        return simulation_of(copy.deepcopy(inputs[key]), kw.get("device"),
                             kw["solver_options"])

    return build


# -- host set-ups built ahead, on the CPU, in processes of their own ----------
# the idealized builds of phases 1 and 3 (res 2 in both layouts, then the
# l = 4 box), float32 as the card's runs build them
WARM_BOXES = {
    "res2": [dict(dim=3, resolution=2, g_syn_bar=10.0, banded=b) for b in (False, True)],
    "box": [dict(dim=3, resolution=2, l=4, g_syn_bar=10.0, banded=True)],
}
WARM_THREADS = 2  # intra-op and BLAS threads of a warming process
_WARMERS = []


def warm_caches(what: str) -> None:
    """Build host set-ups on the CPU so that the multigrid hierarchy cache
    and the t = 0 EMI assembly cache hold their entries when the card's
    run builds the same set-ups: a host set-up does not depend on the
    device, and both caches are keyed by the operators.  ``what``: a key
    of WARM_BOXES, or the path of a flagship's pickled simulation inputs,
    whose distributed hierarchies over 4 ranks ``multi_device`` (d)
    builds.  Run by :func:`start_warming` in a process of its own."""
    import torch

    from knpemi_tpu_torch.sim import SolverOptions, build_idealized

    torch.set_num_threads(WARM_THREADS)
    if what not in WARM_BOXES:
        from knpemi_tpu_torch.parallel.programs import simulation_from
        from knpemi_tpu_torch.parallel.sharded import warm_distributed_hierarchies
        from knpemi_tpu_torch.sim import stepper

        # the flagship's t = 0 EMI operator assembled in a directory of this
        # process's own: the banded flagship build, running meanwhile,
        # removes the shared entry to assemble afresh
        with tempfile.TemporaryDirectory() as tmp:
            stepper.CACHE_DIR = Path(tmp)
            warm_distributed_hierarchies(simulation_from(what, "cpu"), 4)
        return
    build = shared_mesh(build_idealized)
    for kw in WARM_BOXES[what]:
        kw = dict(kw)
        opts = SolverOptions(mg_banded=kw.pop("banded"))
        build(**kw, dtype=torch.float32, device="cpu", solver_options=opts)


def start_warming(what: str, call: str | None = None) -> dict:
    """:func:`warm_caches` of ``what`` (or ``call``, a call of a function of
    this module written out, e.g. ``"phase2_cpu(...)"``) in a new Python
    process with WARM_THREADS threads, its output to a temporary file;
    :func:`finish_warming` waits for it."""
    import os

    root = Path(__file__).resolve().parent
    log = tempfile.NamedTemporaryFile(prefix="chip_smoke_warm_", suffix=".log", delete=False)
    threads = str(WARM_THREADS)
    env = {**os.environ, "OMP_NUM_THREADS": threads, "OPENBLAS_NUM_THREADS": threads,
           "MKL_NUM_THREADS": threads}
    code = f"import sys; sys.path.insert(0, {str(root)!r}); import chip_smoke; " \
           f"chip_smoke.{call or f'warm_caches({what!r})'}"
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=root, env=env,
                            stdout=log, stderr=subprocess.STDOUT)
    w = dict(what=what, proc=proc, log=log.name, t0=time.perf_counter())
    _WARMERS.append(w)
    return w


def finish_warming(w: dict, timeout: float = 900.0) -> dict:
    """Wait for a warming process; a failed one fails the run with its
    output.  Returns its seconds from start to end and the seconds waited
    here."""
    t0 = time.perf_counter()
    rc = w["proc"].wait(timeout=timeout)
    waited = time.perf_counter() - t0
    text = Path(w["log"]).read_text(errors="replace")
    Path(w["log"]).unlink(missing_ok=True)
    _WARMERS.remove(w)
    if rc != 0:
        raise AssertionError(f"warming {w['what']!r} failed (exit {rc}):\n{text[-4000:]}")
    return dict(seconds=time.perf_counter() - w["t0"], waited_seconds=waited)


def stop_warming() -> None:
    """End every warming process still running (the run failed)."""
    while _WARMERS:
        w = _WARMERS.pop()
        if w["proc"].poll() is None:
            w["proc"].kill()
        w["proc"].wait()
        Path(w["log"]).unlink(missing_ok=True)
        if "dir" in w:
            shutil.rmtree(w["dir"], ignore_errors=True)


# -- phase 2: GPU against CPU, float64 ----------------------------------------
# Each case runs a leg on the card and one on the CPU.  The CPU legs run in
# a process of their own (:func:`start_phase2_cpu`), beside the card's
# runs, each writing its record and final state to a file; phase 2 runs the
# card's legs and holds them against those files.
PHASE2_DEVICE = "cuda"  # where the legs held against the CPU's run
# the 3-D case of parity, parity_refresh and the multigrid option cases
PARITY_CASE = dict(dim=3, resolution=1, g_syn_bar=10.0)
PARITY_PATHS = {"ell": dict(mg_banded=False), "banded": dict(mg_banded=True),
                "banded_per_ion": dict(mg_banded=True, knp_batched=False)}
REFRESH_PATHS = {"ell": False, "banded": True}
PARITY_ASTRO_MESH_N = 20  # the astrocyte config's own resolution 0
# the constants of this module the CPU process is handed (a CPU test of the
# flow cuts them)
PHASE2_KNOBS = ("PARITY_CASE", "PARITY_ASTRO_MESH_N", "OPTION_CASES", "OPTION_CASES_2D",
                "CYCLE_APPLY_CASES")


def _parity_leg(build_idealized, SolverOptions, path: str, dev: str):
    """2 float64 steps of PARITY_CASE on ``dev`` with the options of
    PARITY_PATHS[path]; on the card the launches must match the kernels
    the hierarchies reach (the per-ion banded path must reach K7 and
    K11).  Returns (record, state)."""
    import torch

    from knpemi_tpu_torch import ops

    opts = PARITY_PATHS[path]
    t0 = time.perf_counter()
    sim = build_idealized(**PARITY_CASE, dtype=torch.float64, device=dev,
                          solver_options=SolverOptions(**opts))
    ops.reset_launch_counts()
    s, it_e, it_k, ok = sim.run(sim.init_state(), 2)
    rec = dict(emi_iters=it_e.tolist(), knp_iters=it_k.tolist(),
               seconds=time.perf_counter() - t0)
    if opts["mg_banded"]:
        rec["emi_layout"] = sim.emi_solver.mg.layout()
    if dev == "cuda":
        rec["launches"] = counts = ops.launch_counts()
        reach = reachable_kernels(sim)
        wrong = [k for k, v in counts.items() if bool(v) != (k.split()[0] in reach)]
        if wrong or (path == "banded_per_ion" and not {"K7", "K11"} <= reach):
            raise AssertionError(f"{path}_{dev}: launches {counts} do not match the "
                                 f"reachable kernels {sorted(reach)}")
    return rec, s


def parity(build_idealized, SolverOptions, cpu: dict):
    """2 float64 steps of the 3-D res-1 scenario on the GPU and the CPU:
    ion-batched with ELL and with banded multigrid, and per-ion with
    banded multigrid (the KNP V-cycles then run on single vectors: the
    GPU run must launch K7 and K11, and neither K6a, K6b nor K8).
    ``cpu``: the CPU legs by key (:func:`load_cpu_legs`)."""
    out = {}
    states = {}
    for path in PARITY_PATHS:
        out[f"{path}_cuda"], states[f"{path}_cuda"] = _parity_leg(
            build_idealized, SolverOptions, path, PHASE2_DEVICE)
        out[f"{path}_cpu"], states[f"{path}_cpu"] = cpu[f"parity {path}"]
    for path in PARITY_PATHS:
        # the per-ion solve stops each ion on its own: held to its own CPU run
        ref = out["banded_per_ion_cpu" if path == "banded_per_ion" else "ell_cpu"]
        for dev in ("cuda", "cpu"):
            o = out[f"{path}_{dev}"]
            if o["emi_iters"] != ref["emi_iters"] or o["knp_iters"] != ref["knp_iters"]:
                raise AssertionError(f"iteration counts differ ({path}_{dev}): {out}")
        out[f"{path}_max_abs_dphi_M_V"], out[f"{path}_max_rel_dc"] = gpu_vs_cpu(
            states[f"{path}_cuda"], states[f"{path}_cpu"], path)
    return out


def _astrocyte_leg(build_astrocyte, baseline, SolverOptions, name: str, dev: str):
    """2 float64 steps of the astrocyte tissue at PARITY_ASTRO_MESH_N on
    ``dev``, ion-batched (``name`` "batched") or per-ion."""
    import torch

    t0 = time.perf_counter()
    sim = build_astrocyte(
        {**baseline, "mesh_n": PARITY_ASTRO_MESH_N}, dtype=torch.float64, device=dev,
        solver_options=SolverOptions(rtol_emi=1e-6, rtol_knp=1e-7,
                                     knp_batched=name == "batched"))
    s, it_e, it_k, ok = sim.run(sim.init_state(), 2)
    return dict(emi_iters=it_e.tolist(), knp_iters=it_k.tolist(),
                seconds=time.perf_counter() - t0), s


def parity_astrocyte(build_astrocyte, baseline, SolverOptions, cpu: dict):
    """2 float64 steps of the astrocyte tissue scenario at mesh_n 20 (the
    config's own resolution 0) on the GPU and the CPU, ion-batched and
    per-ion.  Units: phi_M in mV, concentrations in mM."""
    out = {}
    for name in ("batched", "per_ion"):
        g, gs = _astrocyte_leg(build_astrocyte, baseline, SolverOptions, name, PHASE2_DEVICE)
        c, cs = cpu[f"astrocyte {name}"]
        out[f"{name}_cuda"], out[f"{name}_cpu"] = g, c
        if g["emi_iters"] != c["emi_iters"] or g["knp_iters"] != c["knp_iters"]:
            raise AssertionError(f"{name}: iteration counts differ GPU vs CPU: {out}")
        out[f"{name}_max_abs_dphi_M_mV"], out[f"{name}_max_rel_dc"] = gpu_vs_cpu(
            gs, cs, name, "mV")
    return out


def phase_ms(sim, state, n_steps: int):
    """Host-clock ms per step of the step's four phases over n_steps
    steps: Simulation.step opens each phase through the span handed to
    it, and this span synchronizes the device at both ends."""
    import contextlib

    import torch

    acc = {}

    @contextlib.contextmanager
    def span(name):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        key = name.split("/", 1)[1]
        acc[key] = acc.get(key, 0.0) + (time.perf_counter() - t0) * 1e3 / n_steps

    for _ in range(n_steps):
        state = sim.step(state, span=span)
    return acc


# steps under torch.profiler in phase 4: one, since the profiler's
# post-processing takes seconds a step and the script has 20 minutes
PROFILED_STEPS = 1


def profile_steps(sim, state, n_steps: int, ms_per_step: float):
    """n_steps profiled, each of the step's four phases under a
    torch.profiler session of its own: device kernel time per step, its
    share of the unprofiled step time, device events (memory copies and
    sets included) per step and per phase, and the kernels with the most
    device time, from the same steps.  Device events alone: the step
    phases' host times are :func:`phase_ms`'s, and the host events'
    post-processing took seconds a profiled step."""
    import contextlib

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # (the host's events only where there is no card: the CPU flow tests)
    acts = [ProfilerActivity.CUDA if torch.cuda.is_available() else ProfilerActivity.CPU]
    per_phase, by_key = {}, {}  # events a phase; [calls, device us] a kernel

    @contextlib.contextmanager
    def span(name):
        with profile(activities=acts) as prof:
            yield
            torch.cuda.synchronize()
        phase = name.split("/", 1)[1]
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            per_phase[phase] = per_phase.get(phase, 0) + e.count / n_steps
            acc = by_key.setdefault(e.key, [0, 0.0])
            acc[0] += e.count
            acc[1] += getattr(e, "self_device_time_total", 0) or 0

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        state = sim.step(state, span=span)
    wall = time.perf_counter() - t0
    dev_ms = sum(us for _, us in by_key.values()) / 1e3 / n_steps
    top = sorted(by_key.items(), key=lambda kv: kv[1][1], reverse=True)[:12]
    return dict(
        steps=n_steps, profiled_ms_per_step=wall / n_steps * 1e3,
        device_kernel_ms_per_step=dev_ms if dev_ms else "not measured",
        device_busy_share=dev_ms / ms_per_step if dev_ms else "not measured",
        kernels_per_step=sum(n for n, _ in by_key.values()) / n_steps,
        phase_kernels_per_step=per_phase,
        top_kernels=[dict(name=k[:90], ms_per_step=us / 1e3 / n_steps,
                          calls_per_step=n / n_steps) for k, (n, us) in top],
    )


# K-number -> (source file, file:line of the TPU kernel it replaces)
KERNEL_SOURCES = {
    "K1": ("cells", "knpemi_tpu/ops/pallas_assembly.py:364"),
    "K1f": ("cells", "knpemi_tpu/ops/pallas_assembly.py:364"),
    "K2": ("cells", "knpemi_tpu/ops/pallas_assembly.py:653"),
    "K3": ("cells", "knpemi_tpu/ops/pallas_assembly.py:444"),
    "K4": ("mg", "knpemi_tpu/ops/pallas_ell.py:330"),
    "K5": ("mg", "knpemi_tpu/ops/pallas_ell.py:347"),
    "K6a": ("mg", "knpemi_tpu/ops/pallas_ell.py:476"),
    "K6b": ("mg", "knpemi_tpu/ops/pallas_ell.py:494"),
    "K7": ("mg", "knpemi_tpu/ops/pallas_banded.py:38"),
    "K8": ("mg", "knpemi_tpu/ops/pallas_banded.py:89"),
    "K9": ("facets", "knpemi_tpu/ops/pallas_assembly.py:742"),
    "K10": ("facets", "knpemi_tpu/ops/pallas_assembly.py:758"),
    "K11": ("cells", "knpemi_tpu/ops/pallas_assembly.py:397"),
    "K11f": ("cells", "knpemi_tpu/ops/pallas_assembly.py:397"),
}
# the far remainder's adds among K5's and K6b's launches (ell.csr_add's count)
FAR_ADD = "K5/K6b csr_add"
# the assembly kernels of every step (K11f fills the drift of both KNP
# branches), the per-ion KNP solve's own, and the ion-batched step's
ASSEMBLY = ("K1", "K1f", "K2", "K3", "K4", "K9", "K10", "K11f")
PER_ION = ("K11",)
BATCHED_PATH = tuple(k for k in KERNEL_SOURCES if k not in PER_ION)
# held by check_k11 on every subdomain, not by check_all_operators
K11_CASES = ("K11", "K11f")


def reachable_kernels(sim):
    """K-numbers the step of ``sim`` can launch: the eight assembly kernels
    (K11f on both KNP branches), K11 on the per-ion branch and, from the
    layouts its hierarchies took, the multigrid ones (the per-ion branch runs the KNP V-cycles
    on single vectors: K5/K7 in place of K6a/K6b/K8).  A banded layout
    with a far remainder reaches K5's kernel (K6b's on the batched
    cycle): it adds that remainder."""
    out = set(ASSEMBLY)
    batched = sim.opts.knp_batched
    if not batched:
        out.update(PER_ION)
    emi = sim.emi_solver.mg.layout()
    knp = [lv for mg in sim.knp_solver.mg.values() for lv in mg.layout()]
    forms = lambda lay, roles: {lv[w] for lv in lay for w in roles}
    single = emi if batched else emi + knp
    far = lambda mgs: any(_far_bands(mg) for mg in mgs)
    knp_mgs = list(sim.knp_solver.mg.values())
    if "band" in forms(single, ("A", "P", "Pt", "AP")):
        out.add("K7")
    if "ellw" in forms(single, ("Pt",)) or far([sim.emi_solver.mg]
                                               + ([] if batched else knp_mgs)):
        out.add("K5")
    if batched and far(knp_mgs):
        out.add("K6b")
    if batched:
        if "band" in forms(knp, ("A", "P", "Pt", "AP")):
            out.add("K8")
        if "ellw" in forms(knp, ("A", "P", "AP")):
            out.add("K6a")
        if "ellw" in forms(knp, ("Pt",)):
            out.add("K6b")
    return out


def run_slice(sim, label: str, case: str, n_steps: int, setup_s: float,
              profile: bool = True, need=(), other_bytes: int = 0,
              warm: int = 2, keep_at: int = 0):
    """Phases 3 and 4 for one simulation: ``warm`` warm-up steps, set the
    launch counts to 0, time n_steps, read the counts, check the result
    (every kernel the hierarchies can reach, and every K-number in
    ``need``, launched); then, with ``profile``, phase 4.  ``other_bytes``
    of device memory belong to another simulation and are taken off the
    peak.  Returns the record printed, with two fields more: ``state``,
    reached at the end of the timed steps (before phase 4), and ``kept``,
    the state after ``keep_at`` of the timed steps."""
    import numpy as np
    import torch

    from knpemi_tpu_torch import ops
    from knpemi_tpu_torch.ops import ell as TE
    from knpemi_tpu_torch.sim import dofs_per_step

    t0 = time.perf_counter()
    state = sim.init_state()
    state, it_e0, it_k0, _ = sim.run(state, warm)
    # the source gate of each timed step, on the stepper's own clock
    t_k, gates = state.t, []
    for _ in range(n_steps):
        gates.append(float(sim.source_gate(t_k)))
        t_k = t_k + sim.params.dt
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t1 = time.perf_counter()
    kept = None
    if keep_at:
        kept, e1, k1, ok1 = sim.run(state, keep_at)
        state, e2, k2, ok2 = sim.run(kept, n_steps - keep_at)
        it_e, it_k, ok = (np.concatenate(p) for p in ((e1, e2), (k1, k2), (ok1, ok2)))
    else:
        state, it_e, it_k, ok = sim.run(state, n_steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = {**ops.launch_counts(), FAR_ADD: TE.csr_add.launches}
    for m, v in state.phi_M.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{label}: phi_M[{m}] is not finite")
    for t, v in state.c.items():
        if not bool(torch.isfinite(v).all()) or tuple(v.shape) != (
                len(sim.ions), sim.geom.subdomains[t].n_dofs):
            raise AssertionError(f"{label}: c[{t}] is not finite or has the wrong shape")
    reach = reachable_kernels(sim)
    if not set(need) <= reach:
        raise AssertionError(f"{label}: the hierarchies built cannot reach "
                             f"{sorted(set(need) - reach)}")
    idle = [k for k, v in launches.items() if k.split()[0] in reach and not v]
    if idle:
        raise AssertionError(f"{label}: kernels of the path did not launch: "
                             f"{idle} ({launches})")
    hierarchies = [sim.emi_solver.mg, *sim.knp_solver.mg.values()]
    if any(_far_bands(mg) for mg in hierarchies) and not launches[FAR_ADD]:
        raise AssertionError(f"{label}: a far remainder was never added ({launches})")
    if sim.opts.mg_banded and not (launches["K7 banded_matvec"]
                                   or launches["K8 banded_matvec_batch"]):
        raise AssertionError(f"{label}: neither K7 nor K8 launched: {launches}")
    if not ok.all():
        raise AssertionError(f"{label}: a step did not converge")
    dofs = dofs_per_step(sim)
    rec = dict(
        phase=3, path=label, case=case,
        dofs_per_step=dofs, steps=n_steps, ms_per_step=wall / n_steps * 1e3,
        mdofs_per_s=dofs * n_steps / wall / 1e6,
        emi_iters=it_e.tolist(), knp_iters=it_k.tolist(),
        warmup_iters=[it_e0.tolist(), it_k0.tolist()],
        converged=bool(ok.all()), launches=launches,
        launches_per_step={k: v / n_steps for k, v in launches.items()},
        reachable=sorted(reach), knp_batched=sim.opts.knp_batched,
        peak_device_bytes=torch.cuda.max_memory_allocated() - other_bytes,
        host_setup_seconds=setup_s,
        # the Simulation's own parts of it (the rest: mesh and geometry)
        host_setup_parts=sim.setup_seconds,
        emi_layout=sim.emi_solver.mg.layout(),
        knp_layout={t: mg.layout() for t, mg in sim.knp_solver.mg.items()},
        # in the scenario's unit: V (idealized), mV (astrocyte)
        phi_M_range={m: [float(v.min()), float(v.max())]
                     for m, v in state.phi_M.items()},
        source_gate_on_steps=int(sum(g > 0 for g in gates)),
        c_ecs_first_ion_max=float(state.c[0][0].max()),
    )
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)
    rec.update(state=state, kept=kept)
    if not profile:
        return rec

    # -- phase 4: where the step's time goes ---------------------------------
    t0 = time.perf_counter()
    phases = phase_ms(sim, state, 2)
    prof = profile_steps(sim, state, PROFILED_STEPS, wall / n_steps * 1e3)
    emit(dict(phase=4, path=label, case=case + f", {PROFILED_STEPS} profiled step",
              phase_ms_per_step=phases, **prof, seconds=time.perf_counter() - t0))
    return rec


def bf16_slab_steps(build_idealized, SolverOptions, n_steps: int = 5):
    """SolverOptions.mg_band_bf16 driven once: n_steps float32 steps of the
    3-D res-1 scenario (every level banded there) with the fine smoothing
    slabs' packed values stored in float32 and in bfloat16.  Every step
    must converge, the bfloat16 run must hold bfloat16 fine values and
    launch K7 and K8 with them; the iteration counts of both and the
    packed bytes of the fine windows are reported."""
    import torch

    from knpemi_tpu_torch import ops

    out = {}
    for bf16 in (False, True):
        sim = build_idealized(dim=3, resolution=1, g_syn_bar=10.0,
                              dtype=torch.float32, device="cuda",
                              solver_options=SolverOptions(mg_banded=True,
                                                           mg_band_bf16=bf16))
        fine = [mg.levels[0]["a_band"] for mg in
                (sim.emi_solver.mg, *sim.knp_solver.mg.values())]
        want = torch.bfloat16 if bf16 else torch.float32
        if any(b is None for b in fine) or any(
                w.val.dtype != want for b in fine for w in b["windows"]):
            raise AssertionError(f"mg_band_bf16={bf16}: a fine level is not "
                                 f"banded or its packed values are not {want}")
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, it_e, it_k, ok = sim.run(sim.init_state(), n_steps)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / n_steps * 1e3
        launches = ops.launch_counts()
        if not ok.all() or not all(bool(torch.isfinite(v).all())
                                   for v in state.phi_M.values()):
            raise AssertionError(f"mg_band_bf16={bf16}: a step did not converge")
        if not (launches["K7 banded_matvec"] and launches["K8 banded_matvec_batch"]):
            raise AssertionError(f"mg_band_bf16={bf16}: K7/K8 idle: {launches}")
        out["bf16_slab" if bf16 else "float32_slab"] = dict(
            ms_per_step_first_steps=ms, emi_iters=it_e.tolist(),
            knp_iters=it_k.tolist(), fine_packed_bytes=sum(
                w.nbytes for b in fine for w in b["windows"]),
            fine_value_bytes=sum(_nbytes(w.val) for b in fine for w in b["windows"]))
    return out


MESH_N, FLAGSHIP_DOFS = 64, 840_015  # the flagship's width, dofs per step
# the flagship's tuned solver options
TUNED = dict(min_iter_knp=2, restart=8, rtol_knp=3e-6, rtol_emi=1e-5)


# the verification tools on the batched flagship (tools_phase): compare's
# legs from the timed run's last state, the parity leg with the astrocyte
# driver's rtols; stress at f-scale 4, always on, refreshed synchronously
TOOLS_COMPARE = dict(steps=10, chunk=10)
TOOLS_PARITY = dict(min_iter_knp=5, restart=30, rtol_knp=1e-7, rtol_emi=1e-6,
                    knp_post_smooth=True)
TOOLS_STRESS = dict(f_scale=4.0, duty=1.0, steps=30, chunk=10, refresh_every=10)
TOOLS_PATH = ("K1", "K1f", "K2", "K3", "K4", "K9", "K10", "K11f")


def tools_phase(sim, inputs: dict, state, config: dict):
    """``tools/compare_solver_opts`` and ``tools/stress_mg_refresh`` at the
    flagship's width, short depth, on the card's builds: (a) ``compare`` on
    ``sim`` (the batched flagship, built with TUNED) from ``state``, two
    legs of TOOLS_COMPARE's steps without warm-up, TOOLS_PARITY against
    TUNED: the tool's 1e-5 field gate, and the tuned leg's first step
    bitwise ``sim``'s own step from ``state`` after the comparison (the
    legs set their options and put back the built ones); (b) ``stress_legs``
    on a Simulation built from ``inputs`` (``simulation_inputs`` of
    ``sim``'s build of ``config``, no mesh build: the ions' ECS sources
    times f-scale, the gate always on; ``mg_refresh_async`` off): both legs
    converged and finite, the fresh one installs 2 refreshes and skips
    none, the ECS K+ maximum at least 1 mM above its initial value; the
    per-chunk iterations printed, not gated.  The launch counts are set to
    0 before (a) and read after (b); every kernel the two simulations
    reach (at least TOOLS_PATH) must have launched.  Returns the record,
    the launch counts under ``launches``."""
    import dataclasses

    import torch

    from knpemi_tpu_torch import ops
    from knpemi_tpu_torch.ops import ell as TE
    from knpemi_tpu_torch.parallel.programs import simulation_of
    from knpemi_tpu_torch.sim.scenarios import K_E_INIT_A
    from knpemi_tpu_torch.sim.stepper import _to_host
    from knpemi_tpu_torch.tools import compare_solver_opts as cso
    from knpemi_tpu_torch.tools import stress_mg_refresh as smr

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    cmp, states = cso.compare(sim, TOOLS_COMPARE["steps"], TOOLS_COMPARE["chunk"], TUNED,
                              state=state, warmup=False, parity=TOOLS_PARITY,
                              keep_first=True)
    differ = differing_fields(states["tuned_first"], _to_host(sim.step(state)))
    cmp.update(tuned_first_step_is_own_step=not differ, seconds=time.perf_counter() - t0)
    del states
    if differ:
        raise AssertionError(f"tools compare: the tuned leg's first step differs from the "
                             f"simulation's own step in {differ}")
    if not cmp["passed"]:
        raise AssertionError(f"tools compare: max rel field difference "
                             f"{cmp['max_rel_diff']:.3e} above {cmp['tol']:.0e}: {cmp['diffs']}")
    st = dict(TOOLS_STRESS)
    t0 = time.perf_counter()
    stressed = simulation_of(
        smr.stressed_inputs(inputs, config, st.pop("f_scale"), st.pop("duty")), sim.device,
        dataclasses.replace(inputs["opts"], mg_refresh_async=False))
    setup_s = time.perf_counter() - t0
    reach = reachable_kernels(sim) | reachable_kernels(stressed)
    stress = smr.stress_legs(stressed, **st)
    del stressed
    stress.update(setup_seconds=setup_s, seconds=time.perf_counter() - t0,
                  k_e_init=K_E_INIT_A, options=dict(TOOLS_STRESS))
    launches = {**ops.launch_counts(), FAR_ADD: TE.csr_add.launches}
    torch.cuda.empty_cache()
    if not (all(stress["converged"].values()) and all(stress["finite"].values())):
        raise AssertionError(f"tools stress: a leg did not converge or is not finite: "
                             f"{stress['converged']} {stress['finite']}")
    if stress["refresh_counts"] != {"installed": 2, "skipped": 0}:
        raise AssertionError(f"tools stress: refreshes {stress['refresh_counts']}, "
                             "expected 2 installed and none skipped")
    k_max = max(max(c["k_e_max_stale"], c["k_e_max_fresh"]) for c in stress["chunks"])
    if not k_max >= K_E_INIT_A + 1.0:
        raise AssertionError(f"tools stress: ECS K+ max {k_max} mM, not 1 mM above "
                             f"{K_E_INIT_A}")
    idle = [k for k, v in launches.items() if k.split()[0] in reach and not v]
    if idle or not set(TOOLS_PATH) <= reach:
        raise AssertionError(f"tools: kernels of the path did not launch: {idle} "
                             f"(reachable {sorted(reach)}, launches {launches})")
    return dict(compare=cmp, stress=stress, launches=launches)


def flagship(build_astrocyte, baseline, SolverOptions):
    """The astrocyte tissue flagship at full width (mesh_n 64), float32,
    the tuned solver options: the ion-batched run, the per-ion run and
    the batched run with mg_banded=True.  Before each run, phase 1 on
    that simulation's own operators, float32 (timed on the banded run,
    and K11 / K11f on the batched one) and float64: every kernel
    of the batched step on each of the three subdomains and two
    membranes (and, banded, on the layouts of the four hierarchies), K11
    and K11f on the three subdomains; then phases 3 and 4.  Returns the
    float32 rows of K11 and K11f, the launch counts of the three runs,
    the banded run's float32 row of K4 on its EMI level-0 P and its timed
    rows of the far remainder's add ({"one vector EMI": row or None,
    "B=2 KNP": row or None})."""
    import torch

    from knpemi_tpu_torch.parallel.programs import simulation_inputs, simulation_of
    from knpemi_tpu_torch.sim.scenarios import K_E_INIT_A  # initial ECS K+, mM
    from knpemi_tpu_torch.sim.stepper import _to_host

    config = {**baseline, "mesh_n": MESH_N}
    case = f"astrocyte tissue mesh_n {MESH_N} float32 tuned options"
    runs = {}
    k11_rows = k4_p = far_p = None
    for label, banded, batched, warm, n_steps in (
            ("flagship batched", False, True, 12, 10),
            ("flagship per-ion", False, False, 12, 5),
            # warmed past the source onset like the others: at rest the KNP
            # solve meets its tolerance with no iteration, and no KNP
            # V-cycle runs
            ("flagship banded", True, True, 12, 5)):
        if label == "flagship banded":
            # (h): this build assembles the t = 0 EMI operator afresh (and builds
            # its banded hierarchies afresh, the first of the call), so that the
            # resume phase's gold leg, a build of the same options from both
            # caches, has a fresh build to be held against
            Path(HOST_SETUP["emi_entry"]).unlink(missing_ok=True)
        t0 = time.perf_counter()
        opts = SolverOptions(mg_banded=banded, knp_batched=batched, **TUNED)
        if label == "flagship batched":
            sim = build_astrocyte(config, dtype=torch.float32, device="cuda",
                                  solver_options=opts)
            inputs = simulation_inputs(sim)
        else:
            # the batched build's mesh and geometry (the same arrays), the
            # Simulation built anew with this run's options: one mesh and
            # geometry build for the three runs (the script's time limit)
            sim = simulation_of(inputs, "cuda", opts)
        setup_s = time.perf_counter() - t0
        HOST_SETUP["builds"].append(setup_record(label, sim, setup_s))
        if label == "flagship batched":
            HOST_SETUP["emi_entry"] = str(sim.emi_cache_entry)
            HOST_SETUP["native_sweep"] = native_sweep_check(sim)
        if label == "flagship banded":
            HOST_SETUP["fresh"] = dict(hierarchy_sha=hierarchy_sha(sim),
                                       first_step=_to_host(sim.step(sim.init_state())))
        if (len(sim.geom.subdomains), len(sim.geom.membranes)) != (3, 2):
            raise AssertionError(f"{label}: expected 3 subdomains and 2 membranes")
        # -- phase 1 at this run's shapes; phi in mV ---------------------------
        t1 = time.perf_counter()
        # timed on the banded run only, and there only the K4 and far-add
        # rows that feed the kernels line
        rows = dict(float32=check_all_operators(sim, torch.float32, banded,
                                                timed=kernels_line_case),
                    float64=check_all_operators(sim, torch.float64, False))
        if banded:
            k4_p = next(r for r in rows["float32"] if r["name"] == "K4 ellw_matvec"
                        and r["variant"] == "EMI level 0 p_ellw")
            # the far remainder's add, timed: EMI on one vector, KNP on two
            far_p = {w: next((r for r in rows["float32"] if "ms" in r and r.get(
                "variant", "").startswith(f"far add {w}")), None)
                for w in ("one vector EMI", "B=2 KNP")}
        if k11_rows is None:
            k11_rows = check_k11(sim, torch.float32, True, phi_scale=1.0)
            rows["float32"] = rows["float32"] + k11_rows
            rows["float64"] += check_k11(sim, torch.float64, False, phi_scale=1.0)
            # K3 on every subdomain at B = 1, 2, 3, full and mass-only
            for dt, key in ((torch.float32, "float32"), (torch.float64, "float64")):
                rows[key] += check_cases(k3_cases(sim, dt, 1.0), dt, time_them=False)
        emit(dict(phase=1, path=label, setup_seconds=setup_s, **rows,
                  seconds=time.perf_counter() - t1))
        del rows
        torch.cuda.empty_cache()
        rec = runs[label] = run_slice(sim, label, case, n_steps, setup_s, warm=warm,
                                      keep_at=5 if label == "flagship batched" else 0)
        if label == "flagship batched":
            # the multi_device phase's start (step 17) and gate (step 22)
            from knpemi_tpu_torch.interop import state_to_numpy

            import pickle

            MD_CARRIED.update(kept=state_to_numpy(rec["kept"]),
                              final=state_to_numpy(rec["state"]),
                              iters=list(zip(rec["emi_iters"][5:], rec["knp_iters"][5:])),
                              setup=str(Path(tempfile.mkdtemp()) / "flagship_inputs.pkl"))
            with open(MD_CARRIED["setup"], "wb") as f:
                pickle.dump(inputs, f, protocol=4)
            # (d)'s distributed hierarchies, on the CPU beside the runs below
            MD_CARRIED["warm"] = start_warming(MD_CARRIED["setup"])
        if batched:
            det = step_determinism(sim, rec["state"])
            emit(dict(phase=3, path=label, case="two steps from one saved state", **det))
            if not det["identical"]:
                raise AssertionError(f"{label}: two steps from one saved state differ: "
                                     f"{det['differing_fields']}")
            if label == "flagship batched":
                t0 = time.perf_counter()
                tl = tools_phase(sim, inputs, rec["state"], config)
                runs_tools = tl["launches"]
                emit(dict(phase="tools", case=f"astrocyte tissue mesh_n {MESH_N} float32: "
                          f"compare_solver_opts from step {int(rec['state'].step)}, "
                          "stress_mg_refresh on the build's inputs", **tl,
                          seconds=time.perf_counter() - t0))
            if banded:
                with tempfile.TemporaryDirectory() as tmp:
                    emit(dict(phase=3, path=label, case="in-process resume: steps continued "
                              "against the same steps from the state saved and loaded back",
                              **resume_in_process(sim, rec["state"], Path(tmp))))
            # the timed legs ran without refreshes (mg_refresh_every 0, as
            # the earlier flagship numbers did); now one, as the astrocyte
            # script's cadence would make every 100 steps
            emit(dict(phase=3, path=label, case="one EMI hierarchy refresh after the "
                      "timed steps", **refresh_once(sim, rec["state"])))
        if rec["dofs_per_step"] != FLAGSHIP_DOFS:
            raise AssertionError(f"{label}: {rec['dofs_per_step']} dofs/step, "
                                 f"not {FLAGSHIP_DOFS}")
        if rec["source_gate_on_steps"] < 1:
            raise AssertionError(f"{label}: the source gate is off in every timed step")
        if not rec["c_ecs_first_ion_max"] > K_E_INIT_A + 0.1:
            raise AssertionError(f"{label}: K_e max {rec['c_ecs_first_ion_max']} mM "
                                 f"has not risen above its initial {K_E_INIT_A}")
        del sim
        torch.cuda.empty_cache()
    launches = {k: r["launches"] for k, r in runs.items()}
    launches["tools"] = runs_tools
    per_ion = launches["flagship per-ion"]
    if per_ion["K3 knp_apply_batch"] != 3 * 5:
        raise AssertionError("flagship per-ion: K3 must launch once per subdomain and "
                             f"step (the rhs mass term), got {per_ion['K3 knp_apply_batch']}")
    for label in ("flagship batched", "flagship banded"):
        if launches[label]["K11 knp_apply"]:
            raise AssertionError(f"{label}: K11 launched on the batched branch")
    # the fills: once per solve and subdomain, i.e. per step and subdomain
    for label, steps in (("flagship batched", 10), ("flagship per-ion", 5),
                         ("flagship banded", 5)):
        for fill in ("K1f emi_fill", "K11f drift_fill"):
            if launches[label][fill] != 3 * steps:
                raise AssertionError(f"{label}: {fill} must launch once per subdomain and "
                                     f"step, got {launches[label][fill]}")
    # both runs' states at step 17
    a, b = runs["flagship batched"]["kept"], runs["flagship per-ion"]["state"]
    if int(a.step) != 17 or int(b.step) != 17:
        raise AssertionError(f"steps {int(a.step)} and {int(b.step)}, expected 17")
    rel = {m: float(torch.linalg.norm(a.phi_M[m] - b.phi_M[m])
                    / torch.linalg.norm(b.phi_M[m])) for m in b.phi_M}
    if not max(rel.values()) <= 1e-3:
        raise AssertionError(f"batched vs per-ion phi_M at step 17: rel L2 {rel}")
    emit(dict(phase=3, path="flagship batched vs per-ion", step=17,
              phi_M_rel_l2=rel, gate=1e-3,
              ms_per_step={k: r["ms_per_step"] for k, r in runs.items()},
              k11_launches_per_step=per_ion["K11 knp_apply"] / 5,
              k11f_launches_per_step=per_ion["K11f drift_fill"] / 5))
    return k11_rows, launches, k4_p, far_p


# -- the multi-device phase ---------------------------------------------------
# where and how the ranks run (a CPU test of the flow sets the CPU, gloo,
# small cases); the flagship's carried states come from flagship()
MD_DEVICE, MD_NCCL, MD_THREADS = "cuda", True, None
MD_SMALL = dict(dim=3, resolution=1)
MD_FLAGSHIP = dict(mesh_n=MESH_N, keep=17, steps=5, repeat=1)
MD_CARRIED = {}
# the kernels the sharded step must launch on rank 0 (the distributed
# V-cycle's windows K7 / K8; its far add only where a level has far entries)
MD_PATH = ("K1", "K1f", "K2", "K3", "K4", "K7", "K8", "K9", "K10", "K11f")
MD_GATES = dict(spmd="bitwise", replicated=1e-8, gpu_vs_cpu=1e-9, flagship=1e-5)


def _fields_rel(a, b) -> dict:
    """max|a - b| / max|b| of every phi, phi_M and c field of two
    ``state_to_numpy`` trees (the field-equivalence gate's measure)."""
    import numpy as np

    out = {}
    for f in ("phi", "phi_M", "c"):
        for k in b[f]:
            den = float(np.abs(b[f][k]).max())
            out[f"{f}[{k}]"] = float(np.abs(a[f][k] - b[f][k]).max()) / (den or 1.0)
    return out


def _md_rec(r) -> dict:
    """The timing, collective and memory part of a sharded case's result."""
    steps = max(len(r["iters"]), 1)
    return dict(iters=r["iters"], ms_per_step=r["seconds"] / steps * 1e3,
                collectives_per_step=r["totals"]["calls"] / steps,
                bytes_per_step=r["totals"]["bytes"] / steps,
                bytes_staged_per_step=r["totals"]["staged"] / steps,
                collectives_by_site={k: v["calls"] / steps for k, v in r["counts"].items()},
                setup_seconds=r["setup_seconds"], memory=r["memory"])


def multi_device_phase(build_idealized, SolverOptions):
    """The multi-device modes (``knpemi_tpu_torch/parallel``) on the card,
    one process per rank, all cases in one launch: (a) SPMD, 3-D res 1 float64, 2 steps, 4 ranks on
    the card over gloo and 1 over NCCL, bitwise the single-device GPU
    step; (b) the sharded mode with the replicated hierarchy, the same
    case, 4 ranks, within 1e-8 of the single-device GPU run, equal
    iterations; (c) the distributed V-cycle, the same case, 4 ranks on the
    card against 4 on the CPU, equal iterations, phi_M within 1e-9 V, c
    1e-9 relative; (d) the flagship (mesh_n 64, float32, tuned options)
    sharded over 4 ranks on the card with the distributed V-cycle, from
    the batched run's state at step 17, steps 18-22 held to that run's
    step 22 by the 1e-5 field-equivalence gate, step 18 once more
    from the same state: the same bits; (e) rank 0's shards' kernels
    against their plain twins.  Returns (record, rank 0's launches in
    (d)'s steps)."""
    import functools

    import torch

    from knpemi_tpu_torch.parallel import launch, programs

    dev = MD_DEVICE
    out = {}
    b64 = functools.partial(build_idealized, **MD_SMALL, g_syn_bar=10.0, dtype=torch.float64,
                            solver_options=SolverOptions())
    if not MD_CARRIED:
        raise AssertionError("multi_device (d): no carried flagship state")
    if "warm" in MD_CARRIED:
        out["d_warmed"] = finish_warming(MD_CARRIED.pop("warm"))
    fl = MD_FLAGSHIP
    # rank 0's host set-up of (d) from the batched run's own inputs (no mesh build)
    build = functools.partial(programs.simulation_from, MD_CARRIED["setup"])
    # -- (a)-(e): one launch of 4 ranks sharing the card over gloo (one process
    # start for all cases); (c)'s CPU run on the same ranks (gloo takes their
    # CPU tensors as they are) ------------------------------------------------
    t0 = time.perf_counter()
    res = launch(programs.run_cases, 4, "gloo", dev, deadline=900, threads=MD_THREADS, args=([
        ("spmd", dict(build=b64)),
        ("sharded", dict(build=b64, distributed_mg=False, reference=True)),
        ("sharded", dict(build=b64, distributed_mg=True)),
        ("sharded", dict(build=b64, distributed_mg=True, device="cpu", threads=2))]
        # (a) once more on rank 0 alone, in a one-rank NCCL group beside gloo's
        + ([("spmd", dict(build=b64, nccl_rank0=True))] if MD_NCCL else [])
        + [("sharded", dict(build=build, n_steps=fl["steps"], distributed_mg=True,
                            state=MD_CARRIED["kept"], repeat=fl["repeat"], kernels=True,
                            keep=[fl["steps"] - 1]))],))
    out["launch_seconds"] = time.perf_counter() - t0
    a, b, c, cpu = res[0]["results"][:4]
    a1 = res[0]["results"][4] if MD_NCCL else None
    if any(r["jax"] for r in res):
        raise AssertionError("multi_device: a rank loaded JAX")
    its = lambda states: [(int(s["emi_iters"]), int(s["knp_iters"])) for s in states]
    out["a_spmd"] = dict(
        transport="4 ranks on one card over gloo (staged through the host); rank 0 alone in "
              "a one-rank NCCL group of the same launch; (c)'s CPU run on the same 4 "
              "ranks' CPU tensors",
        bitwise_gloo_4=a["bitwise"], bitwise_nccl_1=None if a1 is None else a1["bitwise"],
        iters=its(a["states"]), ref_iters=its(a["ref"]),
        collectives_per_step=a["totals"]["calls"] / 2,
        bytes_staged_per_step=a["totals"]["staged"] / 2)
    if not a["bitwise"] or (a1 is not None and not a1["bitwise"]):
        raise AssertionError("multi_device (a): the SPMD step is not the single-device "
                             f"step's bits: {out['a_spmd']}")
    rel_b = [_fields_rel(g, r) for g, r in zip(b["states"], b["ref"])]
    out["b_replicated"] = dict(**_md_rec(b), ref_iters=its(b["ref"]), max_rel=rel_b,
                               gate=MD_GATES["replicated"])
    if its(b["states"]) != its(b["ref"]) or max(
            v for r in rel_b for v in r.values()) > MD_GATES["replicated"]:
        raise AssertionError(f"multi_device (b): {out['b_replicated']}")
    dphi = max(float(abs(g["phi_M"][m] - h["phi_M"][m]).max())
               for g, h in zip(c["states"], cpu["states"]) for m in g["phi_M"])
    dc = max(_fields_rel(g, h)[f"c[{t}]"] for g, h in zip(c["states"], cpu["states"])
             for t in g["c"])
    out["c_distributed"] = dict(**_md_rec(c), cpu_iters=cpu["iters"],
                                max_abs_dphi_M_V=dphi, c_max_rel=dc,
                                gate=MD_GATES["gpu_vs_cpu"], cpu_seconds=cpu["seconds"])
    if c["iters"] != cpu["iters"] or dphi > MD_GATES["gpu_vs_cpu"] or dc > MD_GATES[
            "gpu_vs_cpu"]:
        raise AssertionError(f"multi_device (c): {out['c_distributed']}")
    # -- (d), (e): the flagship, 4 ranks sharing the card --------------------
    d0 = res[0]["results"][-1]
    rel_d = _fields_rel(d0["states"][-1], MD_CARRIED["final"])
    gated = {k: v for k, v in rel_d.items() if not k.startswith("phi[")}
    out["d_flagship"] = dict(
        case=f"astrocyte tissue mesh_n {fl['mesh_n']} float32 tuned options, distributed "
             f"V-cycle, 4 processes sharing one card over gloo: steps {fl['keep'] + 1}-"
             f"{fl['keep'] + fl['steps']} from the batched run's step {fl['keep']}",
        distributed_mg=True, **_md_rec(d0), single_device_iters=MD_CARRIED["iters"],
        max_rel_vs_single_device=rel_d, gate=MD_GATES["flagship"],
        repeat_steps=fl["repeat"], repeat_bitwise=d0["repeat_bitwise"],
        memory_per_rank=[r["results"][-1]["memory"] for r in res],
        label="times are of 4 processes sharing one card: not scaling numbers")
    if max(gated.values()) > MD_GATES["flagship"] or not d0["repeat_bitwise"]:
        raise AssertionError(f"multi_device (d): {out['d_flagship']}")
    launches = d0["launches"]
    missing = [k for k in MD_PATH if not any(n.split()[0] == k and v
                                            for n, v in launches.items())]
    if missing:
        raise AssertionError(f"multi_device (d): kernels of the path not launched on "
                             f"rank 0: {missing} ({launches})")
    checks = d0["kernel_checks"]
    out["e_kernels"] = checks
    bad = [r for r in checks if not (r["held"] and r["deterministic"])]
    if bad:
        raise AssertionError(f"multi_device (e): {bad}")
    return out, launches


def refresh_once(sim, state):
    """Simulation.refresh_mg split in its two halves on the flagship: the
    host payload (assembly, refresh_hierarchy, refill arrays; what the
    worker thread does) and the install (the copies into the device
    tensors), each timed; the EMI iterations of one step from ``state``
    before and after, and the peak device memory of the refresh.  The
    refresh must be installed (a refill that would drop more than its
    guard is refused), and every tensor of the EMI cycle must keep its
    storage."""
    import torch

    ptrs = [t.data_ptr() for t in sim.emi_solver.mg.tensors()]
    before = sim.step(state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res, err = sim._refresh_payload({t: c.cpu().numpy() for t, c in state.c.items()})
    t1 = time.perf_counter()
    if res is None:
        raise AssertionError(f"the EMI hierarchy refresh was refused: {err}")
    sim._install_refreshed(*res)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated()
    if [t.data_ptr() for t in sim.emi_solver.mg.tensors()] != ptrs:
        raise AssertionError("the refresh reallocated a tensor of the EMI cycle")
    after = sim.step(state)
    if not (bool(after.emi_ok) and bool(after.knp_ok)):
        raise AssertionError("the step after the refresh did not converge")
    return dict(payload_seconds=t1 - t0, install_seconds=t2 - t1,
                refresh_counts=dict(sim.refresh_counts),
                refill_stats=sim.refresh_stats,
                emi_iters_before=int(before.emi_iters), emi_iters_after=int(after.emi_iters),
                knp_iters_before=int(before.knp_iters), knp_iters_after=int(after.knp_iters),
                peak_device_bytes=peak)


def _fingerprint(t):
    """A 0-d device tensor of a floating tensor's bits (the sum of its
    words as integers): equal bits give equal sums, in any order."""
    import torch

    words = {2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]
    return t.detach().reshape(-1).view(words).sum(dtype=torch.int64)


def _record_step(sim, state):
    """One step of ``sim`` from ``state`` with every operation recorded in
    its order: (name, [fingerprints of its floating outputs]) for each
    ATen operation (allocations left out: their contents are undefined),
    and (name of the port kernel, None) at each launch of the port's."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    from knpemi_tpu_torch.ops import assembly as A

    seq = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = str(func)
            if "empty" not in name:
                seq.append((name, [_fingerprint(t) for t in tree_leaves(out)
                                   if isinstance(t, torch.Tensor) and t.is_floating_point()]))
            return out

    launch = A._launch

    def traced(kernel, ref, *args):
        seq.append((f"port kernel {kernel}", None))
        return launch(kernel, ref, *args)

    A._launch = traced
    try:
        with Record():
            sim.step(state)
    finally:
        A._launch = launch
    return seq


def first_difference(sim, state):
    """The first operation whose output differs between two recorded steps
    of ``sim`` from ``state`` (:func:`_record_step`), with the three
    entries before it (a port kernel among them wrote an input the
    recorder cannot see), or None where every recorded output is equal."""
    import torch

    a, b = _record_step(sim, state), _record_step(sim, state)
    # the operations agree up to d; a difference in an output comes first
    d = next((i for i, ((na, _), (nb, _)) in enumerate(zip(a, b)) if na != nb),
             min(len(a), len(b)))
    pairs = [(i, x, y) for i, ((_, fa), (_, fb)) in enumerate(zip(a[:d], b[:d])) if fa
             for x, y in zip(fa, fb)]
    if pairs:
        # (an operation on host tensors leaves its fingerprint on the host)
        stack = lambda fps: torch.stack([x.to(sim.device) for x in fps])
        bad = torch.nonzero(stack([x for _, x, _ in pairs])
                            != stack([y for _, _, y in pairs])).reshape(-1)
        if bad.numel():
            i = pairs[int(bad[0])][0]
            return dict(index=i, op=a[i][0], ops=len(a),
                        before=[n for n, _ in a[max(0, i - 3):i]],
                        differing_outputs=int(bad.numel()))
    if d < max(len(a), len(b)):
        return dict(index=d, op=a[d][0] if d < len(a) else None,
                    other_op=b[d][0] if d < len(b) else None, ops=[len(a), len(b)],
                    note="the two steps ran different operations from here")
    return None


def differing_fields(a, b, fields=None):
    """The fields of two states (``fields``, default all) whose tensors do
    not have the same bits (``torch.equal``: dtype, shape and values),
    per tag where a field is a dict."""
    import dataclasses

    import torch

    differ = []
    for name in fields or [f.name for f in dataclasses.fields(a)]:
        x, y = getattr(a, name), getattr(b, name)
        items = x.items() if isinstance(x, dict) else [(None, x)]
        for key, v in items:
            w = y.get(key) if key is not None else y
            if w is None or not torch.equal(v, w.to(v.device)):
                differ.append(name if key is None else f"{name}[{key}]")
    return differ


def step_determinism(sim, state):
    """Two steps of ``sim`` from one saved state: whether every tensor of
    the two states has the same bits and, where one does not, which
    fields differ and the first operation of the step whose output
    differs (:func:`first_difference`)."""
    t0 = time.perf_counter()
    a, b = sim.step(state), sim.step(state)
    differ = differing_fields(a, b)
    rec = dict(identical=not differ, differing_fields=differ,
               emi_iters=[int(a.emi_iters), int(b.emi_iters)],
               knp_iters=[int(a.knp_iters), int(b.knp_iters)])
    if differ:
        rec["first_difference"] = first_difference(sim, state)
    rec["seconds"] = time.perf_counter() - t0
    return rec


def resume_in_process(sim, state, workdir: Path, n_steps: int = 4):
    """The checkpoint alone, on one build: ``n_steps`` steps continued from
    ``state`` against the same steps from ``state`` saved
    (``io.save_checkpoint``) and loaded back onto the card
    (``io.load_checkpoint``).  The loaded state must equal the saved one
    and the two runs must end in the same bits in every tensor of the
    state; the checkpoint's bytes and its write and read seconds are
    reported."""
    import torch

    from knpemi_tpu_torch.io import load_checkpoint, save_checkpoint

    path = workdir / "in_process.npz"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_checkpoint(path, state)
    t1 = time.perf_counter()
    loaded, _ = load_checkpoint(path, dtype=sim.dtype)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    a, ea, ka, oka = sim.run(state, n_steps)
    b, eb, kb, okb = sim.run(loaded, n_steps)
    rec = dict(steps=n_steps, from_step=int(state.step),
               loaded_differs=differing_fields(state, loaded),
               differing_fields=differing_fields(a, b),
               emi_iters=[ea.tolist(), eb.tolist()], knp_iters=[ka.tolist(), kb.tolist()],
               checkpoint_bytes=path.stat().st_size, write_seconds=t1 - t0,
               read_seconds=t2 - t1)
    rec["identical"] = not rec["loaded_differs"] and not rec["differing_fields"]
    if not rec["identical"]:
        raise AssertionError(f"in-process resume is not bitwise: {rec}")
    if not (oka.all() and okb.all()):
        raise AssertionError("in-process resume: a step did not converge")
    return rec


# the resume phase: a gold leg of 12 steps, a split leg stopped at step 6
# and resumed; traces and XDMF frames every 2 steps, a checkpoint every 4;
# the resumed half spans the source onset at step 10
RESUME_STEPS, RESUME_STOP = 12, 6
RESUME_IO = dict(save_frequency=2, save_frequency_fields=2, checkpoint_every=4)
STATE_FIELDS = ("c", "phi", "phi_M", "ode_states", "t", "step")


def _h5_datasets(path):
    import h5py
    import numpy as np

    out = {}
    with h5py.File(path, "r") as h5:
        h5.visititems(lambda k, v: out.__setitem__(k, np.asarray(v[()]))
                      if isinstance(v, h5py.Dataset) else None)
    return out


def _geometry_differs(ga, gb):
    """The geometry arrays (subdomains, membranes) that are not equal."""
    import numpy as np

    bad = [] if ga.sub_tags == gb.sub_tags else ["sub_tags"]
    for kind, fields in (("subdomains", ("vertices", "parent_cells", "cells", "coords",
                                         "grads", "vols")),
                         ("membranes", ("facet_dofs", "facet_edofs", "facet_idofs", "areas",
                                        "mem_to_ecs", "mem_to_ics", "vertices", "coords"))):
        da, db = getattr(ga, kind), getattr(gb, kind)
        if sorted(da) != sorted(db):
            bad.append(kind)
            continue
        bad += [f"{kind}[{t}].{f}" for t in da for f in fields
                if not np.array_equal(getattr(da[t], f), getattr(db[t], f))]
    return bad


def resume_phase(baseline, workdir: Path):
    """The port's checkpoint -> resume path at the flagship's full width
    (mesh_n 64, float32, the tuned options, mg_banded=True, no refresh),
    driven through the driver (``drivers/run_stim_duration.py``): a gold
    leg of RESUME_STEPS steps, and a split leg stopped at RESUME_STOP and
    continued with ``resume=True`` on a third build.  With h5py, that
    build reads the flagship mesh written by ``io.write_mesh``
    (``build_astrocyte``'s ``mesh_file``; its geometry must be
    array-equal to the synthetic build's) and every dataset of every
    XDMF series is compared; without it the driver writes no series, the
    third build is the gold build's mesh and geometry with a Simulation of
    its own, and the line says so.  State, traces and the series must be bitwise
    equal between the legs (``identical``).  Reported: each build's
    setup seconds, each leg's ms/step (checkpoints and frames included)
    and iterations, the bytes of one checkpoint and one set of frames,
    the seconds to write and read a checkpoint, and 1 profiled step
    from the resumed state (device kernel time)."""
    import copy
    import importlib.util
    import warnings

    import numpy as np
    import torch

    from knpemi_tpu_torch.drivers import run_stim_duration as drv
    from knpemi_tpu_torch.io import load_checkpoint, save_checkpoint
    from knpemi_tpu_torch.parallel.programs import simulation_inputs, simulation_of

    h5 = importlib.util.find_spec("h5py") is not None
    dt = float(baseline.get("dt", 0.1))
    cfg = {**baseline, "mesh_n": MESH_N, "fname": "resume", **RESUME_IO,
           "solver": {**TUNED, "mg_banded": True, "mg_refresh_every": 0}}
    until = lambda n, **kw: {**cfg, "Tstop": n * dt, **kw}
    out = {k: workdir / k for k in ("gold", "split")}
    legs = {}

    def leg(name, config, resume=False, geom=None, sim=None, inputs=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if sim is None:
            sim = (drv.build_simulation(config) if inputs is None
                   else simulation_of(copy.deepcopy(inputs[0]), inputs[1]))
            legs[name] = dict(setup_seconds=time.perf_counter() - t0)
            HOST_SETUP["builds"].append(setup_record(f"resume {name}", sim,
                                                     legs[name]["setup_seconds"]))
        else:
            legs[name] = dict(setup_seconds=0.0, build="the gold leg's")
        fresh = HOST_SETUP.pop("fresh", None) if name == "gold" else None
        if fresh is not None:
            # (h): a build from both caches against the fresh banded flagship
            # build of the same options: hierarchy arrays and the first step
            sha = hierarchy_sha(sim)
            differ = differing_fields(fresh["first_step"], sim.step(sim.init_state()))
            HOST_SETUP["fresh_vs_cached"] = dict(
                fresh="flagship banded", cached="resume gold",
                hierarchy_sha_fresh=fresh["hierarchy_sha"], hierarchy_sha_cached=sha,
                first_step_differing_fields=differ,
                identical=sha == fresh["hierarchy_sha"] and not differ)
            if not HOST_SETUP["fresh_vs_cached"]["identical"]:
                raise AssertionError(f"a build from the caches differs from a fresh one: "
                                     f"{HOST_SETUP['fresh_vs_cached']}")
        if geom is not None:
            bad = _geometry_differs(geom, sim.geom)
            legs[name]["geometry_differs"] = bad[:10]
            if bad:
                raise AssertionError(f"resume: the geometry read from the mesh file "
                                     f"differs: {bad[:10]}")
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message="h5py is not installed")
            state, traces, it_e, it_k = drv.solve_system(
                config, verbose=False, outdir=str(out[name.split()[0]]), resume=resume,
                sim=sim)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        legs[name].update(steps=len(it_e), ms_per_step=wall / max(len(it_e), 1) * 1e3,
                          emi_iters=list(map(int, it_e)), knp_iters=list(map(int, it_k)))
        return sim, state, traces

    # the split leg's first part runs on the gold leg's build (a Simulation
    # keeps no state between runs; the refresh is off): one build fewer,
    # and the resumed part still runs on a build of its own
    sim, gold, tr_gold = leg("gold", until(RESUME_STEPS))
    sim, _, _ = leg("split first", until(RESUME_STOP), sim=sim)
    geom, inputs, device = sim.geom, simulation_inputs(sim), sim.device
    del sim
    torch.cuda.empty_cache()
    resumed_cfg = until(RESUME_STEPS)
    gdir, sdir = out["gold"] / "resume", out["split"] / "resume"
    if h5:
        from knpemi_tpu_torch.io import write_mesh
        from knpemi_tpu_torch.mesh import astrocyte_tissue_mesh

        t0 = time.perf_counter()
        mesh_path = workdir / "flagship_mesh.xdmf"
        write_mesh(mesh_path, astrocyte_tissue_mesh(n=MESH_N))
        mesh = dict(write_seconds=time.perf_counter() - t0,
                    bytes=mesh_path.stat().st_size
                    + mesh_path.with_suffix(".h5").stat().st_size)
        resumed_cfg["mesh_file"] = str(mesh_path)
    # without h5py the third build is the gold build's mesh and geometry
    # with a Simulation of its own (as the per-ion and banded flagship runs
    # are built): the same arrays, less the mesh's seconds
    sim, split, tr_split = leg("split resumed", resumed_cfg, resume=True,
                               geom=geom if h5 else None,
                               inputs=None if h5 else (inputs, device))
    if h5:
        series = sorted(p.name for p in gdir.glob("results_sub_*.h5"))
        dsets = {f: (_h5_datasets(gdir / f), _h5_datasets(sdir / f)) for f in series}
        xdmf_bad = [f"{f}:{k}" for f, (a, b) in dsets.items()
                    for k in sorted(set(a) | set(b))
                    if k not in a or k not in b or not np.array_equal(a[k], b[k])]
        extra = dict(
            xdmf=dict(series=series, datasets=sum(len(a) for a, _ in dsets.values()),
                      differing=xdmf_bad[:20],
                      # the frames before the checkpoint resumed from: steps 2, 6
                      differing_before_checkpoint=[x for x in xdmf_bad[:20]
                                                   if x.rsplit("/", 1)[-1] in ("0", "1")],
                      frame_bytes=sum(v.nbytes for a, _ in dsets.values()
                                      for k, v in a.items()
                                      if k.startswith("Function/") and k.endswith("/0"))),
            mesh_file=dict(mesh, geometry_equal=True))
    else:
        xdmf_bad = []
        extra = dict(xdmf="h5py not installed",
                     mesh_file="h5py not installed: read_mesh not run")
    state_bad = differing_fields(gold, split, STATE_FIELDS)
    trace_bad = [k for k in drv.TRACE_KEYS if tr_gold[k] != tr_split[k]]
    n_obs = RESUME_STOP // RESUME_IO["save_frequency"]
    trace_pre_bad = [k for k in drv.TRACE_KEYS if tr_gold[k][:n_obs] != tr_split[k][:n_obs]]
    # one checkpoint of the flagship written and read back onto the card
    io_path = workdir / "io.npz"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_checkpoint(io_path, split)
    t1 = time.perf_counter()
    back, _ = load_checkpoint(io_path, dtype=sim.dtype)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if differing_fields(split, back):
        raise AssertionError("resume: a checkpoint did not load back as it was saved")
    prof = profile_steps(sim, split, PROFILED_STEPS, legs["split resumed"]["ms_per_step"])
    del sim
    torch.cuda.empty_cache()
    return dict(
        legs=legs, identical=not (state_bad or trace_bad or xdmf_bad),
        differing_state=state_bad, differing_traces=trace_bad,
        traces_equal_before_checkpoint=not trace_pre_bad, **extra,
        checkpoint_bytes=(gdir / "ckpt.npz").stat().st_size,
        checkpoint_write_seconds=t1 - t0, checkpoint_read_seconds=t2 - t1,
        resumed_device_kernel_ms_per_step=prof["device_kernel_ms_per_step"],
        resumed_kernels_per_step=prof["kernels_per_step"], step=int(split.step))


CAMPAIGN = dict(mesh_n=20, checkpoint_every=10, legs_ms=(1.0, 2.0))
CAMPAIGN_DEVICE = "cuda"
# (c) at this size and depth, beside accuracy_flagship.GATES_30MS: float32
# against float64 differs, by less than these (the card's readings:
# 1.5e-5 mV, 1.05e-4 mV, 2.1e-7); a twin that ran in float32 reads 0
CAMPAIGN_GATES = dict(max_dphi_M_neuron_mV=1e-3, max_dphi_M_glial_mV=1e-3,
                      max_rel_dK_e=1e-5)


def campaign_phase(workdir: Path):
    """The campaign path at mesh_n 20 (see the module docstring, campaign
    (a)-(d)).  Returns (record, launches of (a))."""
    import contextlib
    import io

    import numpy as np
    import torch

    from knpemi_tpu_torch import ops
    from knpemi_tpu_torch.drivers import run_stim_duration as drv
    from knpemi_tpu_torch.io import load_checkpoint_dcp, save_checkpoint_dcp
    from knpemi_tpu_torch.ops import ell as TE
    from knpemi_tpu_torch.sim.config import load_config
    from knpemi_tpu_torch.tools import accuracy_flagship as acc
    from knpemi_tpu_torch.tools.summarize_campaign import parse_log, summarize

    base = {**load_config(drv.CONFIG_DIR / "campaign_300ms.yml"),
            "mesh_n": CAMPAIGN["mesh_n"], "checkpoint_every": CAMPAIGN["checkpoint_every"]}
    log, legs, reach = io.StringIO(), [], set()
    ops.reset_launch_counts()
    for i, tstop in enumerate(CAMPAIGN["legs_ms"]):
        t0 = time.perf_counter()
        cfg = {**base, "Tstop": tstop}
        # float32, the card's default, on either device
        sim = drv.build_simulation(cfg, CAMPAIGN_DEVICE, torch.float32)
        setup_s = time.perf_counter() - t0
        with contextlib.redirect_stdout(log):
            state, _, it_e, it_k = drv.solve_system(cfg, outdir=str(workdir), resume=i > 0,
                                                    sim=sim)
        torch.cuda.synchronize()
        legs.append(dict(setup_seconds=setup_s, seconds=time.perf_counter() - t0,
                         steps=len(it_e), emi_iters=list(map(int, it_e)),
                         knp_iters=list(map(int, it_k))))
        reach |= reachable_kernels(sim)
    launches = {**ops.launch_counts(), FAR_ADD: TE.csr_add.launches}
    idle = [k for k, v in launches.items() if k.split()[0] in reach and not v]
    if idle:
        raise AssertionError(f"campaign: kernels of the path did not launch: {idle}")
    run_dir = workdir / str(base["fname"])
    (workdir / "campaign.log").write_text(log.getvalue())
    # (b)
    summary = summarize(run_dir, workdir / "campaign.log")
    chunk_ends = parse_log(workdir / "campaign.log")[:, 0].tolist()
    n_steps = int(round(CAMPAIGN["legs_ms"][-1] / float(base["dt"])))
    save = int(base["save_frequency"])
    if (summary["n_saves"] != n_steps // save or abs(summary["t_final_ms"] - 2.0) > 1e-5
            or chunk_ends != list(range(save, n_steps + 1, save))):
        raise AssertionError(f"campaign: the summary misses its gates: {summary}, "
                             f"chunks ending at {chunk_ends}")
    # (c)
    t0 = time.perf_counter()
    twin = workdir / "twin_f64.npz"
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        for tstop in CAMPAIGN["legs_ms"]:
            acc.run_leg("f64", tstop, twin, mesh_n=CAMPAIGN["mesh_n"], config="campaign_300ms",
                        device=CAMPAIGN_DEVICE, checkpoint_every=CAMPAIGN["checkpoint_every"])
    with contextlib.redirect_stdout(io.StringIO()):
        env = acc.compare(run_dir, twin)
    emit(dict(env, case=f"campaign phase (c): float32 driver run against the float64 "
              f"accuracy leg, mesh_n {CAMPAIGN['mesh_n']}, {n_steps} steps"))
    twin_s = time.perf_counter() - t0
    gates = {k: min(lim, CAMPAIGN_GATES[k]) for k, lim in acc.GATES_30MS.items()}
    missed = {k: env[k] for k, lim in gates.items() if not 0 < env[k] <= lim}
    with np.load(twin) as f:
        twin_dtypes = sorted({str(f[k].dtype) for k in f.files if k.startswith("final_")})
    if (missed or env["final_rel_l2"] is None or "resumed at step" not in err.getvalue()
            or twin_dtypes != ["float64"]):
        raise AssertionError(f"campaign: the float64 leg misses its gates: {missed}, "
                             f"final fields {twin_dtypes}, {env}")
    # (d)
    dcp_dir = workdir / "dcp"
    t0 = time.perf_counter()
    save_checkpoint_dcp(dcp_dir, state, n_saves=summary["n_saves"])
    t1 = time.perf_counter()
    back, meta = load_checkpoint_dcp(dcp_dir, device=state.c[0].device, dtype=state.c[0].dtype)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    bad = differing_fields(state, back)
    if bad or back.c[0].device.type != state.c[0].device.type or int(meta["n_saves"]) != 4:
        raise AssertionError(f"campaign: the DCP checkpoint did not load back bitwise: {bad}")
    return dict(
        legs=legs, summary=summary, log_lines=len(log.getvalue().splitlines()),
        chunk_ends=chunk_ends, twin_seconds=twin_s, twin_final_dtypes=twin_dtypes,
        envelope=env, gates=gates,
        dcp=dict(bytes=sum(f.stat().st_size for f in dcp_dir.rglob("*") if f.is_file()),
                 write_seconds=t1 - t0, read_seconds=t2 - t1, identical=True),
        launches=launches, reachable=sorted(reach)), launches


def launch_floor_ms():
    """The launch floor: the flushed device time (:func:`device_ms`) of the
    smallest launch, a fill of one element."""
    import torch

    one = torch.empty(1, device="cuda")
    for _ in range(3):  # the first profiler sessions of a process may record nothing
        ms = device_ms(lambda: one.fill_(1.0))
        if ms is not None:
            return ms
    raise RuntimeError("the profiler reported no device time for the launch floor")


def _refresh_leg(build_idealized, SolverOptions, path: str, dev: str):
    """6 float64 steps of PARITY_CASE on ``dev`` in chunks of 2, the EMI
    hierarchy refreshed every 2 steps (synchronously), multigrid layout
    REFRESH_PATHS[path]: two refreshes installed, none skipped, every step
    converged.  Returns (record, state)."""
    import torch

    t0 = time.perf_counter()
    sim = build_idealized(**PARITY_CASE, dtype=torch.float64, device=dev,
                          solver_options=SolverOptions(
                              mg_banded=REFRESH_PATHS[path], mg_refresh_every=2,
                              mg_refresh_async=False))
    s, it_e, it_k, ok = sim.run(sim.init_state(), 6, save_every=2)
    rec = dict(emi_iters=it_e.tolist(), knp_iters=it_k.tolist(),
               refresh_counts=dict(sim.refresh_counts), seconds=time.perf_counter() - t0)
    if sim.refresh_counts != {"installed": 2, "skipped": 0} or not ok.all():
        raise AssertionError(f"refresh {path}_{dev}: {rec}")
    return rec, s


def parity_refresh(build_idealized, SolverOptions, cpu: dict):
    """6 float64 steps of the 3-D res-1 scenario in chunks of 2 with the EMI
    hierarchy refreshed every 2 steps (synchronously), on the GPU and the
    CPU, per multigrid layout: equal iteration counts, phi_M within 1e-9
    V, c within 1e-9 relative, two refreshes installed and none skipped
    on each."""
    out = {}
    for path in REFRESH_PATHS:
        g, gs = _refresh_leg(build_idealized, SolverOptions, path, PHASE2_DEVICE)
        c, cs = cpu[f"refresh {path}"]
        out[f"{path}_cuda"], out[f"{path}_cpu"] = g, c
        if path == "ell":
            sync_state = gs
        if g["emi_iters"] != c["emi_iters"] or g["knp_iters"] != c["knp_iters"]:
            raise AssertionError(f"refresh {path}: iteration counts differ: {out}")
        out[f"{path}_max_abs_dphi_M_V"], out[f"{path}_max_rel_dc"] = gpu_vs_cpu(
            gs, cs, f"refresh {path}")
    out["ell_cuda_async"] = _async_refresh(build_idealized, SolverOptions, sync_state)
    return out


def _async_refresh(build_idealized, SolverOptions, sync_state):
    """The same 6 steps on the GPU, ELL multigrid, with the refresh built on
    the worker thread while the next chunk runs on the card and installed
    at a chunk boundary: at least one refresh installed, none skipped,
    every step converged, no worker thread left after ``run``; phi_M within
    1e-9 V and c within 1e-9 relative of the synchronous GPU run (the
    refreshed preconditioner may come a chunk later; the solves meet the
    same tolerance)."""
    import threading

    import torch

    t0 = time.perf_counter()
    sim = build_idealized(**PARITY_CASE, dtype=torch.float64, device=PHASE2_DEVICE,
                          solver_options=SolverOptions(mg_refresh_every=2,
                                                       mg_refresh_async=True))
    s, it_e, it_k, ok = sim.run(sim.init_state(), 6, save_every=2)
    workers = [t.name for t in threading.enumerate() if t.name.startswith("mg-refresh")]
    counts = dict(sim.refresh_counts)
    dphi = max(float((s.phi_M[m] - sync_state.phi_M[m]).abs().max()) for m in s.phi_M)
    dc = max(max_rel(s.c[t], sync_state.c[t]) for t in s.c)
    rec = dict(emi_iters=it_e.tolist(), knp_iters=it_k.tolist(), refresh_counts=counts,
               workers_left=workers, max_abs_dphi_M_V_vs_sync=dphi, max_rel_dc_vs_sync=dc,
               seconds=time.perf_counter() - t0)
    if counts["installed"] < 1 or counts["skipped"] or workers or not ok.all():
        raise AssertionError(f"async refresh: {rec}")
    if not (dphi <= 1e-9 and dc <= 1e-9):
        raise AssertionError(f"async refresh vs synchronous: {rec} (gates 1e-9)")
    return rec


# the multigrid and solver options on the 3-D res-1 case, per layout
# (gamma: the cycle index, set on every built hierarchy), and its steps
OPTION_STEPS_3D = 1
OPTION_CASES = {
    "mg_smoother=cheby": dict(mg_smoother="cheby", mg_degree=3),
    "mg_nu=2": dict(mg_nu=2),
    "knp_post_smooth=False": dict(knp_post_smooth=False),
    "W-cycle": dict(gamma=2),
    "compensated_dots=True": dict(compensated_dots=True),
}
# the options without a hierarchy, on the 2-D res-1 case (maxiter: the
# deflated Jacobi CG's iterations at this size stay far below it)
OPTION_CASES_2D = {
    "direct=True": dict(direct=True),
    "emi_precond=jacobi": dict(emi_precond="jacobi", maxiter=4000),
}


# one cycle of a hierarchy GPU against CPU, x max|y|: the V-cycle's and
# Chebyshev's; the W-cycle's on the singular EMI operator, which amplifies
# roundoff (a 1e-15 relative change of r moves its output by 2.2e-13 of
# max|y| on the CPU at 3-D res 0, the V-cycle's by 6.5e-16)
CYCLE_APPLY_TOL = {"emi": 1e-12, "knp": 1e-12, "emi W": 1e-10}
CYCLE_APPLY_CASES = {"cheby": dict(mg_smoother="cheby", mg_degree=3), "W-cycle": dict(gamma=2)}
CYCLE_PATHS = {"ell": False, "banded": True}


def _cycle_leg(build_idealized, SolverOptions, path: str, name: str, dev: str):
    """One EMI ``DeviceMG.apply`` (one vector) and one apply_batch of the
    first KNP hierarchy (B = 2) on ``dev``, option case ``name`` of
    CYCLE_APPLY_CASES (the cycle index set on both built hierarchies), on
    the 3-D res-0 l = 1 box (coarse_max 100: three levels), float64,
    multigrid layout CYCLE_PATHS[path], from seeded host inputs.  Level 0
    smooths with its own operator where it stores one (the identity
    stands for the fine operator).  Returns ({}, (emi output, KNP output))
    on the host."""
    import torch

    opts = dict(CYCLE_APPLY_CASES[name])
    gamma = opts.pop("gamma", 1)
    sim = build_idealized(dim=3, resolution=0, l=1, g_syn_bar=10.0, dtype=torch.float64,
                          device=dev, solver_options=SolverOptions(
                              mg_banded=CYCLE_PATHS[path], mg_coarse_max=100, **opts))
    emi, knp = sim.emi_solver.mg, next(iter(sim.knp_solver.mg.values()))
    assert emi.levels
    emi.gamma = knp.gamma = gamma
    gen = torch.Generator()
    r = torch.randn(sim.emi_sys.n, generator=gen.manual_seed(0), dtype=torch.float64)
    R = torch.randn(2, knp.fine_diag.shape[0], generator=gen.manual_seed(1),
                    dtype=torch.float64)
    return {}, (emi.apply(lambda v: v, r.to(dev)).cpu(),
                knp.apply_batch(lambda V: V, R.to(dev)).cpu())


def cycle_apply_readings(build_idealized, SolverOptions, path: str, name: str, cpu: dict):
    """:func:`_cycle_leg` on the GPU against the CPU's: max|GPU - CPU| /
    max|CPU| of each apply; gates CYCLE_APPLY_TOL."""
    _, gpu = _cycle_leg(build_idealized, SolverOptions, path, name, PHASE2_DEVICE)
    _, ref = cpu[f"cycle {path}: {name}"]
    rec = {}
    for key, g, c in zip(("emi", "knp"), gpu, ref):
        rec[key] = float((g - c).abs().max() / c.abs().max())
        tol = CYCLE_APPLY_TOL["emi W" if key == "emi" and
                              CYCLE_APPLY_CASES[name].get("gamma") == 2 else key]
        if not rec[key] <= tol:
            raise AssertionError(f"{name} {path} {key} apply: GPU vs "
                                 f"CPU {rec[key]:.3e} of max|y| (gate {tol:.0e})")
    return rec


def option_runs() -> dict:
    """{label: (case, steps, options)} of :func:`parity_options`: each
    multigrid option on PARITY_CASE in both layouts, each option without a
    hierarchy on the 2-D res-1 case."""
    runs = {f"{PARITY_CASE['dim']}-D res {PARITY_CASE['resolution']} {path}: {name}":
            (PARITY_CASE, OPTION_STEPS_3D, dict(mg_banded=banded, **opts))
            for path, banded in (("ell", False), ("banded", True))
            for name, opts in OPTION_CASES.items()}
    runs.update({f"2-D res 1: {name}": (dict(dim=2, resolution=1, g_syn_bar=10.0), 2, opts)
                 for name, opts in OPTION_CASES_2D.items()})
    return runs


def _option_leg(build_idealized, SolverOptions, label: str, dev: str):
    """:func:`option_runs`' case ``label`` on ``dev``, float64: every step
    converged; on the card a run with a hierarchy launches what its
    hierarchies reach.  Returns (record, state)."""
    import torch

    from knpemi_tpu_torch import ops

    case, n_steps, opts = option_runs()[label]
    opts = dict(opts)
    gamma = opts.pop("gamma", None)
    t0 = time.perf_counter()
    sim = build_idealized(**case, dtype=torch.float64, device=dev,
                          solver_options=SolverOptions(**opts))
    if gamma:
        sim.emi_solver.mg.gamma = gamma
        for m in sim.knp_solver.mg.values():
            m.gamma = gamma
    ops.reset_launch_counts()
    s, it_e, it_k, ok = sim.run(sim.init_state(), n_steps)
    rec = dict(emi_iters=it_e.tolist(), knp_iters=it_k.tolist(),
               seconds=time.perf_counter() - t0)
    if not ok.all():
        raise AssertionError(f"{label} {dev}: a solve did not converge: {rec}")
    if dev == "cuda" and sim.emi_solver.mg is not None:
        counts = ops.launch_counts()
        reach = reachable_kernels(sim)
        wrong = [k for k, v in counts.items() if bool(v) != (k.split()[0] in reach)]
        if wrong:
            raise AssertionError(f"{label}: launches {counts} do not match the "
                                 f"reachable kernels {sorted(reach)}")
    return rec, s


def parity_options(build_idealized, SolverOptions, cpu: dict):
    """Float64 steps per solver option on the GPU and on the CPU: one step
    of each multigrid option on the 3-D res-1 case in both layouts
    (Chebyshev smoothing of degree 3, two sweeps a side, the KNP V(1,0)
    cycle, the W-cycle, compensated dots), two of each option without a
    hierarchy on the 2-D res-1 case (the host LU, the deflated Jacobi
    CG).  Gates per case: equal iteration counts, phi_M within 1e-9 V, c within
    1e-9 relative, every step converged; the 3-D GPU runs launch what
    their hierarchies reach.  Then one Chebyshev and one W-cycle GPU
    against CPU per layout (:func:`cycle_apply_readings`)."""
    out = {}
    for label in option_runs():
        g, gs = _option_leg(build_idealized, SolverOptions, label, PHASE2_DEVICE)
        c, cs = cpu[f"options {label}"]
        rec = {"cuda": g, "cpu": c}
        if g["emi_iters"] != c["emi_iters"] or g["knp_iters"] != c["knp_iters"]:
            raise AssertionError(f"{label}: iteration counts differ: {rec}")
        rec["max_abs_dphi_M_V"], rec["max_rel_dc"] = gpu_vs_cpu(gs, cs, label)
        out[label] = rec
    out["one cycle GPU vs CPU, 3-D res 0 l=1"] = {
        f"{path}: {name}": cycle_apply_readings(build_idealized, SolverOptions, path, name, cpu)
        for path in CYCLE_PATHS for name in CYCLE_APPLY_CASES}
    return out


def phase2_legs(build_idealized, build_astrocyte, baseline, SolverOptions) -> dict:
    """Every leg of phase 2 that is held against a CPU run, by key: a
    function of the device returning (record, state or outputs)."""
    import functools

    P = functools.partial
    legs = {f"parity {p}": P(_parity_leg, build_idealized, SolverOptions, p)
            for p in PARITY_PATHS}
    legs.update({f"refresh {p}": P(_refresh_leg, build_idealized, SolverOptions, p)
                 for p in REFRESH_PATHS})
    legs.update({f"astrocyte {n}": P(_astrocyte_leg, build_astrocyte, baseline,
                                     SolverOptions, n) for n in ("batched", "per_ion")})
    legs.update({f"options {label}": P(_option_leg, build_idealized, SolverOptions, label)
                 for label in option_runs()})
    legs.update({f"cycle {p}: {n}": P(_cycle_leg, build_idealized, SolverOptions, p, n)
                 for p in CYCLE_PATHS for n in CYCLE_APPLY_CASES})
    return legs


def phase2_cpu(out_dir: str, knobs: str) -> None:
    """Every leg of :func:`phase2_legs` on the CPU, in order, each written to
    ``out_dir`` as it ends (:func:`_save_leg`); ``knobs``: the JSON of
    PHASE2_KNOBS' values in the process that started this one.  Run by
    :func:`start_phase2_cpu` in a process of its own."""
    import torch

    from knpemi_tpu_torch.sim import (ASTROCYTE_BASELINE, SolverOptions, build_astrocyte,
                                      build_idealized)

    globals().update(json.loads(knobs))
    torch.set_num_threads(WARM_THREADS)
    legs = phase2_legs(shared_mesh(build_idealized), build_astrocyte, ASTROCYTE_BASELINE,
                       SolverOptions)
    for i, (key, leg) in enumerate(legs.items()):
        _save_leg(Path(out_dir) / f"leg_{i:02d}.npz", key, *leg("cpu"))


def _save_leg(path: Path, key: str, rec: dict, payload) -> None:
    """A leg's key, record (JSON) and final state (``interop.state_to_numpy``,
    per-tag fields as ``field__tag``) or outputs (``out__i``) as one npz."""
    import numpy as np

    from knpemi_tpu_torch.interop import state_to_numpy

    if isinstance(payload, tuple):
        arrays = {f"out__{i}": t.numpy() for i, t in enumerate(payload)}
    else:
        arrays = {}
        for f, v in state_to_numpy(payload).items():
            if isinstance(v, dict):
                arrays.update({f"{f}__{k}": a for k, a in v.items()})
            else:
                arrays[f] = v
    np.savez(path, key=key, rec=json.dumps(rec), **arrays)


def load_cpu_legs(out_dir) -> dict:
    """{key: (record, state on the CPU in float64, or the outputs as a
    tuple)} of every leg :func:`phase2_cpu` wrote to ``out_dir``."""
    import types

    import numpy as np
    import torch

    from knpemi_tpu_torch.interop import state_from_numpy

    legs = {}
    for path in sorted(Path(out_dir).glob("leg_*.npz")):
        with np.load(path) as f:
            tree = {}
            for name in f.files:
                if name in ("key", "rec"):
                    continue
                field, _, tag = name.partition("__")
                if tag:
                    tree.setdefault(field, {})[int(tag)] = f[name]
                else:
                    tree[field] = f[name]
            if "out" in tree:
                payload = tuple(torch.from_numpy(tree["out"][i]) for i in sorted(tree["out"]))
            else:
                payload = state_from_numpy(types.SimpleNamespace(**tree), "cpu", torch.float64)
            legs[str(f["key"])] = (json.loads(str(f["rec"])), payload)
    return legs


def start_phase2_cpu() -> dict:
    """:func:`phase2_cpu` in a new Python process (its threads capped like a
    warming process's), writing to a new temporary directory ``w["dir"]``;
    :func:`finish_phase2_cpu` waits for it."""
    out = tempfile.mkdtemp(prefix="chip_smoke_phase2_")
    knobs = json.dumps({k: globals()[k] for k in PHASE2_KNOBS})
    w = start_warming("phase 2 CPU legs", call=f"phase2_cpu({out!r}, {knobs!r})")
    w["dir"] = out
    return w


def finish_phase2_cpu(w: dict, timeout: float = 900.0):
    """Wait for the CPU legs' process (a failed one fails the run with its
    output, :func:`finish_warming`) and read what it wrote.  Returns
    (the legs by key, its seconds and the seconds waited here)."""
    try:
        timing = finish_warming(w, timeout)
        legs = load_cpu_legs(w["dir"])
    finally:
        shutil.rmtree(w["dir"], ignore_errors=True)
    missing = set(phase2_keys()) - set(legs)
    if missing:
        raise AssertionError(f"the CPU legs' process wrote no record of {sorted(missing)}")
    return legs, timing


def phase2_keys() -> list:
    """The keys of :func:`phase2_legs`, in order, without building anything."""
    return list(phase2_legs(None, None, None, None))


# the manufactured-solution study: fields, Krylov settings (the JAX
# package's tests' rtol; maxiter raised for the Jacobi GMRES at M = 32)
MMS_FIELDS = ("phi_e", "phi_i", "a_e", "b_e", "a_i", "b_i")
MMS_KRYLOV = dict(rtol=1e-10, maxiter=20000)
MMS_MS = {3: (8, 16, 32), 2: (8, 16, 32)}
MMS_GATE = {3: 1.6, 2: 1.8}  # the last rate, every field
MMS_DIRECT_MS = (8, 16)  # the host LU (3-D)
MMS_CHECK_M = 16  # iterative against direct
MMS_CPU_M = 8  # GPU against CPU
MMS_PER_ION_MS = (8, 16)  # the per-ion KNP solve (K11) beside the batched one
MMS_KERNEL_TOL = 1e-13  # the path's kernels against their plain versions, x max|y|
MMS_DEVICE = "cuda"


def _mms_data(dim: int, M: int):
    """(geom, case, ions, EMI data, KNP data) of the study at M, on the host."""
    from knpemi_tpu_torch.mesh import unit_cube_mms_mesh, unit_square_mms_mesh
    from knpemi_tpu_torch.ops.geometry import build_geometry
    from knpemi_tpu_torch.systems import mms

    geom = build_geometry((unit_square_mms_mesh if dim == 2 else unit_cube_mms_mesh)(M))
    case = (mms.reference_mms_case if dim == 2 else mms.reference_mms_case_3d)(geom)
    return (geom, case) + mms.build_mms_data(geom, case)


def _mms_solve(data, device: str, direct: bool = False, per_ion: bool = False):
    """The study's solves on ``device``: the EMI system (deflated Jacobi CG
    or the host LU), then the KNP system batched (K3) and, with
    ``per_ion``, per ion (K11), float64.  Returns (errors, per-ion errors
    or None, iterations, setup s, solve s, fields)."""
    import torch

    from knpemi_tpu_torch.ops.p1op import membrane_operators, p1_operators
    from knpemi_tpu_torch.solvers.api import create_solver_emi, create_solver_knp
    from knpemi_tpu_torch.systems import mms
    from knpemi_tpu_torch.systems.coupling import set_initial_conditions
    from knpemi_tpu_torch.systems.emi import emi_system
    from knpemi_tpu_torch.systems.knp import knp_system

    geom, case, ions, ed, kd = data
    t0 = time.perf_counter()
    ops_, mops = p1_operators(geom, device), membrane_operators(geom, device)
    es = emi_system(geom, ions, case.params, mms=ed, device=device, p1ops=ops_, memops=mops)
    ks = knp_system(geom, ions, case.params, mms=kd, device=device, p1ops=ops_, memops=mops,
                    per_ion=per_ion)
    c0 = set_initial_conditions(geom, ions, device=device)
    pm = {m: torch.zeros(sp.n_dofs, dtype=torch.float64, device=device)
          for m, sp in geom.membranes.items()}
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    t1 = time.perf_counter()
    phi, ie = create_solver_emi(es, direct=direct, **MMS_KRYLOV).solve(c0, pm)
    c, ik = create_solver_knp(ks, direct=direct, **MMS_KRYLOV).solve(c0, phi, pm)
    c1, ik1 = None, None
    if per_ion:
        c1, ik1 = create_solver_knp(ks, batched=False, **MMS_KRYLOV).solve(c0, phi, pm)
    sync()
    t2 = time.perf_counter()
    if not (ie.converged and ik.converged and (ik1 is None or ik1.converged)):
        raise AssertionError(f"MMS {geom.dim}-D on {device}: a solve did not converge")

    def errors(cc):
        l2 = lambda tag, u, fn: mms.l2_error(geom, tag, u, fn)
        return dict(
            phi_e=l2(0, phi[0], case.phi[0]), phi_i=l2(1, phi[1], case.phi[1]),
            a_e=l2(0, cc[0][0], case.conc[("a", 0)]), b_e=l2(0, cc[0][1], case.conc[("b", 0)]),
            a_i=l2(1, cc[1][0], case.conc[("a", 1)]), b_i=l2(1, cc[1][1], case.conc[("b", 1)]))

    iters = dict(emi=ie.iters, knp_batched=ik.iters)
    if per_ion:
        iters["knp_per_ion"] = ik1.iters
    return (errors(c), None if c1 is None else errors(c1), iters, t1 - t0, t2 - t1,
            dict(phi=phi, c=c, c_per_ion=c1))


def _mms_hashes(data) -> dict:
    """sha256 (16 hex digits) of the study's host data by field: the
    arrays of ``build_mms_data``'s EMI and KNP data and the ions' initial
    values, and of all of them ("all").  Two calls that print the same
    digits built the same bits."""
    import dataclasses

    import numpy as np

    _, _, ions, ed, kd = data
    groups = {}
    for pre, d in (("emi", ed), ("knp", kd)):
        for f in dataclasses.fields(d):
            v = getattr(d, f.name)
            if isinstance(v, dict):
                groups[f"{pre}.{f.name}"] = [v[k] for k in sorted(v)]
            elif isinstance(v, np.ndarray):
                groups[f"{pre}.{f.name}"] = [v]
    groups["ions.c_init"] = [ion.c_init[k] for ion in ions for k in sorted(ion.c_init)]
    groups["all"] = [a for arrays in list(groups.values()) for a in arrays]
    return {key: _sha(arrays) for key, arrays in groups.items()}


def _sha(arrays) -> str:
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


@contextlib.contextmanager
def _uncounted():
    """Kernel launches inside do not count: every count as it was after."""
    from knpemi_tpu_torch import ops
    from knpemi_tpu_torch.ops import ell as TE

    table = ops.kernel_table()
    saved = {name: w.launches for name, (w, _) in table.items()}
    far = TE.csr_add.launches
    try:
        yield
    finally:
        for name, (w, _) in table.items():
            w.launches = saved[name]
        TE.csr_add.launches = far


@contextlib.contextmanager
def _plain_p1_applies():
    """K1 and K2 (``p1op.emi_stiffness``, ``surface_mass``) replaced by their
    plain versions inside: the systems' operators in plain PyTorch."""
    from knpemi_tpu_torch.ops import p1op as P

    saved = P.emi_stiffness, P.surface_mass
    P.emi_stiffness, P.surface_mass = P.emi_stiffness_plain, P.surface_mass_plain
    try:
        yield
    finally:
        P.emi_stiffness, P.surface_mass = saved


def mms_kernel_checks(data, seed: int = 5) -> dict:
    """The MMS path's kernels at the study's shapes on MMS_DEVICE, float64,
    on seeded inputs, their launches not counted: the masked EMI operator
    (``EMISystem.matvec``: K1 and K2 inside the Dirichlet elimination, on
    this problem's K1f fill) against the same operator on K1's and K2's
    plain versions; per subdomain K3 (B = 2) and K11 on the exact drift
    stream alone (``KNPSystem.mms_drift``) against the plain quadrature
    drift ``ops.kernels.drift_apply_quad`` of the same w_q, and K3 (every
    solved ion) and K11 (the first ion) on the KNP system's full streams
    against their plain versions.  Gates: within MMS_KERNEL_TOL of max|y|,
    finite, two launches bitwise equal.  Also the sha256 of the vectors the
    systems assembled on the host (load vectors, drift streams)."""
    import numpy as np
    import torch

    from knpemi_tpu_torch.ops import kernels as K
    from knpemi_tpu_torch.ops import p1op as P
    from knpemi_tpu_torch.ops.p1op import membrane_operators, p1_operators
    from knpemi_tpu_torch.systems.coupling import set_initial_conditions
    from knpemi_tpu_torch.systems.emi import emi_system
    from knpemi_tpu_torch.systems.knp import knp_system

    geom, case, ions, ed, kd = data
    dev, f64 = MMS_DEVICE, torch.float64
    label0 = f"MMS {geom.dim}-D"
    out = {}

    def hold(label, kern, plain):
        y = kern()
        ref = plain()
        scale, err = float(ref.abs().max()), float((y - ref).abs().max())
        same = bool(torch.equal(kern(), y))
        out[label] = dict(max_abs_err=err, max_abs_y=scale, deterministic=same)
        if not (scale > 0 and err <= MMS_KERNEL_TOL * scale and bool(torch.isfinite(y).all())):
            raise AssertionError(f"{label0} {label}: max|kernel - plain| = {err:.3e} exceeds "
                                 f"{MMS_KERNEL_TOL:.0e} x max|y| = {MMS_KERNEL_TOL * scale:.3e}")
        if not same:
            raise AssertionError(f"{label0} {label}: two launches differ")

    with _uncounted():
        ops_, mops = p1_operators(geom, dev), membrane_operators(geom, dev)
        es = emi_system(geom, ions, case.params, mms=ed, device=dev, p1ops=ops_, memops=mops)
        ks = knp_system(geom, ions, case.params, mms=kd, device=dev, p1ops=ops_, memops=mops,
                        per_ion=True)
        g = torch.Generator(device=dev).manual_seed(seed)
        rnd = lambda *shape: torch.randn(*shape, generator=g, device=dev, dtype=f64)
        ctx = es.prepare(es.kappa(set_initial_conditions(geom, ions, device=dev)))
        x = rnd(es.n)

        def plain_matvec():
            with _plain_p1_applies():
                return es.matvec(x, ctx)

        n_bc = int((es.bc_mask == 0).sum())
        hold(f"K1 + K2 EMISystem.matvec, {n_bc} Dirichlet dofs",
             lambda: es.matvec(x, ctx), plain_matvec)
        on = lambda a: torch.as_tensor(np.asarray(a), dtype=f64, device=dev)
        psi = case.params.psi
        for t, s in geom.subdomains.items():
            sub, Dr = ks.sub[t], ks.mms_drift[t]
            op = sub["op"]
            X = rnd(2, s.n_dofs)
            zero = torch.zeros_like(Dr)
            unit = torch.tensor([[0.0, 0.0, 1.0]] * 2, dtype=f64, device=dev)
            quad = (on(s.cells).long(), on(s.grads), on(s.vols), on(kd.gradphi_q[t]),
                    on(kd.cell_bary), on(kd.cell_qw))
            ref = lambda: torch.stack([K.drift_apply_quad(s.n_dofs, X[b], *quad)
                                       for b in range(2)])
            hold(f"K3 exact drift, tag {t}, B=2",
                 lambda: P.knp_apply_batch(X, op, unit, zero, zero, Dr), ref)
            hold(f"K11 exact drift, tag {t}",
                 lambda: torch.stack([P.knp_apply(X[b].contiguous(), op, zero, Dr, 1.0)
                                      for b in range(2)]), ref)
            Xs = rnd(ks.n_solved, s.n_dofs)
            hold(f"K3 KNPSystem.matvec_batch, tag {t}, B={ks.n_solved}",
                 lambda: ks.matvec_batch(t, Xs, Dr),
                 lambda: P.knp_apply_batch_plain(Xs, op, sub["coef"], sub["M"], sub["kst"], Dr))
            zpsiD = ions[0].z * psi * ions[0].D[t]
            hold(f"K11 KNPSystem.matvec_one, tag {t}, ion {ions[0].name}",
                 lambda: ks.matvec_one(t, 0, Xs[0], Dr),
                 lambda: P.knp_apply_plain(Xs[0], op, ks.ion_vals[t][0], Dr, zpsiD))
        host = lambda v: v.detach().cpu().numpy()
        out["systems_sha256"] = dict(
            emi_load=_sha([host(es._mms_load)]),
            knp_load=_sha([host(ks._mms_load[t]) for t in sorted(ks._mms_load)]),
            knp_drift=_sha([host(ks.mms_drift[t]) for t in sorted(ks.mms_drift)]))
    return out


def _close(e, ref):
    """The JAX package's iterative-against-direct gate."""
    return all(abs(e[f] - ref[f]) < 1e-6 + 1e-3 * ref[f] for f in MMS_FIELDS)


def _norm_rel(a, b) -> float:
    return float((a.cpu() - b).abs().max() / b.abs().max().clamp_min(1e-300))


def mms_study(dim: int):
    """The manufactured-solution study of one dimension on the card (float64):
    per M, the L2 errors of every field, iterations, setup and solve
    seconds; the rates; the per-ion KNP solve at M = 8 and 16; in 3-D the
    host LU at M = 8 and 16 and the CPU run at M = 8.  Gates: the last
    rate above MMS_GATE for every field; the per-ion errors within 1e-6 +
    1e-3 e of the batched ones; in 3-D both iterative branches' errors
    within 1e-6 + 1e-3 e of the direct ones at M = 16, and at M = 8 a
    second run on the device bitwise equal to the first and the GPU
    against the CPU: equal iteration counts and every field within 1e-9
    of its max|u|; at the largest M the path's kernels
    against their plain versions (:func:`mms_kernel_checks`).  Every M
    prints the sha256 of its host data (:func:`_mms_hashes`)."""
    import numpy as np
    import torch

    Ms = MMS_MS[dim]
    rows, errs = {}, []
    for M in Ms:
        t0 = time.perf_counter()
        data = _mms_data(dim, M)
        data_s = time.perf_counter() - t0
        per_ion = M in MMS_PER_ION_MS
        e, e1, iters, setup_s, solve_s, fields = _mms_solve(data, MMS_DEVICE, per_ion=per_ion)
        geom = data[0]
        row = dict(dofs=geom.emi_size, cells=sum(s.n_cells for s in geom.subdomains.values()),
                   data_seconds=data_s, setup_seconds=setup_s, solve_seconds=solve_s,
                   iters=iters, errors=e, errors_knp_per_ion=e1,
                   data_sha256=_mms_hashes(data))
        if per_ion and not _close(e1, e):
            raise AssertionError(f"MMS {dim}-D M={M}: per-ion KNP errors {e1} against "
                                 f"the batched {e}")
        if dim == 3 and M in MMS_DIRECT_MS:
            ed, _, _, _, dsolve_s, _ = _mms_solve(data, MMS_DEVICE, direct=True)
            row.update(errors_direct=ed, direct_solve_seconds=dsolve_s)
            if M == MMS_CHECK_M and not (_close(e, ed) and (e1 is None or _close(e1, ed))):
                raise AssertionError(f"MMS 3-D M={M}: iterative {e} / {e1} against "
                                     f"direct {ed}")
        if M == Ms[-1]:
            row.update(kernel_checks=mms_kernel_checks(data))
        if dim == 3 and M == MMS_CPU_M:
            # the same solves once more on the device: the same bits
            _, _, it_again, _, _, f_again = _mms_solve(data, MMS_DEVICE, per_ion=per_ion)
            same = it_again == iters and all(
                bool(torch.equal(fields[k][t], f_again[k][t]))
                for k in ("phi", "c", "c_per_ion") if f_again[k] is not None
                for t in f_again[k])
            row.update(repeat_bitwise=same, repeat_iters=it_again)
            if not same:
                raise AssertionError(f"MMS 3-D M={M}: a second run on {MMS_DEVICE} differs: "
                                     f"iterations {iters} then {it_again}")
            _, _, it_cpu, _, cpu_s, f_cpu = _mms_solve(data, "cpu", per_ion=per_ion)
            d = max(_norm_rel(fields[k][t], f_cpu[k][t]) for k in ("phi", "c", "c_per_ion")
                    if f_cpu[k] is not None for t in f_cpu[k])
            row.update(cpu_iters=it_cpu, cpu_solve_seconds=cpu_s,
                       gpu_vs_cpu_max_rel=d)
            if it_cpu != iters or not d <= 1e-9:
                raise AssertionError(f"MMS 3-D M={M}: GPU {iters} vs CPU {it_cpu}, "
                                     f"max rel difference {d:.3e} (gate 1e-9)")
        rows[M] = row
        errs.append(e)
    rates = {f: [float(np.log2(errs[i - 1][f] / errs[i][f])) for i in range(1, len(Ms))]
             for f in MMS_FIELDS}
    low = [f for f in MMS_FIELDS if not rates[f][-1] > MMS_GATE[dim]]
    if low:
        raise AssertionError(f"MMS {dim}-D: last rate at most {MMS_GATE[dim]} for {low}: "
                             f"{rates}")
    return dict(M=list(Ms), per_M=rows, rates=rates, rate_gate=MMS_GATE[dim])


# the reference-scale ladder's first rungs (knpemi_tpu_torch/tools/
# run_mms_ladder.py): 2-D, SA-AMG CG and batched GMRES at rtol 1e-10
LADDER_MS = (100, 200)
LADDER_RATE = 1.9  # the rate 100 -> 200, every field
LADDER_CPU_TOL = 1e-9  # GPU against CPU at LADDER_MS[0], x max|u|
# the JAX package's iterative ladder (CPU float64, RESULTS.md:749): EMI /
# KNP iterations at M = 200, recorded, not measured in this run
LADDER_JAX_ITERS = {200: (18, 22)}


def mms_ladder():
    """The ladder's rungs at LADDER_MS on MMS_DEVICE through the tool's
    ``ladder_rung`` (float64, the SA-AMG hierarchies of its recipe), then
    the host LU rung and the CPU rung at LADDER_MS[0].  Gates: every rate
    above LADDER_RATE; the iterative errors within 1e-6 + 1e-3 e of the
    direct ones; GPU against CPU equal EMI and KNP iterations and every
    field within LADDER_CPU_TOL of its max|u|.  The iterations are printed
    beside the JAX package's."""
    from knpemi_tpu_torch.tools import run_mms_ladder as L

    first = LADDER_MS[0]
    rungs = [L.ladder_rung(M, True, MMS_DEVICE, return_fields=M == first)
             for M in LADDER_MS]
    fields = rungs[0].pop("fields")
    rates = L.rates(rungs)
    low = [f for f in MMS_FIELDS if not rates[f][-1] > LADDER_RATE]
    if low:
        raise AssertionError(f"MMS ladder: rate {LADDER_MS} at most {LADDER_RATE} for "
                             f"{low}: {rates}")
    direct = L.ladder_rung(first, False, MMS_DEVICE)
    if not _close(rungs[0]["errors"], direct["errors"]):
        raise AssertionError(f"MMS ladder M={first}: iterative {rungs[0]['errors']} against "
                             f"direct {direct['errors']}")
    cpu = L.ladder_rung(first, True, "cpu", return_fields=True)
    cpu_fields = cpu.pop("fields")
    d = max(_norm_rel(fields[k][t], cpu_fields[k][t]) for k in ("phi", "c")
            for t in cpu_fields[k])
    if cpu["iters"] != rungs[0]["iters"] or not d <= LADDER_CPU_TOL:
        raise AssertionError(f"MMS ladder M={first}: GPU {rungs[0]['iters']} vs CPU "
                             f"{cpu['iters']}, max rel difference {d:.3e} "
                             f"(gate {LADDER_CPU_TOL:.0e})")
    for r in rungs:
        r["jax_cpu_iters"] = LADDER_JAX_ITERS.get(r["M"])
    return dict(rungs=rungs, rates=rates, rate_gate=LADDER_RATE,
                direct=dict(M=first, errors=direct["errors"], seconds=direct["seconds"]),
                cpu=dict(M=first, iters=cpu["iters"], seconds=cpu["seconds"],
                         gpu_vs_cpu_max_rel=d),
                jax_iters_source="recorded, not measured in this run: the JAX package's "
                                 "iterative ladder, CPU float64 (RESULTS.md:749)")


# what the MMS path launches on the card: K1 (the EMI operator, the
# right-hand side and its lift), K1f and K4 (the per-solve fill), K2 (the
# membrane coupling), K3 (the batched KNP operator and its mass term),
# K11 (the per-ion KNP operator), all on the host-assembled exact drift;
# the ladder's rungs launch all but K11
MMS_PATH = ("K1", "K1f", "K2", "K3", "K4", "K11")


def mms_phase():
    """The 3-D study (M = 8, 16, 32), the 2-D one (M = 8, 16, 32), then the
    reference-scale ladder's rungs (:func:`mms_ladder`), with the launch
    counts set to 0 just before and read just after: every kernel of
    MMS_PATH must have launched."""
    from knpemi_tpu_torch import ops
    from knpemi_tpu_torch.ops import ell as TE

    ops.reset_launch_counts()
    out = {"3-D": mms_study(3), "2-D": mms_study(2), "ladder": mms_ladder()}
    counts = {**ops.launch_counts(), FAR_ADD: TE.csr_add.launches}
    missing = [k for k in MMS_PATH if not any(n.split()[0] == k and v
                                             for n, v in counts.items())]
    if missing:
        raise AssertionError(f"MMS: kernels of the path not launched: {missing} ({counts})")
    return out, counts


# -- the drivers phase -------------------------------------------------------
BENCH_MEMBRANES = (5, 6, 7)
BENCH_PARITY_STEPS = 4  # across the source onset: the gate reads t > 0.2 at step 4
BENCH_TSTOP = 2.0  # ms: 20 steps of run_benchmark, the source on from step 3
GOLDEN_2D = Path(__file__).resolve().parent / "tests" / "data" / "golden_2d_res1.npz"
# tests/test_golden_traces.py's gates: the probe trace and the final phi_M
# (V), the final concentrations (relative)
GOLDEN_GATES = dict(trace_atol=2e-4, phi_M_atol=2e-4, c_rtol=3e-3)
CALIBRATION_STEPS, CALIBRATION_TOL = 100, 1e-12
DRIVERS_DEVICE = "cuda"
# filled by flagship() and resume_phase(): each flagship build's set-up,
# the native sweep against its plain twin, the fresh build's hierarchy
# hash and first step
HOST_SETUP = {"builds": []}


def setup_record(label: str, sim, setup_s: float) -> dict:
    """One build's host set-up: its seconds, the multigrid parts, and
    within them the t = 0 EMI assembly (seconds, cache hit or miss) and
    the native Vanek sweeps (``Simulation.setup_detail``)."""
    return dict(build=label, setup_seconds=setup_s,
                emi_multigrid=sim.setup_seconds.get("emi_multigrid"),
                knp_multigrid=sim.setup_seconds.get("knp_multigrid"), **sim.setup_detail)


def _host_sha(h, obj):
    """Feed ``obj``'s arrays (numpy, scipy sparse, dataclasses, dicts,
    sequences of them) and scalars into the hash ``h``."""
    import dataclasses

    import numpy as np
    import scipy.sparse as sp

    if isinstance(obj, np.ndarray):
        h.update(f"{obj.dtype}{obj.shape}".encode())
        h.update(np.ascontiguousarray(obj).tobytes())
    elif sp.issparse(obj):
        for a in (obj.data, obj.indices, obj.indptr):
            _host_sha(h, a)
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            h.update(f.name.encode())
            _host_sha(h, getattr(obj, f.name))
    elif isinstance(obj, dict):
        for k in sorted(obj, key=str):
            h.update(str(k).encode())
            _host_sha(h, obj[k])
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _host_sha(h, v)
    elif obj is None or isinstance(obj, (bool, int, float, str, np.generic)):
        h.update(repr(obj).encode())
    else:
        h.update(type(obj).__name__.encode())


def hierarchy_sha(sim) -> dict:
    """sha256 of the EMI host hierarchy's arrays and of every device tensor
    of the EMI and KNP hierarchies (what the cycles read)."""
    import hashlib

    import torch

    host = hashlib.sha256()
    _host_sha(host, sim._emi_hier)
    dev = hashlib.sha256()
    for mg in (sim.emi_solver.mg, *(sim.knp_solver.mg[t] for t in sorted(sim.knp_solver.mg))):
        for t in [*mg.tensors(), mg.fine_diag]:
            dev.update(f"{t.dtype}{tuple(t.shape)}".encode())
            dev.update(t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy()
                       .tobytes())
    return dict(host=host.hexdigest()[:16], device=dev.hexdigest()[:16])


def native_sweep_check(sim) -> dict:
    """(g): the native Vanek sweep against its plain twin on the level-0
    strength graph of ``sim``'s EMI hierarchy (the t = 0 operator from the
    cache, equilibrated and RCM-permuted as the build does): identical
    aggregates, both times on this host."""
    import numpy as np

    from knpemi_tpu_torch.sim.stepper import _global_rcm
    from knpemi_tpu_torch.solvers import mg as M

    A_hat, s, _ = sim._emi_setup_operator()
    A_hat, s, _ = _global_rcm(A_hat, s)
    Af = M.strength_filter(A_hat, sim.opts.mg_theta, B=1.0 / s)
    t0 = time.perf_counter()
    agg, nc = M.vanek_aggregate(Af)
    t1 = time.perf_counter()
    agg_p, nc_p = M.vanek_aggregate_plain(Af)
    t2 = time.perf_counter()
    identical = nc == nc_p and bool(np.array_equal(agg, agg_p))
    if not identical:
        raise AssertionError(f"native Vanek sweep: {nc} aggregates against the plain "
                             f"sweep's {nc_p}, or different assignments")
    return dict(rows=Af.shape[0], nnz=int(Af.nnz), aggregates=nc, identical=identical,
                native_seconds=t1 - t0, plain_seconds=t2 - t1)


def bench_kernel_cases(sim, dtype):
    """(c): the assembly kernels at the benchmark scenario's shapes — K2,
    K9 and K10 on each of the three membranes of the one cell, K1, K1f,
    K3 and K4 on the cell (tag 1)."""
    cases = []
    for i, m in enumerate(BENCH_MEMBRANES):
        cases += [c for c in kernel_cases(sim, dtype, tag=1, mem=m)
                  if i == 0 or c["name"].split()[0] not in CELL_KERNELS]
    return cases


def golden_dof_maps(sim):
    """{tag: index array}: the dof of ``sim`` (2-D res 1) holding each dof of
    ``tests/data/golden_2d_res1.npz``, whose concentrations are stored in
    the Z-order (Morton) numbering of the run that made it: that run's
    vertices of a subdomain, sorted, then ordered along the curve."""
    import numpy as np

    maps = {}
    for tag, sub in sim.geom.subdomains.items():
        order = np.argsort(sub.vertices, kind="stable")
        verts, pts = sub.vertices[order], sub.coords[order]
        lo, hi = pts.min(axis=0), pts.max(axis=0)
        span = float(np.max(hi - lo)) or 1.0
        bits = 16
        q = ((pts - lo) / span * (2**bits - 1)).astype(np.uint64)
        key = np.zeros(len(pts), dtype=np.uint64)
        for b in range(bits):
            for d in range(pts.shape[1]):
                key |= ((q[:, d] >> np.uint64(b)) & np.uint64(1)) << np.uint64(
                    b * pts.shape[1] + d)
        verts_m = verts[np.argsort(key, kind="stable")]
        inv = np.full(int(sub.vertices.max()) + 1, -1, dtype=np.int64)
        inv[np.asarray(sub.vertices)] = np.arange(sub.n_dofs)
        maps[tag] = inv[verts_m]
    return maps


def golden_2d(sim, state, traces, golden=GOLDEN_2D) -> dict:
    """The 2-D res-1 run against the golden fixture under
    ``tests/test_golden_traces.py``'s gates: the probe trace (every 5
    steps) and the final phi_M within 2e-4 V, the final concentrations
    within 3e-3 relative under :func:`golden_dof_maps`."""
    import numpy as np

    g = np.load(golden)
    maps = golden_dof_maps(sim)
    trace = np.asarray(traces["phi_M_probe"])
    pm = state.phi_M[1].detach().cpu().double().numpy()
    c = {t: state.c[t].detach().cpu().double().numpy()[:, maps[t]] for t in (0, 1)}
    out = dict(
        trace_len=len(trace),
        probe_max_abs_dV=float(np.abs(trace - g["phi_M_probe"]).max())
        if trace.shape == g["phi_M_probe"].shape else None,
        phi_M_final_max_abs_dV=float(np.abs(pm - g["phi_M_final"]).max()),
        c_max_rel={t: float((np.abs(c[t] - g[k]) / np.abs(g[k])).max())
                   for t, k in ((0, "c_final_ecs"), (1, "c_final_ics"))},
        trace_swing_V=[float(trace.min()), float(trace.max())])
    out["held"] = bool(
        out["probe_max_abs_dV"] is not None
        and out["probe_max_abs_dV"] <= GOLDEN_GATES["trace_atol"]
        and out["phi_M_final_max_abs_dV"] <= GOLDEN_GATES["phi_M_atol"]
        and max(out["c_max_rel"].values()) <= GOLDEN_GATES["c_rtol"])
    return out


def drivers_phase():
    """The reference's other drivers on the card, and the host set-up.

    (c) the benchmark scenario's kernels at its shapes (float32 and
    float64, against their plain versions, bitwise across two launches
    where phase 1 asks it), then (a) ``run_benchmark.solve_system`` at the
    driver's defaults (resolution 0, float32) to BENCH_TSTOP (20 steps), the
    launch counts set to 0 just before and read just after; (b) that
    scenario GPU float64 against CPU float64 over the source onset; (d)
    ``run_2d`` at resolution 1 for 100 steps against the golden fixture
    (float64: a gate; float32: read only); (e) ``run_3d`` at its defaults;
    (f) 100 steps of ``run_calibration.run`` on the card against the CPU.
    (g) and (h) come from the flagship builds (:func:`host_setup_record`).
    Returns (the phase's record, the launch counts of (a))."""
    import numpy as np
    import torch

    from knpemi_tpu_torch import ops
    from knpemi_tpu_torch.drivers import run_2d as R2
    from knpemi_tpu_torch.drivers import run_3d as R3
    from knpemi_tpu_torch.drivers import run_benchmark as RB
    from knpemi_tpu_torch.drivers import run_calibration as RC
    from knpemi_tpu_torch.ops import ell as TE
    from knpemi_tpu_torch.sim import build_two_cell, dofs_per_step
    from knpemi_tpu_torch.sim.scenarios import K_E_INIT_A  # the initial ECS K+, mM

    dev = DRIVERS_DEVICE
    out = {}
    # -- (c) then (a): the benchmark scenario at the driver's defaults -------
    t0 = time.perf_counter()
    sim = RB.build_simulation(device=dev)
    setup_s = time.perf_counter() - t0
    if sorted(sim.geom.membranes) != list(BENCH_MEMBRANES) or len(sim.geom.subdomains) != 2:
        raise AssertionError("benchmark: expected 2 subdomains and membranes 5, 6, 7")
    t1 = time.perf_counter()
    checks = {}
    for dt in (torch.float32, torch.float64):
        rows = check_cases(bench_kernel_cases(sim, dt), dt, time_them=False)
        checks[str(dt).replace("torch.", "")] = [
            {k: r.get(k) for k in ("name", "variant", "max_abs_err", "max_abs_y",
                                   "deterministic")} for r in rows]
    out["kernel_checks"] = dict(seconds=time.perf_counter() - t1, **checks)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t1 = time.perf_counter()
    state, it_e, it_k, traces = RB.solve_system(sim=sim, Tstop=BENCH_TSTOP, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = {**ops.launch_counts(), FAR_ADD: TE.csr_add.launches}
    fields = [*state.phi.values(), *state.phi_M.values(), *state.c.values()]
    if not all(bool(torch.isfinite(v).all()) for v in fields) or not all(
            np.isfinite(v).all() for v in traces.values()):
        raise AssertionError("benchmark: a field or a probe trace is not finite")
    t_arr, ke = np.asarray(traces["t"]), np.asarray(traces["K_e"])
    # the source acts in the steps that start after t = 0.2 ms
    after = ke[t_arr > 0.2 + sim.params.dt * 1.5]
    if not (after.size and after.max() > K_E_INIT_A):
        raise AssertionError(f"benchmark: the ECS K_e probe did not rise above "
                             f"{K_E_INIT_A} mM after the source turned on: {ke.tolist()}")
    reach = reachable_kernels(sim)
    idle = [k for k, v in launches.items() if k.split()[0] in reach and not v]
    if idle:
        raise AssertionError(f"benchmark: kernels of the path did not launch: {idle}")
    n = len(it_e)
    out["benchmark"] = dict(
        case=f"run_benchmark.solve_system, resolution 0, {BENCH_TSTOP} ms, float32, "
             "default options",
        dofs_per_step=dofs_per_step(sim), steps=n, ms_per_step=wall / n * 1e3,
        emi_iters=it_e.tolist(), knp_iters=it_k.tolist(),
        peak_device_bytes=torch.cuda.max_memory_allocated(),
        host_setup_seconds=setup_s, host_setup_parts=sim.setup_seconds,
        host_setup_detail=sim.setup_detail,
        phi_M_range_mV={m: [float(v.min()), float(v.max())] for m, v in state.phi_M.items()},
        K_e_range_mM=[float(state.c[0][0].min()), float(state.c[0][0].max())],
        K_e_probe_mM=[float(ke[0]), float(ke.max()), float(ke[-1])],
        launches=launches, reachable=sorted(reach), seconds=time.perf_counter() - t0)
    del sim, state
    torch.cuda.empty_cache()

    # -- (b) GPU float64 against CPU float64, over the source onset ----------
    t0 = time.perf_counter()
    runs = {}
    for d in (dev, "cpu"):
        s = build_two_cell(dtype=torch.float64, device=d)
        st, e, k, ok = s.run(s.init_state(), BENCH_PARITY_STEPS)
        if not ok.all():
            raise AssertionError(f"benchmark parity: a step did not converge on {d}")
        runs[d] = (st, e.tolist(), k.tolist())
    (g, ge, gk), (c, ce, ck) = runs[dev], runs["cpu"]
    if (ge, gk) != (ce, ck):
        raise AssertionError(f"benchmark parity: iterations differ: GPU {ge} {gk}, "
                             f"CPU {ce} {ck}")
    dphi, dc = gpu_vs_cpu(g, c, "benchmark parity", "mV")
    out["benchmark_parity"] = dict(steps=BENCH_PARITY_STEPS, emi_iters=ge, knp_iters=gk,
                                   max_abs_dphi_M_mV=dphi, max_rel_dc=dc,
                                   seconds=time.perf_counter() - t0)
    del runs, g, c
    torch.cuda.empty_cache()

    # -- (d) the 2-D driver at resolution 1 against the golden fixture --------
    for dt in (torch.float64, torch.float32):
        t0 = time.perf_counter()
        s = R2.build_simulation(1, device=dev, dtype=dt)
        st, e, k, tr = R2.solve_system(1, Tstop=1.0e-2, save_every=5, verbose=False, sim=s)
        torch.cuda.synchronize()
        rec = dict(golden_2d(s, st, tr), steps=len(e), emi_iters_mean=float(e.mean()),
                   knp_iters_mean=float(k.mean()), seconds=time.perf_counter() - t0)
        key = str(dt).replace("torch.", "")
        out[f"run_2d_res1_{key}"] = rec
        if dt == torch.float64 and not rec["held"]:
            raise AssertionError(f"run_2d float64: the golden fixture's gates missed: {rec}")
        del s, st

    # -- (e) the 3-D driver at its defaults -----------------------------------
    t0 = time.perf_counter()
    s = R3.build_simulation(device=dev)
    setup_s = time.perf_counter() - t0
    st, e, k, ms = R3.solve_system(sim=s, verbose=False)
    if not all(bool(torch.isfinite(v).all()) for v in st.phi_M.values()):
        raise AssertionError("run_3d: phi_M is not finite")
    out["run_3d_res0_float32"] = dict(
        dofs_per_step=dofs_per_step(s), steps=len(e), ms_per_step=ms,
        emi_iters=e.tolist(), knp_iters=k.tolist(), host_setup_seconds=setup_s,
        seconds=time.perf_counter() - t0)
    del s, st
    torch.cuda.empty_cache()

    # -- (f) calibration: the card against the CPU, float64 -------------------
    t0 = time.perf_counter()
    yg = RC.run(CALIBRATION_STEPS, device=dev, verbose=False)
    t1 = time.perf_counter()
    yc = RC.run(CALIBRATION_STEPS, device="cpu", verbose=False)
    t2 = time.perf_counter()
    rel = float(np.max(np.abs(yg - yc) / np.abs(yc)))
    if not rel <= CALIBRATION_TOL:
        raise AssertionError(f"calibration: GPU vs CPU {rel:.3e} relative (gate "
                             f"{CALIBRATION_TOL})")
    out["calibration"] = dict(steps=CALIBRATION_STEPS, max_rel_gpu_vs_cpu=rel,
                              seconds_per_step_gpu=(t1 - t0) / CALIBRATION_STEPS,
                              seconds_per_step_cpu=(t2 - t1) / CALIBRATION_STEPS)

    return out, launches


def host_setup_record() -> dict:
    """(g) and (h), from the flagship builds (``HOST_SETUP``)."""
    return dict(native_sweep=HOST_SETUP.get("native_sweep"),
                flagship_builds=HOST_SETUP["builds"],
                fresh_vs_cached=HOST_SETUP.get("fresh_vs_cached"))


def per_solve_ecs(sim, launches):
    """The P1 operator's cost per solve on the flagship's ECS (tag 0), for
    the package ``sim`` comes from, by its own wrappers on random inputs
    (device ms, L2 flushed): K1f + applies x K1 (the EMI solve) and K11f
    + applies x K3 + K3's mass-only apply (the batched KNP solve), the
    applies per fill from ``launches``, the counts of the profiled
    steps."""
    import torch

    from knpemi_tpu_torch.ops import p1op as P

    s, ks = sim.emi_sys.sub[0], sim.knp_sys.sub[0]
    op, grads, vols = s["op"], s["grads"], s["vols"]
    dev = sim.device
    g = torch.Generator(device=dev).manual_seed(4)
    rnd = lambda *shape: torch.randn(*shape, generator=g, device=dev)
    wv, w = vols * (1.0 + torch.rand(vols.shape, generator=g, device=dev)), rnd(
        vols.shape[0], grads.shape[-1])
    V, Dr = P.emi_fill(op, grads, wv), P.drift_fill(op, grads, vols, w)
    x, X = rnd(s["n_dofs"]), rnd(sim.knp_sys.n_solved, s["n_dofs"])
    coef, M, Kst = ks["coef"], ks["M"], ks["kst"]
    t = {k: device_ms(fn) for k, fn in (
        ("K1f", lambda: P.emi_fill(op, grads, wv)),
        ("K11f", lambda: P.drift_fill(op, grads, vols, w)),
        ("K1", lambda: P.emi_stiffness(x, op, V)),
        ("K3", lambda: P.knp_apply_batch(X, op, coef, M, Kst, Dr)),
        ("K3 mass-only", lambda: P.knp_apply_batch(X, op, coef, M)))}
    _FLUSH.pop("buf", None)
    emi = launches["K1 emi_stiffness"] / launches["K1f emi_fill"]
    knp = launches["K3 knp_apply_batch"] / launches["K11f drift_fill"] - 1.0
    return dict(ms=t, emi_applies_per_fill=emi, knp_applies_per_fill=knp,
                emi=t["K1f"] + emi * t["K1"],
                knp_batched=t["K11f"] + knp * t["K3"] + t["K3 mass-only"])


def step_profile(warm: int = 12, steps: int = 2):
    """The port's kernels inside the flagship's step, for the
    ``knpemi_tpu_torch`` on ``sys.path``: batched and banded (float32, the
    tuned options), ``warm`` steps, then ``steps`` under torch.profiler;
    device ms and device kernels per step, peak device memory of those
    steps, the EMI and KNP iterations of every step (warm-up and
    profiled) and, for every device kernel by name (the port's, in the
    anonymous namespace of ``ops/csrc``, and PyTorch's), device ms and
    launches per step; on the batched run also :func:`per_solve_ecs`.
    Yields one record per run."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import knpemi_tpu_torch as kt
    from knpemi_tpu_torch import ops

    dev_t = lambda e: getattr(e, "self_device_time_total", 0) or 0
    for banded in (False, True):
        t0 = time.perf_counter()
        sim = kt.build_astrocyte({**kt.ASTROCYTE_BASELINE, "mesh_n": MESH_N},
                                 dtype=torch.float32,
                                 solver_options=kt.SolverOptions(mg_banded=banded, **TUNED))
        state, it_e, it_k, _ = sim.run(sim.init_state(), warm)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        iters = []
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                state = sim.step(state)
                iters.append([state.emi_iters, state.knp_iters])
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        launches = ops.launch_counts()
        solve = None if banded else per_solve_ecs(sim, launches)
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                  and not e.key.startswith("step/")]
        # every device kernel (PyTorch's too), by name: what a change adds or removes
        every = {}
        for e in events:
            v = every.setdefault(e.key[:120], [0.0, 0.0])
            v[0] += dev_t(e) / 1e3 / steps
            v[1] += e.count / steps
        yield dict(package=str(Path(kt.__file__).parent), mg_banded=banded,
                   steps=[warm + 1, warm + steps],
                   device_kernel_ms_per_step=sum(dev_t(e) for e in events) / 1e3 / steps,
                   kernels_per_step=sum(e.count for e in events) / steps,
                   emi_iters=int(state.emi_iters), knp_iters=int(state.knp_iters),
                   iters_per_step=[[int(e), int(k)] for e, k in zip(it_e, it_k)]
                   + [[int(e), int(k)] for e, k in iters],
                   peak_mb=peak / 2**20, per_solve_ecs=solve,
                   all_kernels=every,
                   seconds=time.perf_counter() - t0)
        del sim, state
        torch.cuda.empty_cache()


def step_diff(path, top: int = 12):
    """The A/B of a file of ``step_profile`` lines (parent, change,
    change, parent; the first package named is the parent's), per
    multigrid path: each leg's device ms a step, the change's mean less
    the parent's, the parent's own spread, and by device kernel name
    (each tree's legs averaged) the ``top`` largest moves in ms a step,
    with the net of the kernels whose count a step moved and of those
    whose count did not."""
    legs = [json.loads(ln) for ln in open(path)
            if ln.startswith('{"phase": "step_profile"')]
    parent = legs[0]["package"]
    for banded in (False, True):
        trees = ([L for L in legs if L["mg_banded"] == banded and (L["package"] == parent) == p]
                 for p in (True, False))
        means = []
        for tree in trees:
            m = {}
            for L in tree:
                for name, (ms, n) in L["all_kernels"].items():
                    a = m.setdefault(name, [0.0, 0.0, [L["device_kernel_ms_per_step"]]])
                    a[0] += ms / len(tree)
                    a[1] += n / len(tree)
            means.append((tree, m))
        (p_legs, p), (c_legs, c) = means
        zero = (0.0, 0.0)
        moves = sorted(((c.get(k, zero)[0] - p.get(k, zero)[0], k,
                         p.get(k, zero)[:2], c.get(k, zero)[:2]) for k in set(p) | set(c)),
                       key=lambda r: -abs(r[0]))
        ms = lambda legs: [L["device_kernel_ms_per_step"] for L in legs]
        emit(dict(
            phase="step_diff", mg_banded=banded, parent_ms=ms(p_legs), change_ms=ms(c_legs),
            change_less_parent_ms=(sum(ms(c_legs)) / len(c_legs)
                                   - sum(ms(p_legs)) / len(p_legs)),
            parent_spread_ms=max(ms(p_legs)) - min(ms(p_legs)),
            net_count_moved_ms=sum(d for d, _, a, b in moves if a[1] != b[1]),
            net_count_equal_ms=sum(d for d, _, a, b in moves if a[1] == b[1]),
            top=[dict(name=k[:100], ms=d, parent=a, change=b) for d, k, a, b in moves[:top]]))


PHASE_GROUPS = ("environment + kernel build", "drivers (a)-(f)", "launch floor",
                "res 2, both layouts", "l = 4 box", "flagship, 3 runs", "multi_device",
                "resume", "campaign", "phase 2", "mms", "drivers (g), (h) and the table")


def _phase_group(rec: dict) -> str:
    ph, path = rec["phase"], str(rec.get("path", ""))
    if ph == 0:
        return PHASE_GROUPS[0]
    if ph == "drivers":
        return PHASE_GROUPS[1] if "(a" in rec.get("case", "") else PHASE_GROUPS[-1]
    if ph == 1 and "launch floor" in rec.get("case", ""):
        return PHASE_GROUPS[2]
    if ph == 1 and "per solve" in rec.get("case", ""):
        return PHASE_GROUPS[-1]
    if path.startswith("flagship") or ph == "tools":
        return PHASE_GROUPS[5]
    if ph in (1, 3, 4):
        return PHASE_GROUPS[4] if path.endswith("l=4") else PHASE_GROUPS[3]
    return {"multi_device": PHASE_GROUPS[6], "resume": PHASE_GROUPS[7],
            "campaign": PHASE_GROUPS[8], 2: PHASE_GROUPS[9], "mms": PHASE_GROUPS[10]}[ph]


def phase_seconds(path) -> dict:
    """The seconds of each PHASE_GROUPS group of a smoke run's output file:
    between the ``script_s`` of its last line and that of the group before
    it (the first from the script's start); the ``tools`` phase's own
    seconds beside them, and the script's."""
    out, last = {}, 0.0
    for ln in open(path):
        if not ln.startswith("{"):
            continue
        rec = json.loads(ln)
        if "script_s" not in rec:
            continue
        g = _phase_group(rec)
        if g not in out:
            out[g] = rec["script_s"] - last
        else:
            out[g] += rec["script_s"] - last
        last = rec["script_s"]
        if rec["phase"] == "tools":
            out["of which tools"] = rec["seconds"]
    out["script (to its last phase line)"] = last
    return out


def main(argv=None) -> int:
    """No arguments: the smoke run.  ``--step-profile ROOT``: only
    :func:`step_profile` for the package under ROOT (a checkout of this
    or another commit); run it for two trees in turns to compare them in
    one call.  ``--step-diff FILE``: :func:`step_diff` of such a call's
    output, on the host."""
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--step-diff"] and len(argv) == 2:
        step_diff(argv[1])
        return 0
    if argv[:1] == ["--phase-seconds"] and len(argv) >= 2:
        for path in argv[1:]:
            print(json.dumps(dict(file=path, **phase_seconds(path))))
        return 0
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    repo = Path(__file__).resolve().parent
    profile_root = None
    if argv[:1] == ["--step-profile"]:
        if len(argv) != 2:
            print("usage: chip_smoke.py [--step-profile ROOT]", file=sys.stderr)
            return 2
        profile_root = Path(argv[1]).resolve()
    root = profile_root or repo
    if not (root / "knpemi_tpu_torch").is_dir():
        print(f"chip_smoke: knpemi_tpu_torch/ is not in {root}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))
    from knpemi_tpu_torch.ops import _build
    from knpemi_tpu_torch.sim import (
        ASTROCYTE_BASELINE, SolverOptions, build_astrocyte, build_idealized,
    )

    smi = smi_line()
    if profile_root is not None:
        _build.build()
        for rec in step_profile():
            emit(dict(phase="step_profile", **rec))
        print(smi, flush=True)
        return 0
    kind = torch.cuda.get_device_name(0)
    # the host set-ups of phases 1 and 3's idealized builds, on the CPU in
    # processes of their own while the drivers run: those builds then read
    # their hierarchies and EMI operators from the caches
    warming = {what: start_warming(what) for what in WARM_BOXES}
    emit(environment(smi))
    # -- phase 0: device and build ------------------------------------------
    t0 = time.perf_counter()
    _build.build()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in _build.build_log.items()}
    emit(dict(phase=0, nvidia_smi=smi, torch=torch.__version__,
              cuda=torch.version.cuda, build_seconds=_build.build_seconds,
              ptxas=ptxas, seconds=time.perf_counter() - t0))
    # -- the reference's other drivers, (a)-(f), first: before any profiler
    # session, in a process that has run nothing else -----------------------------
    t0 = time.perf_counter()
    launches = {}
    drv_out, launches["bench"] = drivers_phase()
    emit(dict(phase="drivers", case="run_benchmark (a-c), run_2d (d), run_3d (e), "
              "run_calibration (f)", **drv_out, seconds=time.perf_counter() - t0))
    torch.cuda.empty_cache()
    # the launch floor, beside every kernel's bound in the kernels line
    floor = launch_floor_ms()
    _FLUSH.pop("buf", None)
    emit(dict(phase=1, case="launch floor: the flushed device time of a one-element fill",
              floor_ms=floor))

    warmed = {"res2": finish_warming(warming["res2"])}
    build_res2 = shared_mesh(build_idealized)
    for banded in (False, True):
        label = "mg_banded=True" if banded else "mg_banded=False"
        # -- phase 1: kernels against their plain versions --------------------
        other_bytes = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        # the banded build from the ELL build's mesh and geometry
        sim = build_res2(dim=3, resolution=2, g_syn_bar=10.0,
                              dtype=torch.float32, device="cuda",
                              solver_options=SolverOptions(mg_banded=banded))
        setup_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        check = check_mg_kernels if banded else check_kernels
        # untimed (the script's time limit): the kernels line's times come
        # from the l = 4 box and the flagship
        r32 = check(sim, torch.float32, time_them=False)
        r64 = check(sim, torch.float64, time_them=False)
        if not banded:
            # the P1 operator's kernels, the fills among them, on every
            # subdomain (K11 / K11f with phi in V)
            r32 += p1_elsewhere(sim, torch.float32) + check_k11(
                sim, torch.float32, False, phi_scale=1e-3)
            r64 += p1_elsewhere(sim, torch.float64) + check_k11(
                sim, torch.float64, False, phi_scale=1e-3)
        emit(dict(phase=1, path=label, setup_seconds_res2=setup_s, float32=r32,
                  float64=r64, warmed=warmed["res2"], seconds=time.perf_counter() - t1))
        # -- phase 3: the slice at res 2, float32 --------------------------------
        torch.cuda.empty_cache()
        # no phase 4 here: the flagship runs are profiled (the time limit)
        launches[label] = run_slice(
            sim, label, "3-D res 2 float32 g_syn_bar 10", 10, setup_s, profile=False,
            other_bytes=other_bytes)["launches"]
        del sim
        torch.cuda.empty_cache()
    del build_res2

    # -- phases 1 and 3 once more: the box of twice the length, where all
    # twelve kernels of the batched step are on the path; each is held
    # against its plain version at THIS path's shapes before the path is
    # driven, the P1 operator's kernels (K1, K1f, K11, K11f) on every
    # subdomain -----------------------------------------------------------------
    warmed["box"] = finish_warming(warming["box"])
    # phase 2's CPU legs, beside the card's runs from here on
    phase2_side = start_phase2_cpu()
    t0 = time.perf_counter()
    sim = build_idealized(dim=3, resolution=2, l=4, g_syn_bar=10.0,
                          dtype=torch.float32, device="cuda",
                          solver_options=SolverOptions(mg_banded=True))
    setup_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    rows32 = (check_kernels(sim, torch.float32, time_them=True)
              + check_mg_kernels(sim, torch.float32, time_them=True, all_bands=True)
              + p1_elsewhere(sim, torch.float32)
              + check_k11(sim, torch.float32, False, phi_scale=1e-3)
              + check_cases(k3_cases(sim, torch.float32, 1e-3, timed={(0, 2, True)}),
                            torch.float32, time_them=True))
    r64 = (check_kernels(sim, torch.float64, time_them=False)
           + check_mg_kernels(sim, torch.float64, time_them=False, all_bands=True)
           + p1_elsewhere(sim, torch.float64)
           + check_k11(sim, torch.float64, False, phi_scale=1e-3)
           + check_cases(k3_cases(sim, torch.float64, 1e-3), torch.float64,
                         time_them=False))
    emit(dict(phase=1, path="mg_banded=True l=4", setup_seconds=setup_s,
              float32=rows32, float64=r64, warmed=warmed["box"],
              seconds=time.perf_counter() - t1))
    torch.cuda.empty_cache()
    launches["long box"] = run_slice(
        sim, "mg_banded=True l=4", "3-D res 2 l=4 float32 g_syn_bar 10", 5,
        setup_s, profile=False, need=BATCHED_PATH)["launches"]
    del sim
    torch.cuda.empty_cache()

    # -- the astrocyte flagship: K11's phase 1, then batched and per-ion ------
    k11_rows, fl, k4_p, far_p = flagship(build_astrocyte, ASTROCYTE_BASELINE,
                                         SolverOptions)
    launches.update(fl)

    # -- the multi-device modes: (a)-(e) ---------------------------------------
    t0 = time.perf_counter()
    md_out, launches["sharded"] = multi_device_phase(build_idealized, SolverOptions)
    emit(dict(phase="multi_device", **md_out, seconds=time.perf_counter() - t0))
    shutil.rmtree(Path(MD_CARRIED["setup"]).parent, ignore_errors=True)
    MD_CARRIED.clear()

    # -- the checkpoint -> resume path on the flagship --------------------------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        res = resume_phase(ASTROCYTE_BASELINE, Path(tmp))
    emit(dict(phase="resume", case=f"astrocyte tissue mesh_n {MESH_N} float32 tuned options "
              f"mg_banded=True: {RESUME_STEPS} steps against {RESUME_STOP} + resume",
              **res, seconds=time.perf_counter() - t0))
    if not res["identical"]:
        raise AssertionError("resume: the resumed run differs from the uninterrupted one")
    if not sum(res["legs"]["split resumed"]["knp_iters"]):
        raise AssertionError("resume: the resumed steps ran no KNP iteration")

    # -- the campaign path: driver legs, the campaign tools, DCP ---------------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        res, launches["campaign"] = campaign_phase(Path(tmp))
    emit(dict(phase="campaign", case=f"astrocyte tissue mesh_n {CAMPAIGN['mesh_n']}, "
              "campaign_300ms float32 to 1 ms + resume to 2 ms; summarize_campaign; "
              "float64 accuracy leg + compare; DCP checkpoint", **res,
              seconds=time.perf_counter() - t0))

    # -- phase 2: GPU vs CPU parity, float64; the CPU legs ran beside the card
    build_idealized = shared_mesh(build_idealized)
    t0 = time.perf_counter()
    cpu, cpu_timing = finish_phase2_cpu(phase2_side)
    par = parity(build_idealized, SolverOptions, cpu)
    emit(dict(phase=2, case="3-D res 1 float64", **par, cpu_legs=cpu_timing,
              seconds=time.perf_counter() - t0))
    t0 = time.perf_counter()
    emit(dict(phase=2, case="3-D res 1 float64, EMI hierarchy refreshed every 2 steps",
              **parity_refresh(build_idealized, SolverOptions, cpu),
              seconds=time.perf_counter() - t0))
    t0 = time.perf_counter()
    emit(dict(phase=2, case="3-D res 1 float32 mg_banded=True, fine slab dtype",
              **bf16_slab_steps(build_idealized, SolverOptions),
              seconds=time.perf_counter() - t0))
    t0 = time.perf_counter()
    emit(dict(phase=2, case="astrocyte tissue mesh_n 20 float64",
              **parity_astrocyte(build_astrocyte, ASTROCYTE_BASELINE, SolverOptions, cpu),
              seconds=time.perf_counter() - t0))
    t0 = time.perf_counter()
    emit(dict(phase=2, case="solver options, 1 step (3-D) or 2 (2-D) float64, GPU "
              "against CPU",
              **parity_options(build_idealized, SolverOptions, cpu),
              seconds=time.perf_counter() - t0))
    del cpu

    # -- the manufactured-solution study on the card, float64 -----------------
    t0 = time.perf_counter()
    mms_out, launches["mms"] = mms_phase()
    emit(dict(phase="mms", case="manufactured solutions, float64: deflated-Jacobi CG, "
              "Jacobi GMRES batched (K3) and per ion (K11), rtol 1e-10; host LU; the "
              f"ladder's 2-D M = {LADDER_MS} on SA-AMG CG and batched GMRES",
              **mms_out, launches=launches["mms"], seconds=time.perf_counter() - t0))

    # -- (g), (h): the flagship builds' host set-up -----------------------------
    emit(dict(phase="drivers", case="the native sweep (g) and the flagship builds' "
              "host set-up (h)", **host_setup_record()))

    # one row per kernel.  The twelve of the batched step: all from the path
    # on which all twelve lie (the long box): launches of its 5 timed steps,
    # and error, times and bound of the kernel's first variant (tag 0;
    # K6a/K6b/K8 at B = 2, the values in the run dtype) at that path's
    # shapes.  K11 and K11f: from the per-ion flagship run, launches of its
    # 5 timed steps, error, times and bound on the flagship's ECS subdomain
    # (K11 with the first ion's scalars).  ms, plain_ms, library_ms: device
    # times with L2 flushed; call_ms: per call, back to back, host included.
    # Beside them every other path's launch counts (res 2: 10 steps;
    # flagship batched 10, per-ion 5, banded 5).
    first = {}
    for r in k11_rows + rows32:
        first.setdefault(r["name"], r)
    main_path = lambda name: ("flagship per-ion" if name.split()[0] in PER_ION
                              else "long box")
    # the P1 operator per solve: one fill and the applies that follow it
    # (launches of the apply per launch of the fill on the main path),
    # against as many launches of the cell-loop kernel it replaced
    by_k = {name.split()[0]: (name, r) for name, r in first.items()}
    per_solve = {}
    for k, kf in (("K1", "K1f"), ("K11", "K11f")):
        (name, r), (fname, rf) = by_k[k], by_k[kf]
        runs = launches[main_path(name)]
        applies = runs[name] / runs[fname]
        per_solve[k] = dict(
            path=main_path(name), applies_per_fill=applies, fill_ms=rf["ms"],
            apply_ms=r["ms"], ms=rf["ms"] + applies * r["ms"],
            recorded_cell_loop_ms=applies * CELL_LOOP_MS[k],
            recorded_cell_loop_source=CELL_LOOP_SOURCE,
            bound_ms=rf["bound_ms"] + applies * r["bound_ms"])
    # the batched KNP solve of one subdomain: one drift fill (K11f, timed on
    # the K3 row's subdomain), the GMRES applies of K3 and the right-hand
    # side's mass-only K3; per step and subdomain one fill and one mass term
    name, r = by_k["K3"]
    mass = next(x for x in rows32 if x["name"] == name and "mass-only" in x.get("variant", "")
                and "ms" in x)
    runs = launches["long box"]
    applies = runs[name] / runs["K11f drift_fill"] - 1.0
    per_solve["K3"] = dict(
        path="long box", applies_per_fill=applies, fill_ms=r["fill_ms"], apply_ms=r["ms"],
        mass_only_ms=mass["ms"], ms=r["fill_ms"] + applies * r["ms"] + mass["ms"],
        recorded_cell_loop_ms=[(applies + 1.0) * e for e in EARLIER_MS["K3"]],
        recorded_cell_loop_source=EARLIER_SOURCE,
        bound_ms_applies=applies * r["bound_ms"] + mass["bound_ms"])
    emit(dict(phase=1, case="P1 operator per solve: fill + applies", per_solve=per_solve,
              recorded_earlier_ms=EARLIER_MS, recorded_earlier_source=EARLIER_SOURCE))
    def entry(name, r, path):
        return dict(
            name=name, route="cuda",
            source=f"knpemi_tpu_torch/ops/csrc/{KERNEL_SOURCES[name.split()[0]][0]}.cu",
            replaces=KERNEL_SOURCES[name.split()[0]][1],
            launches=launches[path][name], main_path=path,
            launches_res2_banded=launches["mg_banded=True"][name],
            launches_res2_ell=launches["mg_banded=False"][name],
            launches_flagship_batched=launches["flagship batched"][name],
            launches_flagship_per_ion=launches["flagship per-ion"][name],
            launches_flagship_banded=launches["flagship banded"][name],
            launches_mms=launches["mms"][name], launches_bench=launches["bench"][name],
            launches_sharded=launches["sharded"][name],
            launches_campaign=launches["campaign"][name],
            launches_tools=launches["tools"][name],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], floor_ms=floor,
            library_ms=r["library_ms"], variant=r.get("variant"),
            shape=r.get("shape"), bytes_padded=r.get("bytes_padded"),
            **{k: r[k] for k in ("graph_ms", "call_ms", "library_call_ms", "ms_staged",
                                 "ms_l2", "dense_slab_bound_ms", "bound_slots_ms",
                                 "cell_loop_bound_ms", "k3_b1_ms", "k6a_b1_ms", "fill_ms",
                                 "sliced_transpose_ms", "deterministic", "nbytes_layout",
                                 "bound_layout_ms")
               if k in r})

    # K4 twice: on the long box's grad(phi) map (the table's continuity
    # row) and on the banded flagship's EMI level-0 prolongator, a V-cycle
    # operator (launches: the flagship banded run's)
    rows_out = [entry(name, r, main_path(name)) for name, r in sorted(
        first.items(), key=lambda kv: list(KERNEL_SOURCES).index(kv[0].split()[0]))]
    k4_at = next(i for i, e in enumerate(rows_out) if e["name"] == "K4 ellw_matvec")
    rows_out.insert(k4_at + 1, entry("K4 ellw_matvec", k4_p, "flagship banded"))
    # the far remainder's add on K5's and K6b's kernel, after K6b: on the
    # banded flagship's EMI hierarchy (one vector) and, beside it, a KNP
    # hierarchy's (B = 2); launches: its own share of the banded flagship
    # run's K5 and K6b counts
    if far_p["one vector EMI"] is not None:
        far = entry("K5 ellw_rmatvec", far_p["one vector EMI"], "flagship banded")
        far.update(name=FAR_ADD, launches=launches["flagship banded"][FAR_ADD],
                   jax_counterpart="knpemi_tpu/solvers/mg.py:1038",
                   **{f"launches_{k}": launches[p][FAR_ADD] for k, p in (
                       ("res2_ell", "mg_banded=False"), ("res2_banded", "mg_banded=True"),
                       ("long_box", "long box"),
                       ("flagship_batched", "flagship batched"),
                       ("flagship_per_ion", "flagship per-ion"),
                       ("flagship_banded", "flagship banded"), ("mms", "mms"),
                       ("bench", "bench"), ("sharded", "sharded"),
                       ("campaign", "campaign"), ("tools", "tools"))})
        rb = far_p["B=2 KNP"]
        if rb is not None:
            far["batch"] = {k: rb.get(k) for k in (
                "variant", "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by", "graph_ms", "shape", "deterministic")}
        k6b_at = next(i for i, e in enumerate(rows_out) if e["name"] == "K6b ellw_rmatvec_batch")
        rows_out.insert(k6b_at + 1, far)
    emit({"kernels": rows_out})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        stop_warming()
