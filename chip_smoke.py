#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (knpemi_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines tagged with its number (the two
multigrid paths run one after the other, so the lines of phases 1, 3
and 4 come in two groups):

0. device and build: the card's name and power limit, the torch and
   CUDA versions, and the build of every CUDA kernel from ops/csrc;
1. kernels: each of the eleven hand-written kernels against its plain
   PyTorch version on the card, in float32 and float64 (K7/K8 also with
   a bfloat16 slab) — the six assembly kernels at the shapes of the 3-D
   res-2 mesh, the five multigrid kernels at the shapes of the res-2
   banded hierarchies' own operators (EMI for K5/K7, KNP tag 0 at B = 2
   and once at B = 8 for K6a/K6b/K8); times of kernel, plain version
   and (where one PyTorch call computes the same function) that call,
   beside the bound;
2. parity: 2 float64 steps of the 3-D res-1 scenario on the GPU and on
   the CPU, with ELL and with banded multigrid — equal Krylov iteration
   counts on all four, phi_M within 1e-9 V and concentrations within
   1e-9 relative between GPU and CPU; then 5 float32 res-1 steps with
   the fine smoothing slabs in float32 and in bfloat16 (mg_band_bf16);
3. slice: the 3-D res-2 scenario (float32, g_syn_bar 10), 2 warm-up and
   10 timed steps, once per multigrid path (mg_banded=False, then
   mg_banded=True with the layout build_hierarchy chose per level);
   then the same scenario in the box of twice the length (l = 4, 1.1 M
   dofs/step), mg_banded=True, 2 warm-up and 5 timed steps: there the
   KNP transfers take the windowed-ELL layout too, so all eleven
   kernels are on the path, and phase 1 is run once more on this
   simulation's own operators before it is driven (K5 and K6b on its
   restriction layouts): the kernel table's launches, times, bounds
   and errors all come from this one path.  The launch counts are set
   to 0 just before
   each timed run and read just after; every kernel the path can reach
   must have launched (all eleven in the long box), K7 or K8 on a
   banded path, and every step converged;
4. profile, per res-2 path: the step's four phases timed by host clock over 3
   steps, their kernel counts in one step, then 3 steps under
   torch.profiler — device kernel time and busy share, kernels per
   step, the top kernels.

Then the kernel table as one JSON line, the card's name and power
limit, and the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
Any failure raises and the script exits non-zero without that line; it
also exits non-zero when CUDA is unavailable or when the package is not
beside it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# peak rates outside the tensor cores (NVIDIA H100 SXM data sheet)
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
TOL = {"float32": 1e-5, "float64": 1e-12}  # kernel vs plain, x max|y|


def emit(obj):
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


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def kernel_cases(sim, dtype):
    """The six assembly kernels at the main path's shapes, on random inputs
    made from a seed: dicts of name, kern / plain / lib (calls without
    arguments; lib may be None), nbytes (inputs read once + output
    written once) and ops."""
    import torch

    from knpemi_tpu_torch.ops import assembly as A

    dev = sim.device
    g = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *shape: torch.randn(*shape, generator=g, device=dev, dtype=dtype)
    pos = lambda *shape: 1.0 + torch.rand(*shape, generator=g, device=dev, dtype=dtype)
    f = lambda t: t.to(dtype)
    es = torch.empty((), dtype=dtype).element_size()

    es_, ks = sim.emi_sys.sub[0], sim.knp_sys.sub[0]
    mb_e = sim.emi_sys.mem[1]
    cells, grads, vols = es_["cells"], f(es_["grads"]), f(es_["vols"])
    nc, k = cells.shape
    dim = grads.shape[-1]
    n = es_["n_dofs"]
    fd = mb_e["facet_dofs"]
    nf, kf = fd.shape
    n_mem = mb_e["n_mem"]
    Ns = sim.knp_sys.n_solved
    F = 3 * len(sim.ions) + 2

    x, wv = rnd(n), vols * pos(nc)
    # phi of the main path's size (mV), and K3's grad(phi) per cell from it
    # as the main path forms it: the drift term is then a visible share of
    # K3's output, not one below the float32 tolerance
    gcols, gvals, phi = ks["grad_cols"], f(ks["grad_vals"]), 1e-3 * rnd(n)
    X, coef = rnd(Ns, n), f(ks["coef"])
    w = A.ell_matvec_plain(gcols, gvals, phi).reshape(nc, dim)
    xm, fwv = rnd(n_mem), f(mb_e["wv"])
    Xm, V = rnd(F, n_mem), rnd(2 * Ns, nf, kf)
    csr = torch.sparse_csr_tensor(
        torch.arange(0, gcols.numel() + 1, gcols.shape[1], device=dev),
        gcols.reshape(-1).long(), gvals.reshape(-1), size=(gcols.shape[0], n))
    fdl = fd.long()
    scat = lambda: torch.zeros(2 * Ns, n_mem, dtype=dtype, device=dev).index_add_(
        1, fdl.reshape(-1), V.reshape(2 * Ns, -1))

    def case(name, kern, plain, lib, inputs, n_out, ops, **extra):
        return dict(name=name, kern=lambda: kern(*inputs),
                    plain=lambda: plain(*inputs), lib=lib,
                    nbytes=_nbytes(*inputs) + n_out * es, ops=ops, **extra)

    k3_in = (X, cells, grads, vols, w, coef)
    return [
        case("K1 emi_stiffness", A.emi_stiffness, A.emi_stiffness_plain, None,
             (x, cells, grads, wv), n, nc * (4 * k * dim + k)),
        case("K2 facet_mass", A.facet_mass, A.facet_mass_plain, None,
             (xm, fd, fwv), n_mem, nf * 4 * kf),
        case("K3 knp_apply_batch", A.knp_apply_batch, A.knp_apply_batch_plain, None,
             k3_in, Ns * n,
             nc * (2 * k * dim + Ns * (k + 2 * k * dim + k * (2 * dim + 10))),
             # K3 without its drift term, for the share the term carries
             no_drift=lambda: A.knp_apply_batch_plain(
                 *k3_in[:4], torch.zeros_like(w), coef)),
        case("K4 ell_matvec", A.ell_matvec, A.ell_matvec_plain,
             lambda: torch.mv(csr, phi), (gcols, gvals, phi), gcols.shape[0],
             2 * gcols.numel()),
        case("K9 facet_gather", A.facet_gather, A.facet_gather_plain,
             lambda: Xm[:, fdl], (Xm, fd), F * nf * kf, 0),
        case("K10 facet_scatter", lambda *a: A.facet_scatter(*a, n_mem),
             lambda *a: A.facet_scatter_plain(*a, n_mem), scat, (V, fd),
             2 * Ns * n_mem, 2 * Ns * nf * kf),
    ]


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
            return host.device(dtype, lv["p_vals"].device), (
                f"no {'/'.join(roles)} ellw operator in this build: "
                f"build_ellw of level {i} P")
    raise AssertionError("build_ellw refuses every prolongator of the hierarchy")


def _csr_of_ell(e, transpose: bool):
    import torch

    rows = torch.arange(e.n_rows, device=e.vals.device).repeat_interleave(e.K)
    idx = torch.stack([rows, e.cols.reshape(-1).long()])
    keep = e.vals.reshape(-1) != 0
    A = torch.sparse_coo_tensor(idx[:, keep], e.vals.reshape(-1)[keep],
                                (e.n_rows, e.n_cols)).coalesce()
    return (A.t().coalesce() if transpose else A).to_sparse_csr()


def _csr_of_window(slabT, w0, W, n, m, dtype):
    """The sparse matrix one window of a banded operator stores."""
    import torch

    NB, R = slabT.shape[0] // W, slabT.shape[1]
    nz = slabT.nonzero()
    blk, w = nz[:, 0] // W, nz[:, 0] % W
    rows, cols = blk * R + nz[:, 1], w0.long()[blk] + w
    keep = (rows < n) & (cols < m)
    vals = slabT[nz[:, 0], nz[:, 1]].to(dtype)
    return torch.sparse_coo_tensor(torch.stack([rows[keep], cols[keep]]),
                                   vals[keep], (n, m)).coalesce().to_sparse_csr()


def mg_kernel_cases(sim, dtype):
    """The five multigrid kernels at the shapes of ``sim``'s banded
    hierarchies: K5 and K7 on operators of the EMI hierarchy, K6a, K6b and
    K8 on operators of the KNP hierarchy of tag 0 at B = 2 (the solved
    ions) and once at B = 8; the scatter kernels K5 and K6b on a
    restriction (pt) layout, the gather kernel K6a on a level operator or
    prolongator.  Bounds: K7/K8 move the slab, the window starts and the
    vectors; K5/K6 move an index and a value per NONZERO slot (what this
    matrix needs) and the vectors — the kernels read the padded slots
    too, whose bytes stand beside the bound as ``bytes_padded``."""
    import dataclasses

    import torch

    from knpemi_tpu_torch.ops import banded as TB
    from knpemi_tpu_torch.ops import ell as TE

    dev = sim.device
    g = torch.Generator(device=dev).manual_seed(1)
    rnd = lambda *shape: torch.randn(*shape, generator=g, device=dev, dtype=dtype)
    es = torch.empty((), dtype=dtype).element_size()
    emi, knp = sim.emi_solver.mg, sim.knp_solver.mg[0]
    cases = []

    def ell_cases(name, mg, roles, wrapper, plain, transpose, Bs):
        e, src = _ellw_case_source(mg, dtype, roles)
        e = dataclasses.replace(e, vals=e.vals.to(dtype))
        nnz = int((e.vals != 0).sum())
        csr = _csr_of_ell(e, transpose)
        n_in, n_out = (e.n_rows, e.n_cols) if transpose else (e.n_cols, e.n_rows)
        for B in Bs:
            V = rnd(n_in) if B is None else rnd(B, n_in)
            nb = B or 1
            lib = (lambda V=V: torch.mv(csr, V)) if B is None else (
                lambda V=V: torch.sparse.mm(csr, V.T))
            cases.append(dict(
                name=name, variant=f"B={nb}", kern=lambda V=V: wrapper(e, V),
                plain=lambda V=V: plain(e, V), lib=lib,
                nbytes=nnz * (4 + es) + nb * (n_in + n_out) * es, ops=2 * nnz * nb,
                bytes_padded=e.n_rows * e.K * (4 + es) + nb * (n_in + n_out) * es,
                shape=dict(rows=e.n_rows, cols=e.n_cols, K=e.K, nnz=nnz, source=src)))

    def band_cases(name, mg, batch, Bs):
        found = _first_layout(mg.levels, "band", ("a", "ap", "p", "pt"))
        if found is None:
            raise AssertionError(f"{name}: no banded operator in the hierarchy")
        i, w, band = found
        win = band["windows"][0]
        W, w0, n, m = win["W"], win["w0"], band["n"], band["m"]
        slab_run = win["slabT"].to(dtype)
        csr = _csr_of_window(slab_run, w0, W, n, m, dtype)
        for B in Bs:
            V = rnd(B, m) if batch else rnd(m)
            for slabT in (slab_run, slab_run.to(torch.bfloat16)):
                sname = str(slabT.dtype).replace("torch.", "")
                mv = TB.banded_matvec_batch if batch else TB.banded_matvec
                pl = TB.banded_matvec_batch_plain if batch else TB.banded_matvec_plain
                lib = (lambda V=V: torch.sparse.mm(csr, V.T)) if batch else (
                    lambda V=V: torch.mv(csr, V))
                cases.append(dict(
                    name=name, variant=f"B={B} slab={sname}",
                    kern=lambda s=slabT, V=V: mv(s, w0, V, n, W),
                    plain=lambda s=slabT, V=V: pl(s, w0, V, n, W),
                    # the library call works on the run-dtype matrix
                    lib=lib if slabT is slab_run else None,
                    nbytes=_nbytes(slabT, w0) + B * (m + n) * es,
                    ops=2 * slabT.numel() * B,
                    shape=dict(NB=slabT.shape[0] // W, R=slabT.shape[1], W=W, n=n,
                               m=m, source=f"level {i} {w}_band window 0")))

    ell_cases("K5 ellw_rmatvec", emi, ("pt",), TE.ellw_rmatvec,
              TE.ellw_rmatvec_plain, True, (None,))
    ell_cases("K6a ellw_matvec_batch", knp, ("a", "p", "ap"), TE.ellw_matvec_batch,
              TE.ellw_matvec_batch_plain, False, (2, 8))
    ell_cases("K6b ellw_rmatvec_batch", knp, ("pt",), TE.ellw_rmatvec_batch,
              TE.ellw_rmatvec_batch_plain, True, (2, 8))
    band_cases("K7 banded_matvec", emi, False, (1,))
    band_cases("K8 banded_matvec_batch", knp, True, (2, 8))
    return cases


def check_cases(cases, dtype, time_them: bool):
    """Run each case's kernel against its plain version (tolerance TOL of
    the vector dtype, times max|y|); with ``time_them`` also time kernel,
    plain version and library call and compute the bound."""
    import torch

    dname = str(dtype).replace("torch.", "")
    rows = []
    for c in cases:
        label = " ".join(filter(None, [c["name"], c.get("variant"), dname]))
        y = c["kern"]()
        torch.cuda.synchronize()
        y_ref = c["plain"]()
        err = float((y - y_ref).abs().max())
        scale = float(y_ref.abs().max()) or 1.0
        if y.shape != y_ref.shape or not (err <= TOL[dname] * scale) \
                or not bool(torch.isfinite(y).all()):
            raise AssertionError(
                f"{label}: max|kernel - plain| = {err:.3e} exceeds "
                f"{TOL[dname]:.0e} x max|y| = {TOL[dname] * scale:.3e}")
        row = dict(name=c["name"], dtype=dname, max_abs_err=err, max_abs_y=scale)
        for key in ("variant", "shape", "bytes_padded"):
            if key in c:
                row[key] = c[key]
        if "no_drift" in c:
            # share of K3's output that the drift term carries
            row["drift_share"] = float((y_ref - c["no_drift"]()).abs().max()) / scale
        if time_them:
            t_bytes = c["nbytes"] / HBM_BYTES_PER_S * 1e3
            t_ops = c["ops"] / PEAK_FLOPS[dname] * 1e3
            row.update(
                ms=cuda_ms(c["kern"]),
                plain_ms=cuda_ms(c["plain"], reps=20),
                library_ms=None if c["lib"] is None else cuda_ms(c["lib"], reps=20),
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=c["nbytes"], ops=c["ops"],
            )
        rows.append(row)
    return rows


def check_kernels(sim, dtype, time_them: bool):
    return check_cases(kernel_cases(sim, dtype), dtype, time_them)


def check_mg_kernels(sim, dtype, time_them: bool):
    return check_cases(mg_kernel_cases(sim, dtype), dtype, time_them)


def max_rel(a, b):
    import torch

    return float(((a - b).abs() / b.abs().clamp_min(1e-300)).max())


def parity(build_idealized, SolverOptions):
    """2 float64 steps of the 3-D res-1 scenario on the GPU and the CPU,
    with ELL and with banded multigrid."""
    import torch

    out = {}
    states = {}
    for banded in (False, True):
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            sim = build_idealized(dim=3, resolution=1, g_syn_bar=10.0,
                                  dtype=torch.float64, device=dev,
                                  solver_options=SolverOptions(mg_banded=banded))
            s = sim.init_state()
            s, it_e, it_k, ok = sim.run(s, 2)
            key = f"{'banded' if banded else 'ell'}_{dev}"
            out[key] = dict(emi_iters=it_e.tolist(), knp_iters=it_k.tolist(),
                            seconds=time.perf_counter() - t0)
            if banded:
                out[key]["emi_layout"] = sim.emi_solver.mg.layout()
            states[key] = s
    ref = out["ell_cpu"]
    for key, o in out.items():
        if o["emi_iters"] != ref["emi_iters"] or o["knp_iters"] != ref["knp_iters"]:
            raise AssertionError(f"iteration counts differ ({key} vs ell_cpu): {out}")
    for path in ("ell", "banded"):
        g, c = states[f"{path}_cuda"], states[f"{path}_cpu"]
        dphi = max(float((g.phi_M[m].cpu() - c.phi_M[m]).abs().max()) for m in c.phi_M)
        dc = max(max_rel(g.c[t].cpu(), c.c[t]) for t in c.c)
        if not (dphi <= 1e-9 and dc <= 1e-9):
            raise AssertionError(f"{path}: GPU vs CPU: max|d phi_M| {dphi:.3e} V, "
                                 f"max rel d c {dc:.3e} (gates 1e-9)")
        out[f"{path}_max_abs_dphi_M_V"] = dphi
        out[f"{path}_max_rel_dc"] = dc
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


def phase_kernels(sim, state):
    """Device kernels (memory copies and sets included) that each of the
    step's four phases launches in one step, each phase under a profiler
    of its own."""
    import contextlib

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    counts = {}

    @contextlib.contextmanager
    def span(name):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            yield
            torch.cuda.synchronize()
        counts[name.split("/", 1)[1]] = sum(
            e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)

    sim.step(state, span=span)
    return counts


def profile_steps(sim, state, n_steps: int, ms_per_step: float):
    """n_steps under torch.profiler: device kernel time per step, its share
    of the unprofiled step time, kernels per step, the step phases'
    spans and the kernels with the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sim.run(state, n_steps)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev_t = lambda e: getattr(e, "self_device_time_total", 0) or 0
    # the step's spans also appear on the device timeline: not kernels
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.key.startswith("step/")]
    spans = {e.key: e.cpu_time_total / 1e3 / n_steps for e in events
             if e.key.startswith("step/") and e.device_type == DeviceType.CPU}
    dev_ms = sum(dev_t(e) for e in kernels) / 1e3 / n_steps
    top = sorted(kernels, key=dev_t, reverse=True)[:12]
    return dict(
        steps=n_steps, profiled_ms_per_step=wall / n_steps * 1e3,
        device_kernel_ms_per_step=dev_ms if dev_ms else "not measured",
        device_busy_share=dev_ms / ms_per_step if dev_ms else "not measured",
        kernels_per_step=sum(e.count for e in kernels) / n_steps,
        span_ms_per_step=spans,
        top_kernels=[dict(name=e.key[:90], ms_per_step=dev_t(e) / 1e3 / n_steps,
                          calls_per_step=e.count / n_steps) for e in top],
    )


# K-number -> (source file, file:line of the TPU kernel it replaces)
KERNEL_SOURCES = {
    "K1": ("cells", "knpemi_tpu/ops/pallas_assembly.py:364"),
    "K2": ("facets", "knpemi_tpu/ops/pallas_assembly.py:653"),
    "K3": ("cells", "knpemi_tpu/ops/pallas_assembly.py:444"),
    "K4": ("cells", "knpemi_tpu/ops/pallas_ell.py:330"),
    "K5": ("mg", "knpemi_tpu/ops/pallas_ell.py:347"),
    "K6a": ("mg", "knpemi_tpu/ops/pallas_ell.py:476"),
    "K6b": ("mg", "knpemi_tpu/ops/pallas_ell.py:494"),
    "K7": ("mg", "knpemi_tpu/ops/pallas_banded.py:38"),
    "K8": ("mg", "knpemi_tpu/ops/pallas_banded.py:89"),
    "K9": ("facets", "knpemi_tpu/ops/pallas_assembly.py:742"),
    "K10": ("facets", "knpemi_tpu/ops/pallas_assembly.py:758"),
}
ASSEMBLY = ("K1", "K2", "K3", "K4", "K9", "K10")


def reachable_kernels(sim):
    """K-numbers the step of ``sim`` can launch: the six assembly kernels
    and, from the layouts its hierarchies took, the multigrid ones."""
    out = set(ASSEMBLY)
    emi = sim.emi_solver.mg.layout()
    knp = [lv for mg in sim.knp_solver.mg.values() for lv in mg.layout()]
    forms = lambda lay, roles: {lv[w] for lv in lay for w in roles}
    if "band" in forms(emi, ("A", "P", "Pt", "AP")):
        out.add("K7")
    if "band" in forms(knp, ("A", "P", "Pt", "AP")):
        out.add("K8")
    if "ellw" in forms(emi, ("Pt",)):
        out.add("K5")
    if "ellw" in forms(knp, ("A", "P", "AP")):
        out.add("K6a")
    if "ellw" in forms(knp, ("Pt",)):
        out.add("K6b")
    return out


def run_slice(sim, label: str, case: str, n_steps: int, setup_s: float,
              profile: bool = True, need=(), other_bytes: int = 0):
    """Phases 3 and 4 for one simulation: warm up, set the launch counts
    to 0, time n_steps, read the counts, check the result (every kernel
    the hierarchies can reach, and every K-number in ``need``, launched);
    then, with ``profile``, phase 4.  ``other_bytes`` of device memory
    belong to another simulation and are taken off the peak.  Returns
    the launch counts and the state reached."""
    import torch

    from knpemi_tpu_torch import ops
    from knpemi_tpu_torch.sim import dofs_per_step

    t0 = time.perf_counter()
    state = sim.init_state()
    state, it_e0, it_k0, _ = sim.run(state, 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t1 = time.perf_counter()
    state, it_e, it_k, ok = sim.run(state, n_steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = ops.launch_counts()
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
        converged=bool(ok.all()), launches=launches, reachable=sorted(reach),
        peak_device_bytes=torch.cuda.max_memory_allocated() - other_bytes,
        host_setup_seconds=setup_s,
        emi_layout=sim.emi_solver.mg.layout(),
        knp_layout={t: mg.layout() for t, mg in sim.knp_solver.mg.items()},
        phi_M_range_V=[float(state.phi_M[1].min()), float(state.phi_M[1].max())],
    )
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)
    if not profile:
        return launches, state

    # -- phase 4: where the step's time goes ---------------------------------
    t0 = time.perf_counter()
    phases = phase_ms(sim, state, 3)
    phase_k = phase_kernels(sim, state)
    prof = profile_steps(sim, state, 3, wall / n_steps * 1e3)
    emit(dict(phase=4, path=label, case=case + ", 3 profiled steps",
              phase_ms_per_step=phases, phase_kernels_per_step=phase_k,
              **prof, seconds=time.perf_counter() - t0))
    return launches, state


def bf16_slab_steps(build_idealized, SolverOptions, n_steps: int = 5):
    """SolverOptions.mg_band_bf16 driven once: n_steps float32 steps of the
    3-D res-1 scenario (every level banded there) with the fine smoothing
    slabs stored in float32 and in bfloat16.  Every step must converge,
    the bfloat16 run must hold bfloat16 fine slabs and launch K7 and K8
    with them; the iteration counts of both are reported."""
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
                w["slabT"].dtype != want for b in fine for w in b["windows"]):
            raise AssertionError(f"mg_band_bf16={bf16}: a fine level is not "
                                 f"banded or its slab is not {want}")
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
            knp_iters=it_k.tolist(), fine_slab_bytes=sum(
                _nbytes(w["slabT"]) for b in fine for w in b["windows"]))
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    repo = Path(__file__).resolve().parent
    if not (repo / "knpemi_tpu_torch").is_dir():
        print("chip_smoke: knpemi_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(repo))
    from knpemi_tpu_torch.ops import _build
    from knpemi_tpu_torch.sim import SolverOptions, build_idealized

    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    # -- phase 0: device and build ------------------------------------------
    t0 = time.perf_counter()
    _build.build()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in _build.build_log.items()}
    emit(dict(phase=0, nvidia_smi=smi, torch=torch.__version__,
              cuda=torch.version.cuda, build_seconds=_build.build_seconds,
              ptxas=ptxas, seconds=time.perf_counter() - t0))

    launches = {}
    for banded in (False, True):
        label = "mg_banded=True" if banded else "mg_banded=False"
        # -- phase 1: kernels against their plain versions --------------------
        other_bytes = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        sim = build_idealized(dim=3, resolution=2, g_syn_bar=10.0,
                              dtype=torch.float32, device="cuda",
                              solver_options=SolverOptions(mg_banded=banded))
        setup_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        check = check_mg_kernels if banded else check_kernels
        r32 = check(sim, torch.float32, time_them=True)
        r64 = check(sim, torch.float64, time_them=True)
        emit(dict(phase=1, path=label, setup_seconds_res2=setup_s, float32=r32,
                  float64=r64, seconds=time.perf_counter() - t1))
        # -- phases 3 and 4: the slice at res 2, float32 ------------------------
        torch.cuda.empty_cache()
        launches[label], _ = run_slice(
            sim, label, "3-D res 2 float32 g_syn_bar 10", 10, setup_s,
            other_bytes=other_bytes)
        del sim
        torch.cuda.empty_cache()

    # -- phases 1 and 3 once more: the box of twice the length, where all
    # eleven kernels are on the path; each is held against its plain version
    # at THIS path's shapes before the path is driven --------------------------
    t0 = time.perf_counter()
    sim = build_idealized(dim=3, resolution=2, l=4, g_syn_bar=10.0,
                          dtype=torch.float32, device="cuda",
                          solver_options=SolverOptions(mg_banded=True))
    setup_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    rows32 = (check_kernels(sim, torch.float32, time_them=True)
              + check_mg_kernels(sim, torch.float32, time_them=True))
    r64 = (check_kernels(sim, torch.float64, time_them=False)
           + check_mg_kernels(sim, torch.float64, time_them=False))
    emit(dict(phase=1, path="mg_banded=True l=4", setup_seconds=setup_s,
              float32=rows32, float64=r64, seconds=time.perf_counter() - t1))
    torch.cuda.empty_cache()
    launches["long box"], _ = run_slice(
        sim, "mg_banded=True l=4", "3-D res 2 l=4 float32 g_syn_bar 10", 5,
        setup_s, profile=False, need=KERNEL_SOURCES)
    del sim
    torch.cuda.empty_cache()

    # -- phase 2: GPU vs CPU parity, float64 ---------------------------------
    t0 = time.perf_counter()
    par = parity(build_idealized, SolverOptions)
    emit(dict(phase=2, case="3-D res 1 float64", **par,
              seconds=time.perf_counter() - t0))
    t0 = time.perf_counter()
    emit(dict(phase=2, case="3-D res 1 float32 mg_banded=True, fine slab dtype",
              **bf16_slab_steps(build_idealized, SolverOptions),
              seconds=time.perf_counter() - t0))

    # one row per kernel, all of it from the path on which all eleven lie
    # (the long box): launches of its 5 timed steps, and error, times and
    # bound of the kernel's first variant (K6a/K6b/K8 at B = 2, the slab in
    # the run dtype) at that path's shapes.  Beside them the two res-2
    # paths' launch counts over 10 steps.
    first = {}
    for r in rows32:
        first.setdefault(r["name"], r)
    emit({"kernels": [
        dict(name=name, route="cuda",
             source=f"knpemi_tpu_torch/ops/csrc/{KERNEL_SOURCES[name.split()[0]][0]}.cu",
             replaces=KERNEL_SOURCES[name.split()[0]][1],
             launches=launches["long box"][name],
             launches_res2_banded=launches["mg_banded=True"][name],
             launches_res2_ell=launches["mg_banded=False"][name],
             max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
             bound_ms=r["bound_ms"], bound_by=r["bound_by"],
             library_ms=r["library_ms"], variant=r.get("variant"),
             shape=r.get("shape"), bytes_padded=r.get("bytes_padded"))
        for name, r in first.items()
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
