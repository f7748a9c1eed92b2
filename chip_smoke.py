#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (knpemi_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

0. device and build: the card's name and power limit, the torch and
   CUDA versions, and the build of every CUDA kernel from ops/csrc;
1. kernels: each hand-written kernel against its plain PyTorch version
   on the card, in float32 and float64, at the shapes of the 3-D res-2
   mesh; times of kernel, plain version and (where one PyTorch call
   computes the same function) that call, beside the bound;
2. parity: 2 float64 steps of the 3-D res-1 scenario on the GPU and on
   the CPU — equal Krylov iteration counts, phi_M within 1e-9 V,
   concentrations within 1e-9 relative;
3. slice: the 3-D res-2 scenario (float32, g_syn_bar 10), 2 warm-up and
   10 timed steps; every kernel must have launched and every step
   converged;
4. profile: the step's four phases timed by host clock over 3 steps,
   their kernel counts in one step, then 3 steps under torch.profiler —
   device kernel time and busy share, kernels per step, the top kernels.

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


def kernel_cases(sim, dtype):
    """(name, wrapper call, plain call, library call or None, inputs,
    output, op count) for every kernel at the main path's shapes, on
    random inputs made from a seed."""
    import torch

    from knpemi_tpu_torch.ops import assembly as A

    dev = sim.device
    g = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *shape: torch.randn(*shape, generator=g, device=dev, dtype=dtype)
    pos = lambda *shape: 1.0 + torch.rand(*shape, generator=g, device=dev, dtype=dtype)
    f = lambda t: t.to(dtype)

    es, ks = sim.emi_sys.sub[0], sim.knp_sys.sub[0]
    mb_e = sim.emi_sys.mem[1]
    cells, grads, vols = es["cells"], f(es["grads"]), f(es["vols"])
    nc, k = cells.shape
    dim = grads.shape[-1]
    n = es["n_dofs"]
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
    return [
        ("K1 emi_stiffness", A.emi_stiffness, A.emi_stiffness_plain, None,
         (x, cells, grads, wv), n, nc * (4 * k * dim + k)),
        ("K2 facet_mass", A.facet_mass, A.facet_mass_plain, None,
         (xm, fd, fwv), n_mem, nf * 4 * kf),
        ("K3 knp_apply_batch", A.knp_apply_batch, A.knp_apply_batch_plain, None,
         (X, cells, grads, vols, w, coef), Ns * n,
         nc * (2 * k * dim + Ns * (k + 2 * k * dim + k * (2 * dim + 10)))),
        ("K4 ell_matvec", A.ell_matvec, A.ell_matvec_plain,
         lambda: torch.mv(csr, phi), (gcols, gvals, phi), gcols.shape[0],
         2 * gcols.numel()),
        ("K9 facet_gather", A.facet_gather, A.facet_gather_plain,
         lambda: Xm[:, fdl], (Xm, fd), F * nf * kf, 0),
        ("K10 facet_scatter", lambda *a: A.facet_scatter(*a, n_mem),
         lambda *a: A.facet_scatter_plain(*a, n_mem), scat, (V, fd),
         2 * Ns * n_mem, 2 * Ns * nf * kf),
    ]


def check_kernels(sim, dtype, time_them: bool):
    import torch

    dname = str(dtype).replace("torch.", "")
    rows = []
    for name, kern, plain, lib, inputs, n_out, ops in kernel_cases(sim, dtype):
        y = kern(*inputs)
        torch.cuda.synchronize()
        y_ref = plain(*inputs)
        err = float((y - y_ref).abs().max())
        scale = float(y_ref.abs().max()) or 1.0
        if not (err <= TOL[dname] * scale) or not bool(torch.isfinite(y).all()):
            raise AssertionError(
                f"{name} ({dname}): max|kernel - plain| = {err:.3e} exceeds "
                f"{TOL[dname]:.0e} x max|y| = {TOL[dname] * scale:.3e}")
        row = dict(name=name, dtype=dname, max_abs_err=err, max_abs_y=scale)
        if name.startswith("K3"):
            # share of K3's output that the drift term carries
            *head, w, coef = inputs
            y0 = plain(*head, torch.zeros_like(w), coef)
            row["drift_share"] = float((y_ref - y0).abs().max()) / scale
        if time_them:
            nbytes = sum(t.numel() * t.element_size() for t in inputs) \
                + n_out * y.element_size()
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / PEAK_FLOPS[dname] * 1e3
            row.update(
                ms=cuda_ms(lambda: kern(*inputs)),
                plain_ms=cuda_ms(lambda: plain(*inputs), reps=20),
                library_ms=None if lib is None else cuda_ms(lib),
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, ops=ops,
            )
        rows.append(row)
    return rows


def max_rel(a, b):
    import torch

    return float(((a - b).abs() / b.abs().clamp_min(1e-300)).max())


def parity(build_idealized):
    """2 float64 steps of the 3-D res-1 scenario on the GPU and the CPU."""
    import torch

    out = {}
    states = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        sim = build_idealized(dim=3, resolution=1, g_syn_bar=10.0,
                              dtype=torch.float64, device=dev)
        s = sim.init_state()
        s, it_e, it_k, ok = sim.run(s, 2)
        out[dev] = dict(emi_iters=it_e.tolist(), knp_iters=it_k.tolist(),
                        seconds=time.perf_counter() - t0)
        states[dev] = s
    g, c = states["cuda"], states["cpu"]
    if out["cuda"]["emi_iters"] != out["cpu"]["emi_iters"] or \
            out["cuda"]["knp_iters"] != out["cpu"]["knp_iters"]:
        raise AssertionError(f"GPU and CPU iteration counts differ: {out}")
    dphi = max(float((g.phi_M[m].cpu() - c.phi_M[m]).abs().max()) for m in c.phi_M)
    dc = max(max_rel(g.c[t].cpu(), c.c[t]) for t in c.c)
    if not (dphi <= 1e-9 and dc <= 1e-9):
        raise AssertionError(f"GPU vs CPU: max|d phi_M| {dphi:.3e} V, "
                             f"max rel d c {dc:.3e} (gates 1e-9)")
    out.update(max_abs_dphi_M_V=dphi, max_rel_dc=dc)
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
    from knpemi_tpu_torch.ops import assembly as A
    from knpemi_tpu_torch.sim import build_idealized, dofs_per_step

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

    # -- phase 1: kernels against their plain versions ------------------------
    t0 = time.perf_counter()
    sim = build_idealized(dim=3, resolution=2, g_syn_bar=10.0,
                          dtype=torch.float32, device="cuda")
    setup_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    rows32 = check_kernels(sim, torch.float32, time_them=True)
    rows64 = check_kernels(sim, torch.float64, time_them=True)
    emit(dict(phase=1, setup_seconds_res2=setup_s, float32=rows32,
              float64=rows64, seconds=time.perf_counter() - t1))

    # -- phase 2: GPU vs CPU parity, float64 ---------------------------------
    t0 = time.perf_counter()
    par = parity(build_idealized)
    emit(dict(phase=2, case="3-D res 1 float64", **par,
              seconds=time.perf_counter() - t0))

    # -- phase 3: the slice at res 2, float32 ----------------------------------
    t0 = time.perf_counter()
    state = sim.init_state()
    state, it_e0, it_k0, _ = sim.run(state, 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.reset_launch_counts()
    n_steps = 10
    t1 = time.perf_counter()
    state, it_e, it_k, ok = sim.run(state, n_steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = A.launch_counts()
    for m, v in state.phi_M.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"phi_M[{m}] is not finite")
    for t, v in state.c.items():
        if not bool(torch.isfinite(v).all()) or tuple(v.shape) != (
                len(sim.ions), sim.geom.subdomains[t].n_dofs):
            raise AssertionError(f"c[{t}] is not finite or has the wrong shape")
    if not all(launches.values()):
        raise AssertionError(f"a kernel did not launch on the main path: {launches}")
    if not ok.all():
        raise AssertionError("a step did not converge")
    dofs = dofs_per_step(sim)
    emit(dict(
        phase=3, case="3-D res 2 float32 g_syn_bar 10", dofs_per_step=dofs,
        steps=n_steps, ms_per_step=wall / n_steps * 1e3,
        mdofs_per_s=dofs * n_steps / wall / 1e6,
        emi_iters=it_e.tolist(), knp_iters=it_k.tolist(),
        warmup_iters=[it_e0.tolist(), it_k0.tolist()],
        converged=bool(ok.all()), launches=launches,
        peak_device_bytes=torch.cuda.max_memory_allocated(),
        host_setup_seconds=setup_s, seconds=time.perf_counter() - t0,
        phi_M_range_V=[float(state.phi_M[1].min()), float(state.phi_M[1].max())],
    ))

    # -- phase 4: where the step's time goes ---------------------------------
    t0 = time.perf_counter()
    phases = phase_ms(sim, state, 3)
    phase_k = phase_kernels(sim, state)
    prof = profile_steps(sim, state, 3, wall / n_steps * 1e3)
    emit(dict(phase=4, case="3-D res 2 float32, 3 profiled steps",
              phase_ms_per_step=phases, phase_kernels_per_step=phase_k,
              **prof, seconds=time.perf_counter() - t0))

    replaces = {
        "K1 emi_stiffness": "knpemi_tpu/ops/pallas_assembly.py:364",
        "K2 facet_mass": "knpemi_tpu/ops/pallas_assembly.py:653",
        "K3 knp_apply_batch": "knpemi_tpu/ops/pallas_assembly.py:444",
        "K4 ell_matvec": "knpemi_tpu/ops/pallas_ell.py:330",
        "K9 facet_gather": "knpemi_tpu/ops/pallas_assembly.py:742",
        "K10 facet_scatter": "knpemi_tpu/ops/pallas_assembly.py:758",
    }
    source = {"K2": "facets", "K9": "facets", "K10": "facets"}
    emit({"kernels": [
        dict(name=r["name"], route="cuda",
             source=f"knpemi_tpu_torch/ops/csrc/{source.get(r['name'].split()[0], 'cells')}.cu",
             replaces=replaces[r["name"]], launches=launches[r["name"]],
             max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
             bound_ms=r["bound_ms"], bound_by=r["bound_by"],
             library_ms=r["library_ms"])
        for r in rows32
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
