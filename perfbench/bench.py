"""One run of one cell: set-up, the measured window, the traced readings
(``--trace 1``) and the comparison that decides ``correct``.

Set-up runs from the process's start to the window's first step:
imports, the program's ``Simulation`` built through its scenario entry
point (kernel libraries and multigrid hierarchies from the caches in the
checkout), the seeded initial state and ``warmup_steps`` steps on a copy
of it.  The window is one call of ``Simulation.run`` from t = 0 in
chunks of the traffic's ``save_every`` steps, with an observer that
keeps each chunk's host copy of the state and closes the window at the
first chunk boundary ``seconds`` after it opened.
"""

from __future__ import annotations

import math
import os
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

from . import check, spec, trace
from .reference.step import Reference, pulsed_gate

# modules whose presence in the process voids a run (whole top-level names)
FORBIDDEN = ("jax", "jaxlib", "flax", "knpemi_tpu")
# steps of the traced run's extra readings
PHASE_STEPS, PROFILE_STEPS, PHASE_PROFILE_STEPS = 4, 3, 2


class WindowClosed(Exception):
    pass


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card(device) -> dict:
    """The card's name, count and power limit (nvidia-smi, where it runs)."""
    out = dict(kind=torch.cuda.get_device_name(device), count=1)
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=30)
        out["power_limit"] = q.stdout.strip().splitlines()[0] if q.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        out["power_limit"] = None
    return out


def perturb(sim, state, pert: dict, seed: int) -> None:
    """The seeded inputs: each listed ODE state of membrane ``membrane``
    moved by a uniform draw in [-size, size] at every dof, kept in [0, 1]."""
    m = int(pert["membrane"])
    mm = sim.mem_models[m]
    y = state.ode_states[m]
    g = torch.Generator(device=y.device)
    g.manual_seed(int(seed))
    idx = [mm.state_index(s) for s in pert["states"]]
    u = torch.rand((y.shape[0], len(idx)), generator=g, device=y.device, dtype=torch.float64)
    y[:, idx] = (y[:, idx] + (float(pert["size"]) * (2 * u - 1)).to(y.dtype)).clamp(0.0, 1.0)


def to_device(host, device):
    from knpemi_tpu_torch.systems.types import SimState

    mv = lambda v: {k: t.to(device) for k, t in v.items()} if isinstance(v, dict) else v.to(device)
    return SimState(**{f: mv(getattr(host, f)) for f in SimState.__dataclass_fields__})


def clone(state):
    from knpemi_tpu_torch.systems.types import SimState

    cp = lambda v: {k: t.clone() for k, t in v.items()} if isinstance(v, dict) else v.clone()
    return SimState(**{f: cp(getattr(state, f)) for f in SimState.__dataclass_fields__})


def window(sim, state, seconds: float, save_every: int, iters: Optional[list] = None,
           sync=torch.cuda.synchronize):
    """One ``Simulation.run`` from ``state``, closed at the first chunk
    boundary ``seconds`` after it opened: (host states at every chunk
    boundary, the initial one first; steps; seconds to the last boundary;
    the message of a solve that did not converge, else None; ms a step of
    each chunk)."""
    from knpemi_tpu_torch.sim.stepper import _to_host

    hosts, marks = [_to_host(state)], []
    orig = sim.step
    if iters is not None:
        def step(st, *args, **kw):
            st = orig(st, *args, **kw)
            iters.append(torch.stack([st.emi_iters, st.knp_iters]))
            return st
        sim.step = step
    sync()
    t0 = time.perf_counter()

    def observer(host):
        hosts.append(host)
        marks.append(time.perf_counter() - t0)
        if marks[-1] >= seconds:
            raise WindowClosed

    diverged = None
    try:
        sim.run(state, 10 ** 9, save_every=save_every, observer=observer)
    except WindowClosed:
        pass
    except RuntimeError as e:  # a Krylov solve that did not converge
        diverged = str(e)
    finally:
        if iters is not None:
            del sim.step
    sync()
    # the window ends at the chunk boundary that closed it, whose host copy
    # waits for the chunk's work; a multigrid rebuild still in flight there
    # is awaited by run's close, after the window, for steps it never serves
    wall = marks[-1] if marks else time.perf_counter() - t0
    chunk_ms = np.diff([0.0] + marks) / save_every * 1e3
    return hosts, (len(hosts) - 1) * save_every, wall, diverged, chunk_ms


def sample_chunks(hosts, traffic: dict, dt: float, seed: int):
    """The chunk transitions to compare, drawn from the seed: ``samples``
    of them, one while the ECS source is on where ``source_on`` asks."""
    cmp, se = traffic["compare"], int(traffic["save_every"])
    n = len(hosts) - 1
    rng = np.random.default_rng(seed)
    picks = []
    gate = (traffic.get("stimulus") or {}).get("source")
    if cmp.get("source_on") and gate is not None:
        on = [j for j in range(n)
              if any(pulsed_gate(gate, float(hosts[j].t) + i * dt) for i in range(se))]
        if on:
            picks.append(int(rng.choice(on)))
    rest = [j for j in range(n) if j not in picks]
    k = min(int(cmp["samples"]) - len(picks), len(rest))
    picks += [int(j) for j in rng.choice(rest, size=k, replace=False)] if k > 0 else []
    return sorted(picks)


def compare(ref: Reference, num: check.Numbering, hosts, picks, save_every: int,
            store=None):
    """The numbers of each sampled transition: the reference advanced from
    the program's state at the sampled boundary, against the program's
    state at the next (with ``store``, against the control: the
    reference advanced with that storage)."""
    out = []
    for j in picks:
        start = num.state(hosts[j], ref.device)
        exact = ref.advance(start, save_every)
        got = num.state(hosts[j + 1], ref.device) if store is None \
            else ref.advance(start, save_every, store)
        out.append(check.numbers(got, exact))
    return out


def run(workload: str, seed: int, seconds: float, traced: bool, t_start: float,
        device="cuda", config_override=None, break_step=None, log=print) -> Optional[dict]:
    """One run; returns the result object (None where it may print none:
    on a CUDA ``device``, no card or fewer than the cell asks for)."""
    c = spec.cell(workload, spec.benchmark())
    if config_override is not None:
        config_override(c)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    need = int(c["workload"]["chips"])
    if on_card and (not torch.cuda.is_available() or torch.cuda.device_count() < need):
        print(f"perfbench: the cell needs {need} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}", file=sys.stderr)
        return None
    cfg, traffic = c["config"], c["traffic"]
    sync = torch.cuda.synchronize if on_card else (lambda *a: None)
    dtype = getattr(torch, traffic["dtype"])
    se = int(traffic["save_every"])

    # -- set-up --------------------------------------------------------
    scenario = spec.load_module("scenarios", cfg["scenario"])
    sim = scenario.build(cfg, traffic, dtype, dev)
    if break_step is not None:
        break_step(sim)
    from knpemi_tpu_torch.sim.scenarios import dofs_per_step

    state0 = sim.init_state()
    perturb(sim, state0, traffic["perturb"], seed)
    warm = clone(state0)
    sim.run(warm, int(traffic["warmup_steps"]), save_every=se, observer=lambda h: None)
    del warm
    sync()
    setup_s = time.time() - t_start
    info = card(dev) if on_card else dict(kind="cpu", count=1, power_limit=None)
    log(f"card: {info['kind']}, power limit {info['power_limit']}")
    log(f"dofs per step: {dofs_per_step(sim)}; dtype {traffic['dtype']}; "
        f"set-up {setup_s:.3f} s, of which the build's parts {sum(sim.setup_seconds.values()):.3f} s")

    # -- the window ----------------------------------------------------
    iters = [] if traced else None
    hosts, steps, wall, diverged, chunk_ms = window(sim, state0, seconds, se, iters, sync)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    log(f"host: load average {os.getloadavg()}, {len(os.sched_getaffinity(0))} cores, "
        f"{torch.get_num_threads()} torch threads")
    log(f"window: {steps} steps in {wall:.3f} s; refreshes installed "
        f"{sim.refresh_counts['installed']}, skipped {sim.refresh_counts['skipped']}")
    log("window: ms a step by chunk " + " ".join(f"{v:.1f}" for v in chunk_ms))
    bad_modules = forbidden_modules()
    if bad_modules:
        print(f"perfbench: the process holds {bad_modules}", file=sys.stderr)
        return None
    ok_steps = diverged is None
    if diverged:
        print(f"perfbench: {diverged}", file=sys.stderr)
    metrics = {}
    result = dict(device=dict(platform="gpu" if on_card else "cpu", kind=info["kind"],
                              count=1, memory_peak_bytes=int(peak)))

    if not traced:
        e2e = dict(ms_per_step=(wall / max(steps, 1) * 1e3, "ms"),
                   peak_mem_gib=(peak / 2 ** 30, "GiB"), setup_s=(setup_s, "s"))
        for m in c["end_to_end"]:
            v, unit = e2e[m["name"]]
            metrics[m["name"]] = dict(value=v, unit=unit)
    else:
        records = dict(setup_seconds=dict(sim.setup_seconds), window_steps=steps,
                       window_s=wall, ms_per_step=wall / max(steps, 1) * 1e3,
                       iters=torch.stack(iters).cpu().numpy() if iters else None)
        t_trace = time.perf_counter()
        st = to_device(hosts[-1], dev)
        st, records["phase_s"] = trace.phase_times(sim, st, PHASE_STEPS)
        if on_card:
            trace.warm_profiler(dev)
            st, ev, prof_wall = trace.whole_steps(sim, st, PROFILE_STEPS)
            st, ph_ev, emi_it, knp_it = trace.phase_profiles(sim, st, PHASE_PROFILE_STEPS)
            records.update(profile_steps=PROFILE_STEPS, events=ev, profile_wall_s=prof_wall,
                           phase_profile_steps=PHASE_PROFILE_STEPS, phase_events=ph_ev,
                           emi_iters_profiled=emi_it, knp_iters_profiled=knp_it,
                           roofline={layer: mod.Count(sim) for layer, mod
                                     in spec.roofline_layers().items()})
            busy = trace.union_us(ev) * 1e-6
            result["device"].update(busy_s=busy, window_s=prof_wall)
            by_name = {}
            for name, _, d in ev:
                by_name[name] = by_name.get(name, 0.0) + d * 1e-6
            # the idle time of each phase a step (all its gaps), then the
            # longest single gaps, by the phase the host was in
            gaps, totals = [], []
            for phase, pev in ph_ev.items():
                g = trace.idle_gaps(pev, phase)
                totals.append((f"{phase}: all {len(g) / PHASE_PROFILE_STEPS:.0f} gaps a step",
                               sum(v for _, v in g) / PHASE_PROFILE_STEPS))
                gaps += g
            longest = sorted(gaps, key=lambda kv: -kv[1])[:10 - len(totals)]
            result["breakdown"] = dict(
                device_ops=[[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
                idle_gaps=[[k, v] for k, v in sorted(totals, key=lambda kv: -kv[1]) + longest])
            # how much of an iteration's least bytes the 50 MB L2 could hold
            for layer, count in records["roofline"].items():
                if hasattr(count, "per_iteration"):
                    log(f"roofline {layer}: least bytes an iteration: {count.per_iteration()}")
        log(f"trace: the traced readings took {time.perf_counter() - t_trace:.3f} s")
        del st
        for m in c["per_layer"]:
            v = spec.load_module("metrics", m["name"]).read(records)
            if v is not None and math.isfinite(v):
                metrics[m["name"]] = dict(value=float(v), unit=m["unit"])
    result["metrics"] = metrics

    # -- correct ---------------------------------------------------------
    geom = sim.geom
    del sim, state0
    if on_card:
        torch.cuda.empty_cache()
    picks = sample_chunks(hosts, traffic, float(cfg["physics"]["dt"]), seed)
    t0 = time.perf_counter()
    ref = Reference(cfg, traffic, dev)
    num = check.Numbering(geom, ref.geom)
    limits = c["limits"]
    t1 = time.perf_counter()
    per_pick = compare(ref, num, hosts, picks, se)
    log(f"check: the reference built in {t1 - t0:.3f} s, {len(picks)} chunks of {se} steps "
        f"advanced in {time.perf_counter() - t1:.3f} s")
    over = [j for j, nb in zip(picks, per_pick) if check.fails(nb, limits)]
    got = {}
    for nb in per_pick:
        got = check.worst(got, nb)
    correct = ok_steps and bool(picks) and not over
    result.update(correct=correct, attempted=steps,
                  failed=len(over) * se + (0 if ok_steps else 1))
    print(f"compared chunks: {picks}", file=sys.stderr)
    # each number beside its limit; unconverged: solves of the window that
    # did not converge, held to none
    compared = {k: dict(value=got.get(k), limit=limits[k]) for k in check.NUMBERS}
    compared["unconverged"] = dict(value=0 if ok_steps else 1, limit=0)
    result["compared"] = compared
    for k, v in compared.items():
        print(f"compared {k}: {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    return result
