"""The traced run's readings, taken from the benchmark's side of the
program's calls: phase times from synchronising spans passed to
``Simulation.step(state, span=...)``, device events from
``torch.profiler`` (CUDA activity only: the host's events would slow
the step many times over), and each KNP block's GMRES iterations from a
wrapper around the solver's per-subdomain call."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

Event = Tuple[str, float, float]  # (name, start us, duration us)


def _null_span(name):
    return contextlib.nullcontext()


def device_events(prof) -> List[Event]:
    from torch.autograd import DeviceType

    return sorted(((e.key, e.time_range.start, e.time_range.elapsed_us())
                   for e in prof.events() if e.device_type == DeviceType.CUDA),
                  key=lambda e: e[1])


def union_us(events: List[Event]) -> float:
    """The time in which at least one of ``events`` ran."""
    total, end = 0.0, None
    for _, s, d in events:
        e = s + d
        if end is None or s > end:
            total += d
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def idle_gaps(events: List[Event], label: str) -> List[Tuple[str, float]]:
    """(label and the kernel that ends the gap, seconds) of every gap
    between device events."""
    out, end = [], None
    for name, s, d in events:
        if end is not None and s > end:
            out.append((f"{label} before {name[:48]}", (s - end) * 1e-6))
        end = s + d if end is None else max(end, s + d)
    return out


def _profile():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CUDA])


def warm_profiler(device) -> None:
    """The first profiler sessions of a process may record no device
    event: open sessions until one does (at most three)."""
    x = torch.zeros(1024, device=device)
    for _ in range(3):
        with _profile() as prof:
            x.add_(1.0)
            torch.cuda.synchronize()
        if device_events(prof):
            return


class KNPIterations:
    """Wraps the KNP solver's per-subdomain solve to record each block's
    GMRES iterations ({tag: iters} per solve, in ``solves``)."""

    def __init__(self, solver):
        self.solver, self.solves = solver, []
        name = "_solve_batched" if solver.batched else "_solve_per_ion"
        self.name, self.orig = name, getattr(solver, name)

        def wrapped(t, *args):
            res = self.orig(t, *args)
            if not self.solves or t in self.solves[-1]:
                self.solves.append({})
            self.solves[-1][t] = res.iters
            return res

        setattr(solver, name, wrapped)

    def close(self):
        delattr(self.solver, self.name)


def phase_times(sim, state, n: int):
    """``n`` steps, each phase inside a synchronising span: {phase: [s]}."""
    times = defaultdict(list)
    sync = torch.cuda.synchronize if sim.device.type == "cuda" else (lambda: None)

    @contextlib.contextmanager
    def span(name):
        sync()
        t0 = time.perf_counter()
        yield
        sync()
        times[name].append(time.perf_counter() - t0)

    for _ in range(n):
        state = sim.step(state, span=span)
    return state, dict(times)


def whole_steps(sim, state, n: int):
    """``n`` steps under one CUDA-only profiler session: the device events,
    and the wall time of the steps (the traced window)."""
    with _profile() as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            state = sim.step(state, span=_null_span)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return state, device_events(prof), wall


def phase_profiles(sim, state, n: int):
    """``n`` steps, each phase under a CUDA-only profiler session of its
    own: {phase: [events]}, the EMI iterations and the KNP blocks'."""
    events: Dict[str, List[Event]] = defaultdict(list)
    knp = KNPIterations(sim.knp_solver)
    emi = []

    @contextlib.contextmanager
    def span(name):
        with _profile() as prof:
            yield
            torch.cuda.synchronize()
        events[name] += device_events(prof)

    try:
        for _ in range(n):
            state = sim.step(state, span=span)
            emi.append(int(state.emi_iters))
    finally:
        knp.close()
    return state, dict(events), emi, knp.solves
