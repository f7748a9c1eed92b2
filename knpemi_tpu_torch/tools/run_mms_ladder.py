"""The reference-scale MMS verification ladder.

    python -m knpemi_tpu_torch.tools.run_mms_ladder --Ms 100 200 400 800 1600 \\
        [--iterative] [--device cuda|cpu] [--out DIR] [--min-rate 1.9]
    python -m knpemi_tpu_torch.tools.run_mms_ladder --join A/ladder.json B/ladder.json \\
        [--out DIR] [--min-rate 1.9]

The reference verifies its discretization on the unit square at M = 100
... 1600 (its ``tests/make_mesh_mms.py:96-100``); this runs the port's
manufactured-solution study (``systems/mms.py``: the reference's 2-D
trig case) at those sizes and prints the L2 error of every field at
every M, then the convergence rates against the previous M.  The study
is float64 throughout: it is verification, and the H100 has native
float64.  The solves run on the card unless ``--device cpu``; without a
card and without ``--device cpu`` the tool raises.

The host LU path by default (scipy in place of the reference's MUMPS);
``--iterative`` runs the Krylov path at rtol 1e-10 with the SA-AMG
V-cycle as preconditioner on both systems (:func:`ladder_hierarchies`,
the recipe of the JAX package's ``tools/run_mms_ladder.py``): CG on the
EMI system, GMRES batched over the solved ions on each KNP block.  A
solve that does not converge is an error: the rung raises and no error
norm is printed for it.

One JSON line a rung (errors, iterations, dofs and cells, the host
seconds of each part, peak device memory), then the rates; the exit
code is 1 when the last rate of any field is at or below ``--min-rate``.
``--out DIR`` writes ``DIR/ladder.json`` (every rung and the rates) and
``DIR/summary.json`` (errors, rates, iterations, seconds and memory per
rung).  Rungs run in separate calls are joined with ``--join``: the
rungs of the given ``ladder.json`` files or logs (the rung lines of a
run, also of one cut short), ordered by M, their rates computed anew.
"""

from __future__ import annotations

import argparse
import json
import resource
import sys
import time
from pathlib import Path

import numpy as np
import scipy.sparse as sp
import torch

from ..mesh import unit_square_mms_mesh
from ..ops.geometry import build_geometry
from ..ops.p1op import membrane_operators, p1_operators
from ..solvers import mg as mg_mod
from ..solvers.api import create_solver_emi, create_solver_knp
from ..solvers.direct import _coo_accumulate, _mass_coo, _stiffness_coo, assemble_emi_csr
from ..systems import mms
from ..systems.coupling import set_initial_conditions
from ..systems.emi import emi_system
from ..systems.knp import knp_system
from ..systems.types import resolve_device

FIELDS = ("phi_e", "phi_i", "a_e", "b_e", "a_i", "b_i")
KRYLOV = dict(rtol=1e-10, maxiter=20000)
# the SA-AMG build of the JAX tool: ELL levels, damped Jacobi
HIERARCHY = dict(theta=0.04, banded=False, smoother="jacobi")


def _equilibrated_build(A: sp.csr_matrix, device, dtype):
    """The hierarchy of S A S, S = diag(1/sqrt|diag A|) (a zero diagonal
    counts as 1), near-null vector 1/s, uploaded; its ``fine_diag`` the
    raw diagonal, the scale the solver front-ends equilibrate with."""
    d = A.diagonal()
    d = np.where(d != 0, d, 1.0)
    s = 1.0 / np.sqrt(np.abs(d))
    hier = mg_mod.build_hierarchy_cached((sp.diags(s) @ A @ sp.diags(s)).tocsr(),
                                         B=1.0 / s, **HIERARCHY)
    dev = hier.device(dtype, device)
    dev.fine_diag = torch.as_tensor(d, dtype=dtype, device=device)
    return hier, dev


def ladder_hierarchies(geom, ions, params, esys, ksys, c0, device, dtype):
    """The SA-AMG hierarchies of the iterative rung: (EMI DeviceMG, {tag:
    KNP DeviceMG}, host hierarchies {"emi" | tag: MGHierarchy}).

    EMI: on the masked operator the MMS system solves with, the symmetric
    Dirichlet elimination D A D + (I - D) of the t = 0 matrix at the
    initial concentrations ``c0`` (a hierarchy of the unmasked matrix
    preconditions CG worse).  KNP: per subdomain on (1/dt) M + D_bar K,
    D_bar the mean D over the solved ions, the drift left out."""
    kappa = {t: v.detach().cpu().numpy() for t, v in esys.kappa(c0).items()}
    bc_mask = esys.bc_mask.detach().cpu().numpy() if esys.has_bc else None
    A = assemble_emi_csr(geom, params, kappa, bc_mask)
    host = {}
    host["emi"], emi_mg = _equilibrated_build(A, device, dtype)
    knp = {}
    for t, sub in geom.subdomains.items():
        D_bar = float(np.mean([ion.D[t] for ion in ions[:ksys.n_solved]]))
        parts = [_mass_coo(sub.cells, sub.vols, 1.0 / params.dt),
                 _stiffness_coo(sub.cells, sub.grads, sub.vols, coef_cell=D_bar)]
        rows, cols, vals = zip(*parts)
        host[t], knp[t] = _equilibrated_build(
            _coo_accumulate(rows, cols, vals, sub.n_dofs), device, dtype)
    return emi_mg, knp, host


def _cache_entries() -> dict:
    return {p.name: p.stat().st_size for p in Path(mg_mod.CACHE_DIR).glob("*.pkl")}


def ladder_rung(M: int, iterative: bool = True, device="cuda", dtype=torch.float64,
                return_fields: bool = False) -> dict:
    """One rung at the unit square's M: mesh, geometry, the reference's
    case and its data, the systems, then the solves (iterative: CG and
    batched GMRES at rtol 1e-10 on :func:`ladder_hierarchies`; else the
    host LU).  Returns the rung's record: the six L2 errors, iterations
    and convergence, dofs and cells, host seconds by part, peak device
    memory (CUDA), the hierarchies' level sizes and new cache bytes;
    with ``return_fields`` also ``fields`` (phi and c by tag, on the
    device).  Raises when a solve does not converge."""
    if dtype != torch.float64:
        raise ValueError("the MMS ladder runs in float64 only")
    device = resolve_device(device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    seconds = {}
    clock = [time.perf_counter()]

    def lap(part):
        sync()
        now = time.perf_counter()
        seconds[part] = now - clock[0]
        clock[0] = now

    geom = build_geometry(unit_square_mms_mesh(M))
    case = mms.reference_mms_case(geom)
    ions, emi_data, knp_data = mms.build_mms_data(geom, case)
    lap("data")
    ops, mops = p1_operators(geom, device), membrane_operators(geom, device)
    lap("p1_operators")
    p = case.params
    esys = emi_system(geom, ions, p, mms=emi_data, dtype=dtype, device=device,
                      p1ops=ops, memops=mops)
    ksys = knp_system(geom, ions, p, mms=knp_data, dtype=dtype, device=device,
                      p1ops=ops, memops=mops)
    c0 = set_initial_conditions(geom, ions, dtype=dtype, device=device)
    phiM0 = {m: torch.zeros(s.n_dofs, dtype=dtype, device=device)
             for m, s in geom.membranes.items()}
    lap("systems")
    rec = dict(M=M, dofs=geom.emi_size,
               cells=sum(s.n_cells for s in geom.subdomains.values()),
               solver="SA-AMG CG / batched GMRES" if iterative else "host LU",
               device=torch.cuda.get_device_name(device) if cuda else "cpu",
               dtype=str(dtype).replace("torch.", ""))
    if iterative:
        before = _cache_entries()
        emi_mg, knp_mg, host = ladder_hierarchies(geom, ions, p, esys, ksys, c0, device, dtype)
        lap("hierarchies")
        rec["levels"] = {str(k): [lv.n for lv in h.levels] + [h.coarse_V.shape[0]]
                         for k, h in host.items()}
        after = _cache_entries()
        rec["mg_cache_new_bytes"] = sum(v for k, v in after.items() if k not in before)
        es = create_solver_emi(esys, mg=emi_mg, **KRYLOV)
        ks = create_solver_knp(ksys, mg=knp_mg, **KRYLOV)
        # the deflated-Jacobi fallback and the bare GMRES must not be reached
        if es.mg is None or set(ks.mg) != set(ksys.tags):
            raise RuntimeError("MMS ladder: a solver has no hierarchy")
    else:
        es = create_solver_emi(esys, direct=True)
        ks = create_solver_knp(ksys, direct=True)
    phi, ie = es.solve(c0, phiM0)
    lap("solve_emi")
    c, ik = ks.solve(c0, phi, phiM0)
    lap("solve_knp")
    rec.update(iters=dict(emi=int(ie.iters), knp=int(ik.iters)),
               converged=dict(emi=bool(ie.converged), knp=bool(ik.converged)))
    if not (ie.converged and ik.converged):
        raise RuntimeError(f"MMS ladder M={M}: a solve did not converge: "
                           f"iterations {rec['iters']}, converged {rec['converged']}")
    l2 = lambda tag, u, fn: mms.l2_error(geom, tag, u, fn)
    rec["errors"] = dict(
        phi_e=l2(0, phi[0], case.phi[0]), phi_i=l2(1, phi[1], case.phi[1]),
        a_e=l2(0, c[0][0], case.conc[("a", 0)]), b_e=l2(0, c[0][1], case.conc[("b", 0)]),
        a_i=l2(1, c[1][0], case.conc[("a", 1)]), b_i=l2(1, c[1][1], case.conc[("b", 1)]))
    lap("errors")
    seconds["total"] = sum(seconds.values())
    rec["seconds"] = seconds
    rec["peak_device_bytes"] = torch.cuda.max_memory_allocated(device) if cuda else None
    # the process's peak resident host memory so far (Linux reports KiB)
    rec["peak_host_rss_bytes"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    if return_fields:
        rec["fields"] = dict(phi=phi, c=c)
    return rec


def rates(rungs) -> dict:
    """{field: [rate from each M to the next]} of rungs ordered by M."""
    return {f: [float(np.log2(a["errors"][f] / b["errors"][f]) / np.log2(b["M"] / a["M"]))
                for a, b in zip(rungs, rungs[1:])]
            for f in FIELDS}


def read_rungs(path) -> list:
    """The rungs of a ``ladder.json``, or of a log of this tool (its JSON
    lines: the rungs a run finished, also of a run cut short)."""
    text = Path(path).read_text()
    try:
        doc = json.loads(text)
    except ValueError:  # a log of several lines
        doc = None
    if isinstance(doc, dict) and "rungs" in doc:
        return doc["rungs"]
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith('{"M"')]


def summary(rungs, rate_table) -> dict:
    keep = ("M", "dofs", "cells", "solver", "iters", "errors", "seconds",
            "peak_device_bytes", "peak_host_rss_bytes", "mg_cache_new_bytes")
    return dict(rungs=[{k: r[k] for k in keep if k in r} for r in rungs], rates=rate_table)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--Ms", type=int, nargs="+", default=[100, 200, 400])
    ap.add_argument("--iterative", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--min-rate", type=float, default=1.9)
    ap.add_argument("--out", default=None, help="directory for ladder.json and summary.json")
    ap.add_argument("--join", nargs="+", default=None, metavar="FILE",
                    help="join the rungs of these ladder.json files or logs of this "
                         "tool instead of running any")
    args = ap.parse_args(argv)
    if args.join:
        rungs = sorted((r for path in args.join for r in read_rungs(path)),
                       key=lambda r: r["M"])
    else:
        rungs = []
        for M in args.Ms:
            rec = ladder_rung(M, args.iterative, args.device)
            print(json.dumps(rec), flush=True)
            rungs.append(rec)
    table = rates(rungs)
    print("\nconvergence rates (against the previous M):")
    ok = True
    for f, r in table.items():
        tail = r[-1] if r else float("nan")
        ok = ok and tail > args.min_rate
        flag = "" if tail > args.min_rate else "  <-- BELOW TARGET"
        print(f"  {f:6s}: " + "  ".join(f"{x:.2f}" for x in r) + flag)
    print("\nPASS" if ok else "\nFAIL", f"(target rate {args.min_rate})", flush=True)
    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / "ladder.json").write_text(json.dumps(
            dict(rungs=rungs, rates=table, min_rate=args.min_rate, ok=ok), indent=1) + "\n")
        (out / "summary.json").write_text(json.dumps(summary(rungs, table), indent=1) + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
