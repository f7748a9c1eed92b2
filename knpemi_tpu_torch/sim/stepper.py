"""The coupled KNP-EMI time stepper on one device.

Counterpart of ``knpemi_tpu/sim/stepper.py``: ``SolverOptions`` (:41),
``Simulation.__init__`` with the lagged multigrid setups
(``_setup_emi_mg`` :309, ``_setup_knp_mg`` :447), ``init_state`` (:514)
and ``step`` (:553), in the JAX package's blocked-assembly configuration
(``use_pallas=True``) with ELL multigrid (``mg_banded=False``, the
default here) or its block-banded / windowed-ELL multigrid
(``SolverOptions(mg_banded=True)``).  One step:

  [1] membrane ODEs (RK4 substeps over every membrane dof)
  [2] EMI solve (CG + SA-AMG V-cycle, kernels K1, K2, K4; banded: K5, K7)
  [3] KNP solve (ion-batched GMRES + batched V-cycle, K3, K4, K9, K10,
      K11f; banded: K6a, K6b, K8; with ``knp_batched=False`` one GMRES per
      ion on K11 with the single-vector V-cycle; banded: K4, K5, K7), its
      right-hand side carrying the ECS source term times
      ``source_gate(t)``
  [4] algebraic update (eliminated ion, phi_M from the PDE traces)

``SolverOptions`` takes every option of the JAX package's: the host LU
path (``direct``, no hierarchy), the deflated Jacobi EMI preconditioner
(``emi_precond='jacobi'``, no hierarchy), ``atol_emi`` / ``atol_knp``,
``compensated_dots``, and the multigrid's ``mg_theta``, ``mg_nu``,
``mg_smoother`` / ``mg_degree`` (damped Jacobi or Chebyshev) and
``knp_post_smooth`` (the KNP hierarchies' V(1,0) cycle); the W-cycle is
``DeviceMG.gamma`` on a built hierarchy, as in the JAX package.

The set-up reads the t = 0 EMI operator from the port's cache directory
where an earlier build of the same scenario left it
(``_assemble_emi_cached``, the JAX package's ``_assemble_emi_cached``
:246), and ``setup_seconds`` / ``setup_detail`` time each part of it.

The JAX package jits and scans the step; here it runs eagerly, and each
Krylov iteration reads its stopping test back to the host.  ``run``
advances in chunks of ``save_every`` steps as the JAX ``run`` does
(``knpemi_tpu/sim/stepper.py:653-803``): after each chunk it reads the
iteration counts once, acts on a solve that did not converge
(``SolverOptions.on_divergence``), with ``SolverOptions.mg_refresh_every``
refreshes the lagged EMI hierarchy's values from the current
concentrations (``refresh_mg``; host numpy/scipy, on one worker thread
with ``mg_refresh_async``, the new values copied into the device
tensors in place), calls the observer with a host copy of the state and,
every ``checkpoint_every`` steps, the checkpoint callback with that copy.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import hashlib
import os
import time
import warnings
import zipfile
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import scipy.sparse as sp
import torch
from scipy.sparse.csgraph import reverse_cuthill_mckee

from ..models.engine import MembraneModel, update_ode_variables
from ..ops.geometry import DiscreteGeometry
from ..ops.p1op import membrane_operators, p1_operators
from ..solvers import direct
from ..solvers.api import EMISolver, KNPSolver
from ..solvers.mg import CACHE_DIR, build_hierarchy_cached, refresh_hierarchy
from ..solvers.precision import dot2
from ..systems.coupling import (
    membrane_maps, set_initial_conditions, update_pde_variables,
)
from ..systems.emi import EMISystem
from ..systems.knp import KNPSystem
from ..systems.types import Ion, PhysicalParams, SimState, resolve_device
from ..utils import native
from ..utils.critical import critical_section

# what Simulation.run may do with a solve that did not converge
ON_DIVERGENCE = ("raise", "warn", "ignore")
EMI_PRECOND = ("mg", "jacobi")
MG_SMOOTHER = ("auto", "jacobi", "cheby")


@dataclasses.dataclass
class SolverOptions:
    """Every field of the JAX package's ``SolverOptions`` with its default,
    and the port's ``knp_batched``, except that ``mg_banded`` and
    ``mg_band_bf16`` default to the port's False, which None also means
    (the JAX package reads None by platform and environment; the port
    reads no environment variable)."""

    # the LU path (host scipy) for both solves; no hierarchy is built
    direct: bool = False
    rtol_emi: float = 1e-5
    atol_emi: float = 1e-40
    rtol_knp: float = 1e-7
    atol_knp: float = 2e-40
    # Krylov iterations a solve may take, EMI CG and KNP GMRES alike
    maxiter: int = 1000
    # GMRES restart length of the KNP solve
    restart: int = 30
    # minimum KNP GMRES iterations before the convergence test may stop
    # the solve (PETSc ksp_min_it parity)
    min_iter_knp: int = 5
    # False: the KNP V-cycles skip post-smoothing, the V(1,0) cycle (a
    # flexible-GMRES preconditioner; the EMI CG keeps V(1,1))
    knp_post_smooth: bool = True
    # the EMI preconditioner: 'mg' (SA-AMG) or 'jacobi' (the deflated
    # Jacobi fallback; no hierarchy is built)
    emi_precond: str = "mg"
    # 'raise' (the reference's ksp_error_if_not_converged), 'warn' or
    # 'ignore': what Simulation.run does when a Krylov solve did not converge
    on_divergence: str = "raise"
    # refresh the lagged EMI hierarchy's values from the current
    # concentrations every N steps of Simulation.run, at a chunk boundary
    # (0: never): transfers and shapes frozen, the values copied into the
    # device tensors in place (Simulation.refresh_mg)
    mg_refresh_every: int = 0
    # build the refreshed values on one background host thread (numpy and
    # scipy only) and install them at a later chunk boundary
    mg_refresh_async: bool = True
    # compensated Krylov inner products (dot2 / bdot2); None: on for float32
    compensated_dots: Optional[bool] = None
    # strength threshold of the SA-AMG aggregation
    mg_theta: float = 0.04
    mg_coarse_max: int = 800
    # smoothing sweeps before and after the coarse correction
    mg_nu: int = 1
    # the V-cycle smoother: 'jacobi' (one damped step a sweep) or 'cheby'
    # (Chebyshev-Richardson of mg_degree steps); 'auto' means 'jacobi'
    mg_smoother: str = "auto"
    mg_degree: int = 3
    # block-banded / windowed-ELL layouts of every V-cycle operator
    # (solvers/mg.py::build_hierarchy(banded=True)); False or None: plain ELL
    mg_banded: Optional[bool] = False
    # store the fine-level smoothing slab in bfloat16 (storage only: the
    # kernel upcasts after the read; needs mg_banded); False or None: off
    mg_band_bf16: Optional[bool] = False
    # True: the solved ions of a subdomain share one batched GMRES (K3);
    # False: one GMRES per ion on the single-ion operator (K11) — the two
    # branches the JAX package picks between by use_pallas
    knp_batched: bool = True

    def __post_init__(self):
        for name, allowed in (("on_divergence", ON_DIVERGENCE),
                              ("emi_precond", EMI_PRECOND),
                              ("mg_smoother", MG_SMOOTHER)):
            if getattr(self, name) not in allowed:
                raise ValueError(f"{name} must be one of {allowed}, "
                                 f"got {getattr(self, name)!r}")
        for name in ("mg_nu", "mg_degree", "maxiter", "restart"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be at least 1, got {getattr(self, name)}")
        if self.mg_theta < 0:
            raise ValueError(f"mg_theta must be >= 0, got {self.mg_theta}")

    @property
    def smoother(self) -> str:
        return "jacobi" if self.mg_smoother == "auto" else self.mg_smoother


def always_on(t) -> float:
    """The source gate of a simulation given none: always 1."""
    return 1.0


def _global_rcm(A_hat, s):
    perm = np.asarray(reverse_cuthill_mckee(A_hat, symmetric_mode=True), dtype=np.int64)
    return A_hat[perm][:, perm].tocsr(), s[perm], perm


class Simulation:
    """Owns the systems, solvers and membrane models of one scenario."""

    def __init__(self, geom: DiscreteGeometry, ions: List[Ion],
                 params: PhysicalParams, mem_models: List[MembraneModel],
                 solver_options: Optional[SolverOptions] = None,
                 source_gate: Optional[Callable] = None,
                 splitting_scheme: bool = True, dtype=torch.float64,
                 device=None):
        """``source_gate`` maps the state's 0-d time tensor to the scalar
        (number or 0-d tensor) that multiplies the ions' ECS source terms
        in the step starting at that time; None: always 1."""
        self.device = resolve_device(device)
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"dtype must be float32 or float64, got {dtype}")
        # the coarse solve and the batched coarse products are matmuls
        torch.backends.cuda.matmul.allow_tf32 = False
        self.geom = geom
        self.ions = ions
        self.params = params
        self.dtype = dtype
        self.mem_models = {mm.tag: mm for mm in mem_models}
        opts = solver_options or SolverOptions()
        self.opts = opts
        # hierarchy refreshes installed and skipped (layout drift)
        self.refresh_counts = {"installed": 0, "skipped": 0}
        self._refresh_pool = None
        self._refresh_future = None
        self._last_refresh = 0
        self.refresh_stats = None  # the last installed refill's (DeviceMG.refill_arrays)
        # host seconds of each part of the set-up, in the order it runs
        self.setup_seconds = {}
        # within emi_multigrid / knp_multigrid: the t = 0 EMI assembly's
        # seconds and whether its cache entry was read ("hit") or written
        # ("miss"), and the native Vanek sweeps' seconds
        self.setup_detail = {}
        self.emi_cache_entry = None  # the t = 0 EMI operator's cache file, once read or written
        t0 = time.perf_counter()
        # one P1 operator pattern per subdomain, for both systems
        p1ops = p1_operators(geom, self.device)
        t0 = self._lap("p1_operators", t0)
        # of which the fills' incidence lists
        inc = sum(op.incidence_seconds for op in p1ops.values())
        self.setup_seconds["p1_operators"] -= inc
        self.setup_seconds["p1_incidence"] = inc
        # one per membrane: K2's surface mass pattern, K10's incidence list
        memops = membrane_operators(geom, self.device)
        t0 = self._lap("membrane_operators", t0)
        inc = sum(op.incidence_seconds for op in memops.values())
        self.setup_seconds["membrane_operators"] -= inc
        self.setup_seconds["membrane_incidence"] = inc
        self.emi_sys = EMISystem(geom, ions, params, splitting_scheme,
                                 dtype=dtype, device=self.device, p1ops=p1ops,
                                 memops=memops)
        t0 = self._lap("emi_system", t0)
        self.knp_sys = KNPSystem(geom, ions, params, splitting_scheme,
                                 dtype=dtype, device=self.device, p1ops=p1ops,
                                 memops=memops, per_ion=not opts.knp_batched,
                                 kst={t: s["kst"] for t, s in self.emi_sys.sub.items()})
        t0 = self._lap("knp_system", t0)
        # compensated Krylov inner products: by default in float32
        comp = opts.compensated_dots
        if comp is None:
            comp = dtype == torch.float32
        dot = dot2 if comp else torch.dot
        self.emi_solver = EMISolver(
            self.emi_sys, direct=opts.direct, rtol=opts.rtol_emi, atol=opts.atol_emi,
            maxiter=opts.maxiter, dot=dot,
        )
        # the batched dot follows the dot (bdot2 with dot2)
        self.knp_solver = KNPSolver(
            self.knp_sys, direct=opts.direct, rtol=opts.rtol_knp, atol=opts.atol_knp,
            maxiter=opts.maxiter, restart=opts.restart, min_iter=opts.min_iter_knp,
            dot=dot, batched=opts.knp_batched,
        )
        self.source_gate = source_gate or always_on
        self.splitting_scheme = splitting_scheme
        self._maps = membrane_maps(geom, self.device)
        t0 = self._lap("solvers_and_maps", t0)
        # no hierarchy on the LU path, nor with the deflated Jacobi EMI
        # preconditioner (the KNP GMRES then runs unpreconditioned too,
        # as in the JAX package)
        self._emi_hier, self._knp_hier = None, None
        if not opts.direct and opts.emi_precond == "mg":
            sweep0 = native.sweep_seconds
            self._setup_emi_mg()
            t0 = self._lap("emi_multigrid", t0)
            sweep1 = native.sweep_seconds
            self._setup_knp_mg()
            self._lap("knp_multigrid", t0)
            self.setup_detail.update(emi_vanek_sweep=sweep1 - sweep0,
                                     knp_vanek_sweep=native.sweep_seconds - sweep1)

    def _lap(self, part: str, t0: float) -> float:
        t1 = time.perf_counter()
        self.setup_seconds[part] = t1 - t0
        return t1

    # ------------------------------------------------------------------
    def _hierarchy(self, A_hat, s):
        """Global RCM of the equilibrated operator, then the (cached) SA
        build, uploaded to the device; returns the host hierarchy and the
        DeviceMG."""
        A_hat, s, perm = _global_rcm(A_hat, s)
        opts = self.opts
        kw = {}
        if opts.mg_banded:
            # slabs are built in the run dtype: float64 ones would take
            # twice the host memory only to be cast at upload
            kw = dict(banded=True, slab_dtype=(
                np.float32 if self.dtype == torch.float32 else np.float64))
        hier = build_hierarchy_cached(
            A_hat, B=1.0 / s, theta=opts.mg_theta, coarse_max=opts.mg_coarse_max,
            nu=opts.mg_nu, smoother=opts.smoother, degree=opts.mg_degree, **kw,
        )
        hier.perm = perm
        band_dtype = torch.bfloat16 if opts.mg_band_bf16 else None
        return hier, hier.device(self.dtype, self.device, band_dtype=band_dtype)

    def _emi_cache_path(self, kappa: dict) -> Path:
        """The cache entry of the t = 0 EMI operator for ``kappa``: keyed, as
        the JAX package's, by ``emi_csr_v1``, C_phi, each subdomain's
        cells, gradients, volumes and kappa, and each membrane's facet
        dofs, areas and cell tag."""
        h = hashlib.sha256()
        h.update(b"emi_csr_v1")
        h.update(np.float64(self.params.C_phi).tobytes())
        for t in self.emi_sys.tags:
            sub = self.geom.subdomains[t]
            for arr in (sub.cells, sub.grads, sub.vols, kappa[t]):
                a = np.ascontiguousarray(np.asarray(arr))
                h.update(str(a.shape).encode())
                h.update(a.tobytes())
        for m, mem in sorted(self.geom.membranes.items()):
            for arr in (mem.facet_idofs, mem.facet_edofs, mem.areas, np.int64(mem.cell_tag)):
                h.update(np.ascontiguousarray(np.asarray(arr)).tobytes())
        return Path(CACHE_DIR) / ("emi_" + h.hexdigest()[:32] + ".npz")

    def _assemble_emi_cached(self, kappa: dict) -> sp.csr_matrix:
        """The t = 0 EMI operator (``direct.assemble_emi_csr``), kept on disk
        in the port's cache directory (``solvers/mg.py::CACHE_DIR``): the
        operator is a function of the geometry, C_phi and kappa alone, so
        a later build of the same scenario is spared its COO accumulation.
        A hit reads the CSR arrays back as they were written; a corrupt
        entry is assembled afresh and replaced; a new entry is written
        atomically inside ``critical_section``.  The refresh path
        (:meth:`_emi_operator`) assembles afresh."""
        path = self.emi_cache_entry = self._emi_cache_path(kappa)
        if path.exists():
            try:
                with np.load(path) as z:
                    A0 = sp.csr_matrix((z["data"], z["indices"], z["indptr"]),
                                       shape=tuple(z["shape"]))
                self.setup_detail["emi_assembly_cache"] = "hit"
                return A0
            except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
                pass  # corrupt entry: assemble afresh below
        A0 = direct.assemble_emi_csr(self.geom, self.params, kappa)
        self.setup_detail["emi_assembly_cache"] = "miss"
        # np.savez appends ".npz" unless the name ends with it
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp.npz")
        try:
            with critical_section():
                path.parent.mkdir(parents=True, exist_ok=True)
                np.savez(tmp, data=A0.data, indices=A0.indices, indptr=A0.indptr,
                         shape=np.asarray(A0.shape))
                os.replace(tmp, path)
        except BaseException as exc:
            tmp.unlink(missing_ok=True)
            # caching is best-effort, but an interruption goes on to the caller
            if not isinstance(exc, OSError):
                raise
        return A0

    def _emi_setup_operator(self):
        """The t = 0 EMI operator from the initial conductivity
        (:meth:`_assemble_emi_cached`), symmetrically equilibrated: (A_hat,
        s, diag) with A_hat = S A S, S = diag(s), s = 1/sqrt|diag|."""
        c0 = set_initial_conditions(self.geom, self.ions, dtype=torch.float64,
                                    device="cpu")
        kappa = {t: v.numpy() for t, v in self.emi_sys.kappa(c0).items()}
        t0 = time.perf_counter()
        A0 = self._assemble_emi_cached(kappa)
        self.setup_detail["emi_assembly"] = time.perf_counter() - t0
        d = A0.diagonal()
        diag0 = np.where(d != 0, d, 1.0)
        s = 1.0 / np.sqrt(np.abs(diag0))
        return (sp.diags(s) @ A0 @ sp.diags(s)).tocsr(), s, diag0

    def _setup_emi_mg(self):
        """Lagged EMI hierarchy from the initial conductivity (host, once)."""
        A_hat, s, self._emi_diag0 = self._emi_setup_operator()
        self._emi_hier, mg = self._hierarchy(A_hat, s)
        mg.fine_diag = torch.as_tensor(self._emi_diag0, dtype=self.dtype, device=self.device)
        self.emi_solver.mg = mg

    def _setup_knp_mg(self):
        """Lagged SA-AMG per subdomain for the KNP blocks, from the t=0
        operator (mass/dt + mean-D stiffness, no drift); one hierarchy per
        tag serves every solved ion."""
        mg, self._knp_hier = {}, {}
        for t in self.knp_sys.tags:
            sub = self.geom.subdomains[t]
            Dbar = float(np.mean([ion.D[t] for ion in self.ions[:-1]]))
            r1, c1, v1 = direct._mass_coo(sub.cells, sub.vols, 1.0 / self.params.dt)
            r2, c2, v2 = direct._stiffness_coo(sub.cells, sub.grads, sub.vols,
                                               coef_cell=Dbar)
            A0 = direct._coo_accumulate([r1, r2], [c1, c2], [v1, v2], sub.n_dofs)
            d = A0.diagonal()
            d = np.where(d != 0, d, 1.0)
            s = 1.0 / np.sqrt(np.abs(d))
            A_hat = (sp.diags(s) @ A0 @ sp.diags(s)).tocsr()
            self._knp_hier[t], mg[t] = self._hierarchy(A_hat, s)
            mg[t].fine_diag = torch.as_tensor(d, dtype=self.dtype, device=self.device)
            # V(1,0) where asked: legal for the flexible GMRES only
            mg[t].post_smooth = self.opts.knp_post_smooth
        self.knp_solver.mg = mg

    # -- the lagged EMI hierarchy's refresh ----------------------------
    def _emi_operator(self, c_host):
        """The EMI operator for the concentrations ``c_host`` ({tag: numpy
        (N_ions, n)}) in the hierarchy's space: assembled on the host,
        equilibrated with the FROZEN setup scale and permuted by the
        hierarchy's RCM — the frozen transfers reproduce the setup's
        near-null vector 1/s only in that scaled space (the JAX package's
        ``_refresh_payload``)."""
        F, psi = self.params.F, self.params.psi
        kappa = {}
        for t in self.emi_sys.tags:
            acc = 0.0
            for k, ion in enumerate(self.ions):
                acc = acc + (ion.z ** 2) * ion.D[t] * np.asarray(c_host[t][k])
            kappa[t] = F * psi * acc
        A0 = direct.assemble_emi_csr(self.geom, self.params, kappa)
        s = 1.0 / np.sqrt(np.abs(self._emi_diag0))
        A_hat = (sp.diags(s) @ A0 @ sp.diags(s)).tocsr()
        perm = self._emi_hier.perm
        return A_hat if perm is None else A_hat[perm][:, perm].tocsr()

    def _refresh_payload(self, c_host):
        """The refreshed EMI hierarchy for the concentrations ``c_host``, on
        the host in numpy/scipy only (safe on a worker thread):
        ``refresh_hierarchy`` of :meth:`_emi_operator`, and the arrays the
        device refill copies.  Returns ((hier, pairs, stats), None) or
        (None, reason)."""
        A_hat = self._emi_operator(c_host)
        mg = self.emi_solver.mg
        try:
            hier = refresh_hierarchy(self._emi_hier, A_hat)
            pairs, stats = mg.refill_arrays(hier)
        except ValueError as e:
            return None, str(e)
        return (hier, pairs + [(mg.fine_diag, self._emi_diag0)], stats), None

    def _install_refreshed(self, hier, pairs, stats):
        """Copy a refreshed hierarchy's values into the device tensors (main
        thread, stream-ordered ``copy_``); no tensor is reallocated."""
        self._emi_hier = hier
        self.emi_solver.mg.install(pairs)
        self.refresh_counts["installed"] += 1
        self.refresh_stats = stats

    def _skip_refresh(self, err: str):
        self.refresh_counts["skipped"] += 1
        warnings.warn(f"MG refresh skipped (layout drift: {err}); keeping the "
                      "stale hierarchy", RuntimeWarning, stacklevel=3)

    def refresh_mg(self, state: SimState):
        """Refresh the EMI hierarchy's values from ``state``'s concentrations
        now, on this thread (:meth:`_refresh_payload`), transfers and
        every shape frozen; a layout that drifted keeps the stale
        hierarchy with a warning.  The KNP hierarchies' setup operator
        (mass + mean-D stiffness) does not change in time."""
        if self._emi_hier is None:
            raise ValueError("no EMI hierarchy to refresh (direct=True or "
                             "emi_precond='jacobi')")
        res, err = self._refresh_payload(
            {t: v.detach().cpu().numpy() for t, v in state.c.items()})
        if res is None:
            self._skip_refresh(err)
        else:
            self._install_refreshed(*res)

    def _maybe_refresh(self, state: SimState, host: Optional[SimState], done: int,
                       n_steps: int):
        every = self.opts.mg_refresh_every
        if not every or self._emi_hier is None:
            return
        self._harvest_refresh(block=False)
        # on the steps since the last refresh, not on divisibility: the
        # chunk (save_every) need not divide mg_refresh_every
        if done >= n_steps or done - self._last_refresh < every:
            return
        if not self.opts.mg_refresh_async:
            self._last_refresh = done
            self.refresh_mg(state)
            return
        if self._refresh_future is not None:
            return  # the previous rebuild still runs; retry after the next chunk
        if self._refresh_pool is None:
            self._refresh_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="mg-refresh")
        self._last_refresh = done
        c_host = {t: (host.c[t] if host is not None else v.detach().cpu()).numpy()
                  for t, v in state.c.items()}
        self._refresh_future = self._refresh_pool.submit(self._refresh_payload, c_host)

    def _harvest_refresh(self, block: bool):
        fut = self._refresh_future
        if fut is None or (not block and not fut.done()):
            return
        self._refresh_future = None
        res, err = fut.result()
        if res is None:
            self._skip_refresh(err)
        else:
            self._install_refreshed(*res)

    def _close_refresh(self):
        """Install a rebuild still in flight and stop the worker thread."""
        self._harvest_refresh(block=True)
        if self._refresh_pool is not None:
            self._refresh_pool.shutdown(wait=True)
            self._refresh_pool = None

    # ------------------------------------------------------------------
    def init_state(self) -> SimState:
        dev, dt = self.device, self.dtype
        c = set_initial_conditions(self.geom, self.ions, dtype=dt, device=dev)
        phi = {t: torch.zeros(s.n_dofs, dtype=dt, device=dev)
               for t, s in self.geom.subdomains.items()}
        phi_M, ode_states, ode_params = {}, {}, {}
        for m, mm in self.mem_models.items():
            ode_states[m] = torch.as_tensor(mm.states0, dtype=dt, device=dev)
            ode_params[m] = torch.as_tensor(mm.params0, dtype=dt, device=dev)
            # the first EMI solve uses the ODE model's resting V
            phi_M[m] = ode_states[m][:, mm.state_index("V")].clone()
        scalar = lambda v, d: torch.tensor(v, dtype=d, device=dev)
        return SimState(
            c=c, phi=phi, phi_M=phi_M, ode_states=ode_states,
            ode_params=ode_params, t=scalar(0.0, torch.float64),
            step=scalar(0, torch.int32), emi_iters=scalar(0, torch.int32),
            knp_iters=scalar(0, torch.int32), emi_ok=scalar(True, torch.bool),
            knp_ok=scalar(True, torch.bool), emi_res=scalar(0.0, dt),
            knp_res=scalar(0.0, dt),
        )

    def _membrane_odes(self, state: SimState):
        """[1] RK4 over every membrane dof; returns the new ODE states and
        parameters, phi_M from the ODEs and the channel currents."""
        dt = self.params.dt
        first = state.step == 0
        phi_M = dict(state.phi_M)
        ode_states = dict(state.ode_states)
        ode_params = dict(state.ode_params)
        I_ch: Dict[int, torch.Tensor] = {}
        for m, mm in self.mem_models.items():
            m2e, m2i = self._maps[m]
            prms, sts = update_ode_variables(
                mm, state.ode_params[m], state.ode_states[m], state.c,
                state.phi_M[m], self.ions, first, m2e, m2i,
            )
            sts = mm.step(sts, prms, state.t, dt)
            ode_states[m] = sts
            ode_params[m] = prms
            phi_M[m] = mm.get_membrane_potential(sts).contiguous()
            cur = mm.currents(sts, prms, state.t + dt)
            I_ch[m] = torch.stack([cur[ion.name] for ion in self.ions])
        return ode_states, ode_params, phi_M, I_ch

    def step(self, state: SimState,
             span: Callable = torch.profiler.record_function) -> SimState:
        """One full splitting step.  Each phase runs inside ``span(name)``
        (``step/ode``, ``step/emi``, ``step/knp``, ``step/update``): by
        default a profiler span; a caller may pass a context manager of its
        own to time the phases."""
        dt = self.params.dt
        with span("step/ode"):
            ode_states, ode_params, phi_M_new, I_ch = self._membrane_odes(state)
        # [2] EMI solve (kappa from the previous concentrations)
        with span("step/emi"):
            phi, emi_info = self.emi_solver.solve(state.c, phi_M_new, I_ch,
                                                  x0=state.phi)
        # [3] KNP solve (drift linearized around the fresh phi)
        with span("step/knp"):
            c_solved, knp_info = self.knp_solver.solve(
                state.c, phi, phi_M_new, I_ch,
                source_gate=self.source_gate(state.t), x0=state.c)
        # [4] algebraic refresh: eliminated ion + phi_M from the traces
        with span("step/update"):
            c_new, phi_M_pde = update_pde_variables(
                self.geom, self.ions, self.params, c_solved, phi, self._maps)

        dev = self.device
        return SimState(
            c=c_new, phi=phi, phi_M=phi_M_pde, ode_states=ode_states,
            ode_params=ode_params, t=state.t + dt, step=state.step + 1,
            emi_iters=torch.tensor(emi_info.iters, dtype=torch.int32, device=dev),
            knp_iters=torch.tensor(knp_info.iters, dtype=torch.int32, device=dev),
            emi_ok=torch.tensor(emi_info.converged, device=dev),
            knp_ok=torch.tensor(knp_info.converged, device=dev),
            emi_res=emi_info.resnorm.to(self.dtype),
            knp_res=knp_info.resnorm.to(self.dtype),
        )

    def run(self, state: SimState, n_steps: int, save_every: Optional[int] = None,
            observer: Optional[Callable[[SimState], None]] = None,
            verbose: bool = False, checkpoint_every: int = 0,
            checkpoint_cb: Optional[Callable[[SimState], None]] = None):
        """Advance n_steps in chunks of ``save_every`` steps (default: one
        chunk), as the JAX package's ``run`` does.  After each chunk, in
        its order: read the chunk's iteration counts and convergence
        flags once (with ``verbose``, print the chunk's ms/step and last
        counts); act on a solve that did not converge as
        ``SolverOptions.on_divergence`` says (``'raise'``: RuntimeError,
        ``'warn'``: a RuntimeWarning, ``'ignore'``); every
        ``SolverOptions.mg_refresh_every`` steps since the last refresh
        and before the last chunk, refresh the EMI hierarchy (on a worker
        thread with ``mg_refresh_async``, installed at a later chunk
        boundary; a rebuild still in flight when the run ends is waited
        for and installed, and the worker stopped); call ``observer``
        with a host (CPU) copy of the state; and, where
        ``checkpoint_every`` steps have passed since the last checkpoint
        and steps remain, call ``checkpoint_cb`` with a host copy (the
        observer's).  Returns (state, emi_iters[], knp_iters[],
        converged[]) with one entry per step."""
        chunk_n = save_every or n_steps
        ckpt_on = checkpoint_cb is not None and checkpoint_every > 0
        it_e, it_k, ok = [], [], []
        done = last_ckpt = 0
        self._last_refresh = 0
        try:
            while done < n_steps:
                n = min(chunk_n, n_steps - done)
                t0 = time.perf_counter()
                diag = []
                for _ in range(n):
                    state = self.step(state)
                    diag.append(torch.stack([
                        state.emi_iters.to(torch.int64), state.knp_iters.to(torch.int64),
                        (state.emi_ok & state.knp_ok).to(torch.int64)]))
                diag = torch.stack(diag).cpu().numpy()  # one host read per chunk
                if verbose:
                    print(f"  steps {done + 1}..{done + n}: "
                          f"{(time.perf_counter() - t0) / n * 1e3:.2f} ms/step, "
                          f"emi_it={int(diag[-1, 0])} knp_it={int(diag[-1, 1])}")
                it_e += diag[:, 0].tolist()
                it_k += diag[:, 1].tolist()
                ok += diag[:, 2].astype(bool).tolist()
                done += n
                check_health(self.opts, state, ok[-n:], done - n)
                ckpt_due = ckpt_on and done < n_steps and done - last_ckpt >= checkpoint_every
                host = _to_host(state) if observer is not None or ckpt_due else None
                self._maybe_refresh(state, host, done, n_steps)
                if observer is not None:
                    observer(host)
                if ckpt_due:
                    checkpoint_cb(host)
                    last_ckpt = done
        finally:
            self._close_refresh()
        return state, np.array(it_e), np.array(it_k), np.array(ok)


def check_health(opts: SolverOptions, state: SimState, ok_steps: List[bool], offset: int):
    """A solve that did not converge in the chunk ``ok_steps`` (steps
    ``offset + 1`` on): raise, warn or ignore, per
    ``SolverOptions.on_divergence`` (the reference aborts:
    ksp_error_if_not_converged)."""
    mode = opts.on_divergence
    if mode == "ignore" or all(ok_steps):
        return
    bad = offset + ok_steps.index(False) + 1
    msg = (f"Krylov solve did NOT converge at step {bad}; the chunk's last step: "
           f"emi_ok={bool(state.emi_ok)} (res {float(state.emi_res):.3e}), "
           f"knp_ok={bool(state.knp_ok)} (res {float(state.knp_res):.3e}). "
           "Increase maxiter, refresh the multigrid hierarchy or relax rtol.")
    if mode == "warn":
        warnings.warn(msg, RuntimeWarning, stacklevel=3)
    else:
        raise RuntimeError(msg)


def _to_host(state: SimState) -> SimState:
    """A copy of ``state`` with every tensor on the CPU."""
    cpu = lambda v: {k: t.detach().to("cpu", copy=True) for k, t in v.items()} \
        if isinstance(v, dict) else v.detach().to("cpu", copy=True)
    return SimState(**{f: cpu(getattr(state, f)) for f in SimState.__dataclass_fields__})
