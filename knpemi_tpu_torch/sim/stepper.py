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
  [3] KNP solve (ion-batched GMRES + batched V-cycle, K3, K4, K9, K10;
      banded: K6a, K6b, K8)
  [4] algebraic update (eliminated ion, phi_M from the PDE traces)

The JAX package jits and scans the step; here it runs eagerly, and each
Krylov iteration reads its stopping test back to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import scipy.sparse as sp
import torch
from scipy.sparse.csgraph import reverse_cuthill_mckee

from ..models.engine import MembraneModel, update_ode_variables
from ..ops.geometry import DiscreteGeometry
from ..solvers import direct
from ..solvers.api import EMISolver, KNPSolver
from ..solvers.mg import build_hierarchy_cached
from ..solvers.precision import bdot2, dot2
from ..systems.coupling import (
    membrane_maps, set_initial_conditions, update_pde_variables,
)
from ..systems.emi import EMISystem
from ..systems.knp import KNPSystem
from ..systems.types import Ion, PhysicalParams, SimState, resolve_device

# strength threshold of the SA-AMG aggregation (the JAX stepper's value)
MG_THETA = 0.04


@dataclasses.dataclass
class SolverOptions:
    rtol_emi: float = 1e-5
    rtol_knp: float = 1e-7
    # minimum KNP GMRES iterations before the convergence test may stop
    # the solve (PETSc ksp_min_it parity)
    min_iter_knp: int = 5
    mg_coarse_max: int = 800
    # block-banded / windowed-ELL layouts of every V-cycle operator
    # (solvers/mg.py::build_hierarchy(banded=True)); False: plain ELL
    mg_banded: bool = False
    # store the fine-level smoothing slab in bfloat16 (storage only: the
    # kernel upcasts after the read; needs mg_banded)
    mg_band_bf16: bool = False


def _global_rcm(A_hat, s):
    perm = np.asarray(reverse_cuthill_mckee(A_hat, symmetric_mode=True), dtype=np.int64)
    return A_hat[perm][:, perm].tocsr(), s[perm], perm


class Simulation:
    """Owns the systems, solvers and membrane models of one scenario."""

    def __init__(self, geom: DiscreteGeometry, ions: List[Ion],
                 params: PhysicalParams, mem_models: List[MembraneModel],
                 solver_options: Optional[SolverOptions] = None,
                 splitting_scheme: bool = True, dtype=torch.float64,
                 device=None):
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
        self.emi_sys = EMISystem(geom, ions, params, splitting_scheme,
                                 dtype=dtype, device=self.device)
        self.knp_sys = KNPSystem(geom, ions, params, splitting_scheme,
                                 dtype=dtype, device=self.device)
        # compensated Krylov inner products in float32
        comp = dtype == torch.float32
        self.emi_solver = EMISolver(
            self.emi_sys, rtol=opts.rtol_emi, dot=dot2 if comp else torch.dot,
        )
        self.knp_solver = KNPSolver(
            self.knp_sys, rtol=opts.rtol_knp, min_iter=opts.min_iter_knp,
            bdot=bdot2 if comp else None,
        )
        self._maps = membrane_maps(geom, self.device)
        self._setup_emi_mg()
        self._setup_knp_mg()

    # ------------------------------------------------------------------
    def _hierarchy(self, A_hat, s):
        """Global RCM of the equilibrated operator, then the (cached) SA
        build, uploaded to the device; returns the DeviceMG."""
        A_hat, s, perm = _global_rcm(A_hat, s)
        kw = {}
        if self.opts.mg_banded:
            # slabs are built in the run dtype: float64 ones would take
            # twice the host memory only to be cast at upload
            kw = dict(banded=True, slab_dtype=(
                np.float32 if self.dtype == torch.float32 else np.float64))
        hier = build_hierarchy_cached(
            A_hat, B=1.0 / s, theta=MG_THETA, coarse_max=self.opts.mg_coarse_max,
            **kw,
        )
        hier.perm = perm
        band_dtype = torch.bfloat16 if self.opts.mg_band_bf16 else None
        return hier, hier.device(self.dtype, self.device, band_dtype=band_dtype)

    def _setup_emi_mg(self):
        """Lagged EMI hierarchy from the initial conductivity (host, once)."""
        c0 = set_initial_conditions(self.geom, self.ions, dtype=torch.float64,
                                    device="cpu")
        kappa = {t: v.numpy() for t, v in self.emi_sys.kappa(c0).items()}
        A0 = direct.assemble_emi_csr(self.geom, self.params, kappa)
        d = A0.diagonal()
        diag0 = np.where(d != 0, d, 1.0)
        s = 1.0 / np.sqrt(np.abs(diag0))
        A_hat = (sp.diags(s) @ A0 @ sp.diags(s)).tocsr()
        self._emi_hier, mg = self._hierarchy(A_hat, s)
        mg.fine_diag = torch.as_tensor(diag0, dtype=self.dtype, device=self.device)
        self.emi_solver.mg = mg

    def _setup_knp_mg(self):
        """Lagged SA-AMG per subdomain for the KNP blocks, from the t=0
        operator (mass/dt + mean-D stiffness, no drift); one hierarchy per
        tag serves every solved ion."""
        mg = {}
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
            _, mg[t] = self._hierarchy(A_hat, s)
            mg[t].fine_diag = torch.as_tensor(d, dtype=self.dtype, device=self.device)
        self.knp_solver.mg = mg

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
                state.c, phi, phi_M_new, I_ch, x0=state.c)
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

    def run(self, state: SimState, n_steps: int):
        """Advance n_steps; returns (state, emi_iters[], knp_iters[],
        converged[]) with one entry per step.  Raises on a solve that did
        not converge (the reference's ksp_error_if_not_converged)."""
        it_e, it_k, ok = [], [], []
        for k in range(n_steps):
            state = self.step(state)
            it_e.append(int(state.emi_iters))
            it_k.append(int(state.knp_iters))
            ok.append(bool(state.emi_ok) and bool(state.knp_ok))
            if not ok[-1]:
                raise RuntimeError(
                    f"Krylov solve did NOT converge at step {k + 1}: "
                    f"emi_ok={bool(state.emi_ok)} (res {float(state.emi_res):.3e}), "
                    f"knp_ok={bool(state.knp_ok)} (res {float(state.knp_res):.3e})")
        return state, np.array(it_e), np.array(it_k), np.array(ok)
