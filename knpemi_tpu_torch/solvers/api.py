"""Solver front-ends: configure and run the EMI and KNP solves.

Counterpart of ``knpemi_tpu/solvers/api.py``.  ``direct=True`` gives the
LU path (host scipy, standing in for the reference's MUMPS:
``solvers/direct.py``), its result moved back to the system's device
and dtype.  Otherwise the matrix-free Krylov path, each solve on an
operator symmetrically Jacobi-equilibrated: CG for the symmetric EMI
system, with the constant null space where the system has one (none
under a Dirichlet condition), preconditioned by the SA-AMG V-cycle
where a hierarchy is given (equilibrated with its lagged fine
diagonal), else by the deflated Jacobi fallback (equilibrated with the
assembled diagonal; an additive coarse correction over the ICS
subdomain indicators, M v = v + W G^-1 W^T v, G = W^T A W of size k x
k, k the number of ICS subdomains); and GMRES for the KNP blocks, with
the JAX package's two branches: batched over the solved ions of each
subdomain (one K3 pass and one batched V-cycle per iteration, the
branch the JAX package takes with ``use_pallas``) and per ion (one
GMRES per (subdomain, ion) block on the single-ion operator K11 with
the single-vector V-cycle, the branch it takes without); without a
hierarchy GMRES runs on the equilibrated operator alone.  In both, the
drift values K3 or K11 read are filled once per subdomain and solve
(K11f), or, under a manufactured solution, assembled once at setup.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch

from . import direct as direct_mod
from .cg import KrylovResult, cg
from .gmres import gmres, gmres_batched
from .precision import bdot2, dot2


class SolveInfo(NamedTuple):
    """Health of one linear solve (aggregated over blocks for KNP)."""

    iters: int
    resnorm: torch.Tensor
    converged: bool


def _equilibrate(A, b, diag, x0=None):
    """Symmetric Jacobi equilibration: (S A S) y = S b with
    S = diag(1/sqrt(|diag|)), x = S y.  Besides preconditioning, it keeps
    every Krylov quantity O(1) for meter-scaled meshes, where raw entries
    are ~1e-21 and f32 dot products would underflow."""
    s = 1.0 / torch.sqrt(torch.abs(diag))
    A_hat = lambda v: s * A(s * v)
    return A_hat, s * b, None if x0 is None else x0 / s, s


def _direct_info(like: torch.Tensor) -> SolveInfo:
    return SolveInfo(0, torch.zeros((), dtype=like.dtype, device=like.device), True)


class EMISolver:
    def __init__(self, system, direct: bool = False, rtol: float = 1e-5,
                 atol: float = 1e-40, maxiter: int = 1000, dot: Callable = torch.dot,
                 mg=None):
        self.system = system
        self.direct = direct
        self.rtol = rtol
        self.atol = atol
        self.maxiter = maxiter
        self.dot = dot
        self.mg = mg

    def solve(self, c, phi_M, I_ch=None, x0: Optional[Dict[int, torch.Tensor]] = None):
        """Returns ({tag: phi}, SolveInfo)."""
        sys_ = self.system
        if self.direct:
            x = torch.as_tensor(direct_mod.solve_emi_direct(sys_, c, phi_M, I_ch),
                                dtype=sys_.dtype, device=sys_.device)
            return sys_.split(x), _direct_info(x)
        ctx = sys_.prepare(sys_.kappa(c))
        b = sys_.rhs(c, phi_M, I_ch, ctx=ctx)
        # equilibration scale: the hierarchy's lagged fine diagonal where
        # there is one, else the assembled diagonal
        if self.mg is not None and self.mg.fine_diag is not None:
            d = self.mg.fine_diag
        else:
            d = sys_.diag(ctx["kappa"])
        x0_flat = None if x0 is None else sys_.flatten(x0)
        A_hat, b_hat, x0_hat, s = _equilibrate(
            lambda v: sys_.matvec(v, ctx), b, d, x0_flat
        )
        nullvec = None
        if sys_.nullvec is not None:
            # null(S A S) = S^-1 null(A)
            nv = sys_.nullvec / s
            nullvec = nv / torch.sqrt(self.dot(nv, nv))
        if self.mg is not None:
            M = lambda v: self.mg.apply(A_hat, v)
        else:
            M = self._deflation(A_hat, s)
        res = cg(
            A_hat, b_hat, x0=x0_hat, M=M, rtol=self.rtol, atol=self.atol,
            maxiter=self.maxiter, nullspace=nullvec, dot=self.dot,
        )
        return sys_.split(s * res.x), SolveInfo(res.iters, res.resnorm, res.converged)

    def _deflation(self, A_hat, s):
        """The deflated Jacobi preconditioner in equilibrated variables:
        M v = v + W G^-1 W^T v, W the ICS subdomain indicators (columns
        1/s on the subdomain's dofs), G = W^T A_hat W (k x k).  The
        membrane coupling is weak against bulk conduction at
        physiological h, so each indicator is a near-null mode that
        stalls plain Jacobi CG; None without an ICS subdomain."""
        sys_ = self.system
        cols = []
        for t in sys_.tags:
            if t == 0:
                continue
            e = torch.zeros(sys_.n, dtype=s.dtype, device=s.device)
            e[sys_.offsets[t]: sys_.offsets[t] + sys_.sub[t]["n_dofs"]] = 1.0
            cols.append(e / s)
        if not cols:
            return None
        W = torch.stack(cols, dim=1)  # (n, k)
        G = W.T @ torch.stack([A_hat(W[:, j]) for j in range(W.shape[1])], dim=1)
        return lambda v: v + W @ torch.linalg.solve(G, W.T @ v)


class KNPSolver:
    def __init__(self, system, direct: bool = False, rtol: float = 1e-7,
                 atol: float = 2e-40, maxiter: int = 1000, restart: int = 30,
                 min_iter: int = 5, dot: Callable = torch.dot,
                 bdot: Optional[Callable] = None, mg=None, batched: bool = True):
        self.system = system
        self.direct = direct
        self.rtol = rtol
        self.atol = atol
        self.maxiter = maxiter
        self.restart = restart
        self.min_iter = min_iter
        self.dot = dot
        # the batched inner product: derived from ``dot`` only for the
        # compensated pair; a custom dot brings its batched variant
        if bdot is None and dot is dot2:
            bdot = bdot2
        self.bdot = bdot
        self.mg = mg or {}
        # True: all solved ions of a subdomain in one GMRES; False: one
        # GMRES per ion (the choice the JAX package makes by use_pallas)
        self.batched = batched

    def _solve_batched(self, t, rhs_t, diag, x0_t, gradphi_t, mg_t) -> KrylovResult:
        """All solved ions of subdomain ``t`` in one GMRES on K3's operator
        with the batched V-cycle, the drift values filled once (K11f); x
        and resnorm have one row per ion."""
        sys_ = self.system
        Dr = sys_.drift_values(t, gradphi_t)
        s_eq = 1.0 / torch.sqrt(torch.abs(diag))  # (Ns, n)
        A_hat = lambda V: s_eq * sys_.matvec_batch(t, s_eq * V, Dr)
        M = None
        if mg_t is not None:
            # level 0 smooths with its lagged ELL operator: no A0 needed
            M = lambda V: mg_t.apply_batch(lambda W: W, V)
        res = gmres_batched(
            A_hat, s_eq * rhs_t, x0=x0_t / s_eq, M=M, rtol=self.rtol,
            atol=self.atol, maxiter=self.maxiter, restart=self.restart,
            min_iter=self.min_iter, bdot=self.bdot,
        )
        return res._replace(x=s_eq * res.x)

    def _solve_per_ion(self, t, rhs_t, diag, x0_t, gradphi_t, mg_t) -> KrylovResult:
        """One GMRES per solved ion of subdomain ``t`` on K11's operator
        with the single-vector V-cycle, the drift values filled once for
        all ions (K11f); iters is the max over the ions, converged their
        conjunction.  The loop takes the place of the JAX package's vmap:
        each ion stops at its own iteration."""
        sys_ = self.system
        Dr = sys_.drift_values(t, gradphi_t)
        results = []
        for k in range(sys_.n_solved):
            A_hat, b_hat, x0_hat, s = _equilibrate(
                lambda v, k=k: sys_.matvec_one(t, k, v, Dr),
                rhs_t[k], diag[k], x0_t[k],
            )
            M = None if mg_t is None else (lambda v, A_hat=A_hat: mg_t.apply(A_hat, v))
            res = gmres(
                A_hat, b_hat, x0=x0_hat, M=M, rtol=self.rtol, atol=self.atol,
                maxiter=self.maxiter, restart=self.restart,
                min_iter=self.min_iter, dot=self.dot,
            )
            results.append(res._replace(x=s * res.x))
        return KrylovResult(
            x=torch.stack([r.x for r in results]),
            iters=max(r.iters for r in results),
            resnorm=torch.stack([r.resnorm for r in results]),
            converged=all(r.converged for r in results),
        )

    def solve(self, c, phi, phi_M, I_ch=None, source_gate=1.0,
              x0: Optional[Dict[int, torch.Tensor]] = None):
        """Returns ({tag: (N_solved, n)}, SolveInfo); iters and resnorm are
        the max over the (subdomain, ion) blocks, converged their
        conjunction."""
        sys_ = self.system
        if self.direct:
            host = direct_mod.solve_knp_direct(sys_, c, phi, phi_M, I_ch, source_gate)
            out = {t: torch.as_tensor(v, dtype=sys_.dtype, device=sys_.device)
                   for t, v in host.items()}
            return out, _direct_info(next(iter(out.values())))
        rhs = sys_.rhs(c, phi, phi_M, I_ch, source_gate)
        gradphi = sys_.gradphi_cells(phi)
        solve_tag = self._solve_batched if self.batched else self._solve_per_ion
        out = {}
        iters, resnorm, converged = 0, None, True
        Ns = sys_.n_solved
        for t in sys_.tags:
            mg_t = self.mg.get(t)
            if mg_t is not None and mg_t.fine_diag is not None:
                # lagged scale (mass + mean-D stiffness diagonal)
                diag = mg_t.fine_diag.expand(Ns, -1)
            else:
                diag = sys_.diag(t, gradphi[t])
            x0_t = torch.zeros_like(rhs[t]) if x0 is None else x0[t][:Ns]
            res = solve_tag(t, rhs[t], diag, x0_t, gradphi[t], mg_t)
            out[t] = res.x
            iters = max(iters, res.iters)
            rn_t = res.resnorm.max()
            resnorm = rn_t if resnorm is None else torch.maximum(resnorm, rn_t)
            converged = converged and res.converged
        return out, SolveInfo(iters, resnorm, converged)


def create_solver_emi(system, direct=False, rtol=1e-5, atol=1e-40, **kw) -> EMISolver:
    return EMISolver(system, direct=direct, rtol=rtol, atol=atol, **kw)


def create_solver_knp(system, direct=False, rtol=1e-7, atol=2e-40, **kw) -> KNPSolver:
    return KNPSolver(system, direct=direct, rtol=rtol, atol=atol, **kw)
