"""Solver front-ends: configure and run the EMI and KNP solves.

Counterpart of ``knpemi_tpu/solvers/api.py``: CG with the SA-AMG V-cycle
for the symmetric EMI system (constant null space), and GMRES for the
KNP blocks, each on an operator symmetrically Jacobi-equilibrated with
the hierarchy's lagged fine diagonal.  The KNP solve has the JAX
package's two branches: batched over the solved ions of each subdomain
(one K3 pass and one batched V-cycle per iteration, the branch the JAX
package takes with ``use_pallas``) and per ion (one GMRES per
(subdomain, ion) block on the single-ion operator K11 with the
single-vector V-cycle, the branch it takes without); in both, the drift
values K3 or K11 read are filled once per subdomain and solve (K11f).  Only the
iterative multigrid path is ported; the JAX package's direct LU path
and its deflated-Jacobi EMI fallback are not.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch

from .cg import KrylovResult, cg
from .gmres import gmres, gmres_batched


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


class EMISolver:
    def __init__(self, system, rtol: float = 1e-5, atol: float = 1e-40,
                 maxiter: int = 1000, dot: Callable = torch.dot, mg=None):
        self.system = system
        self.rtol = rtol
        self.atol = atol
        self.maxiter = maxiter
        self.dot = dot
        self.mg = mg

    def solve(self, c, phi_M, I_ch=None, x0: Optional[Dict[int, torch.Tensor]] = None):
        """Returns ({tag: phi}, SolveInfo)."""
        sys_ = self.system
        if self.mg is None or self.mg.fine_diag is None:
            raise NotImplementedError(
                "the EMI solve needs its multigrid hierarchy and lagged diagonal")
        ctx = sys_.prepare(sys_.kappa(c))
        b = sys_.rhs(c, phi_M, I_ch)
        d = self.mg.fine_diag
        x0_flat = None if x0 is None else sys_.flatten(x0)
        A_hat, b_hat, x0_hat, s = _equilibrate(
            lambda v: sys_.matvec(v, ctx), b, d, x0_flat
        )
        # null(S A S) = S^-1 null(A)
        nv = sys_.nullvec / s
        nullvec = nv / torch.sqrt(self.dot(nv, nv))
        res = cg(
            A_hat, b_hat, x0=x0_hat, M=lambda v: self.mg.apply(A_hat, v),
            rtol=self.rtol, atol=self.atol, maxiter=self.maxiter,
            nullspace=nullvec, dot=self.dot,
        )
        return sys_.split(s * res.x), SolveInfo(res.iters, res.resnorm, res.converged)


class KNPSolver:
    def __init__(self, system, rtol: float = 1e-7, atol: float = 2e-40,
                 maxiter: int = 1000, restart: int = 30, min_iter: int = 5,
                 dot: Callable = torch.dot, bdot: Optional[Callable] = None,
                 mg=None, batched: bool = True):
        self.system = system
        self.rtol = rtol
        self.atol = atol
        self.maxiter = maxiter
        self.restart = restart
        self.min_iter = min_iter
        self.dot = dot
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
