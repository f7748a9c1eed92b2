"""Restarted, right-preconditioned GMRES(m): one system, or a batch.

Counterpart of ``knpemi_tpu/solvers/gmres.py``.  :func:`gmres` (:21)
solves one system, with the inner product ``dot`` injectable (the
compensated ``dot2`` in float32); the per-ion KNP solve calls it once
per (subdomain, ion) block, so each ion stops at its own iteration.
:func:`gmres_batched` (:175) takes ``A`` mapping (B, n) -> (B, n), called
once per inner iteration for every row together (the KNP ion systems of
one subdomain share one K3 pass); all rows run the same iteration count
until every row converges.  In both the preconditioned basis Z[j] = M(V[j]) is stored (flexible GMRES), so
the correction is Z y without another V-cycle.  ``min_iter`` mirrors
PETSc's ksp_min_it.  The JAX loops are ``lax.while_loop``s; here they
are Python loops that read the stopping test back to the host once per
iteration.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .cg import KrylovResult


def _bdot(u, v):
    return torch.einsum("bn,bn->b", u, v)


def gmres(A: Callable, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
          M: Optional[Callable] = None, rtol: float = 1e-7,
          atol: float = 1e-40, maxiter: int = 1000, restart: int = 30,
          min_iter: int = 0, dot: Callable = torch.dot) -> KrylovResult:
    """Solve A x = b for one vector b (n,).  Returns x, the iteration
    count, the residual norm (0-d) and whether it is within
    max(rtol ||b||, atol)."""
    has_M = M is not None
    if M is None:
        M = lambda v: v
    if x0 is None:
        x0 = torch.zeros_like(b)
    m = restart
    opts = dict(dtype=b.dtype, device=b.device)
    rtol = max(rtol, 4 * torch.finfo(b.dtype).eps)

    r0 = b - A(x0)
    r0norm = torch.sqrt(dot(r0, r0))
    tol = torch.clamp_min(rtol * torch.sqrt(dot(b, b)), atol)

    def cycle(x, r, total_it):
        beta = torch.sqrt(dot(r, r))
        one = torch.ones_like(beta)
        zero = torch.zeros_like(beta)
        V = [r / torch.where(beta > 0, beta, one)]
        Z = []
        H = torch.zeros(m + 1, m, **opts)
        cs, sn = [], []
        g = torch.zeros(m + 1, **opts)
        g[0] = beta
        res = beta
        j = 0
        while j < m:
            if total_it + j >= min_iter and not bool(res > tol):
                break
            z = M(V[j])
            if has_M:
                Z.append(z)
            w = A(z)
            # modified Gram-Schmidt over the j+1 live basis vectors
            h = []
            for i in range(j + 1):
                hi = dot(V[i], w)
                w = w - hi * V[i]
                h.append(hi)
            hj1 = torch.sqrt(dot(w, w))
            h.append(hj1)
            V.append(w / torch.where(hj1 > 0, hj1, one))
            # previous Givens rotations on the new column
            for i in range(j):
                t = cs[i] * h[i] + sn[i] * h[i + 1]
                u = -sn[i] * h[i] + cs[i] * h[i + 1]
                h[i], h[i + 1] = t, u
            # new rotation annihilating h[j+1]
            denom = torch.sqrt(h[j] ** 2 + h[j + 1] ** 2)
            pos = denom > 0
            denom_s = torch.where(pos, denom, one)
            c_new = torch.where(pos, h[j] / denom_s, one)
            s_new = torch.where(pos, h[j + 1] / denom_s, zero)
            h[j] = c_new * h[j] + s_new * h[j + 1]
            cs.append(c_new)
            sn.append(s_new)
            g_j = g[j].clone()
            g[j] = c_new * g_j
            g[j + 1] = -s_new * g_j
            H[: j + 1, j] = torch.stack(h[: j + 1])
            res = torch.abs(g[j + 1])
            j += 1
        if j == 0:
            return x, total_it, res
        # back-substitution on the leading j x j upper-triangular block
        y = torch.linalg.solve_triangular(H[:j, :j], g[:j, None], upper=True)[:, 0]
        basis = torch.stack(Z if has_M else V[:j])  # (j, n)
        return x + y @ basis, total_it + j, res

    if maxiter > 0 and bool(r0norm > tol):
        x, it, res = cycle(x0, r0, 0)
    else:
        x, it, res = x0, 0, r0norm
    best = r0norm
    # stop on convergence, cap, or a stagnated restart cycle (best = the
    # smallest residual of all cycles before the latest one)
    while it < maxiter:
        going, improving = torch.stack([res > tol, res < 0.999 * best]).tolist()
        if not (going and improving):
            break
        best = torch.minimum(best, res)
        x, it, res = cycle(x, b - A(x), it)
    return KrylovResult(x=x, iters=it, resnorm=res, converged=bool(res <= tol))


def gmres_batched(A: Callable, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
                  M: Optional[Callable] = None, rtol: float = 1e-7,
                  atol: float = 1e-40, maxiter: int = 1000, restart: int = 30,
                  min_iter: int = 0, bdot: Optional[Callable] = None) -> KrylovResult:
    """Returns x (B, n), the shared iteration count, per-row resnorm (B,)
    and whether every row converged."""
    has_M = M is not None
    if M is None:
        M = lambda v: v
    if x0 is None:
        x0 = torch.zeros_like(b)
    if bdot is None:
        bdot = _bdot
    B, n = b.shape
    m = restart
    opts = dict(dtype=b.dtype, device=b.device)
    rtol = max(rtol, 4 * torch.finfo(b.dtype).eps)

    r0 = b - A(x0)
    r0norm = torch.sqrt(bdot(r0, r0))
    tol = torch.clamp_min(rtol * torch.sqrt(bdot(b, b)), atol)  # (B,)

    def cycle(x, r, total_it):
        beta = torch.sqrt(bdot(r, r))
        one = torch.ones_like(beta)
        V = [r / torch.where(beta > 0, beta, one)[:, None]]
        Z = []
        H = torch.zeros(B, m + 1, m, **opts)
        cs = torch.zeros(B, m, **opts)
        sn = torch.zeros(B, m, **opts)
        g = torch.zeros(B, m + 1, **opts)
        g[:, 0] = beta
        res = beta
        j = 0
        while j < m:
            if total_it + j >= min_iter and not bool((res > tol).any()):
                break
            z = M(V[j])
            if has_M:
                Z.append(z)
            w = A(z)
            # modified Gram-Schmidt over the j+1 live basis vectors
            hcol = torch.zeros(B, m + 1, **opts)
            for i in range(j + 1):
                hi = bdot(V[i], w)
                w = w - hi[:, None] * V[i]
                hcol[:, i] = hi
            hj1 = torch.sqrt(bdot(w, w))
            hcol[:, j + 1] = hj1
            V.append(w / torch.where(hj1 > 0, hj1, one)[:, None])
            # previous Givens rotations on the new column
            for i in range(j):
                t = cs[:, i] * hcol[:, i] + sn[:, i] * hcol[:, i + 1]
                u = -sn[:, i] * hcol[:, i] + cs[:, i] * hcol[:, i + 1]
                hcol[:, i] = t
                hcol[:, i + 1] = u
            # new rotation annihilating h[j+1]
            denom = torch.sqrt(hcol[:, j] ** 2 + hcol[:, j + 1] ** 2)
            pos = denom > 0
            denom_s = torch.where(pos, denom, one)
            c_new = torch.where(pos, hcol[:, j] / denom_s, one)
            s_new = torch.where(pos, hcol[:, j + 1] / denom_s, torch.zeros_like(one))
            hcol[:, j] = c_new * hcol[:, j] + s_new * hcol[:, j + 1]
            hcol[:, j + 1] = 0.0
            cs[:, j] = c_new
            sn[:, j] = s_new
            g_j = g[:, j].clone()
            g[:, j] = c_new * g_j
            g[:, j + 1] = -s_new * g_j
            H[:, :, j] = hcol
            res = torch.abs(g[:, j + 1])
            j += 1
        if j == 0:
            return x, total_it, res
        # back-substitution on the leading j x j upper-triangular block
        y = torch.linalg.solve_triangular(
            H[:, :j, :j], g[:, :j, None], upper=True
        )[..., 0]  # (B, j)
        basis = torch.stack(Z if has_M else V[:j])  # (j, B, n)
        dx = torch.einsum("jbn,bj->bn", basis, y)
        return x + dx, total_it + j, res

    if maxiter > 0 and bool((r0norm > tol).any()):
        x, it, res = cycle(x0, r0, 0)
    else:
        x, it, res = x0, 0, r0norm
    best = r0norm
    # stop on convergence, cap, or a stagnated restart cycle (best = the
    # smallest residual of all cycles before the latest one)
    while it < maxiter:
        going, improving = torch.stack(
            [(res > tol).any(), (res < 0.999 * best).any()]
        ).tolist()
        if not (going and improving):
            break
        best = torch.minimum(best, res)
        x, it, res = cycle(x, b - A(x), it)
    return KrylovResult(x=x, iters=it, resnorm=res, converged=bool((res <= tol).all()))
