"""Preconditioned conjugate gradients, matrix-free.

Counterpart of ``knpemi_tpu/solvers/cg.py``: iteration count reported,
constant-nullspace projection for the pure-Neumann EMI system,
PETSc-style test ||r|| < max(rtol ||b||, atol) with rtol floored at
4 eps of the dtype, and a stagnation guard.  The JAX loop is a
``lax.while_loop``; here it is a Python loop that reads the stopping
test back to the host once per iteration.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


class KrylovResult(NamedTuple):
    x: torch.Tensor
    iters: int
    resnorm: torch.Tensor  # final residual 2-norm (per row for batches)
    converged: bool


def cg(A: Callable, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
       M: Optional[Callable] = None, rtol: float = 1e-5, atol: float = 1e-40,
       maxiter: int = 1000, nullspace: Optional[torch.Tensor] = None,
       dot: Callable = torch.dot) -> KrylovResult:
    """Solve A x = b; ``nullspace`` is an orthonormal null vector that b
    and every iterate are kept orthogonal to."""
    if M is None:
        M = lambda v: v
    if x0 is None:
        x0 = torch.zeros_like(b)

    def project(v):
        if nullspace is None:
            return v
        return v - dot(nullspace, v) * nullspace

    b = project(b)
    x0 = project(x0)
    eps = torch.finfo(b.dtype).eps
    rtol = max(rtol, 4 * eps)
    r = project(b - A(x0))
    z = project(M(r))
    gamma = dot(r, z)
    tol2 = torch.clamp_min(rtol * torch.sqrt(dot(b, b)), atol) ** 2
    stall = 60 if b.dtype == torch.float32 else 300

    def safe_div(a, d):
        return torch.where(d != 0, a / torch.where(d != 0, d, torch.ones_like(d)),
                           torch.zeros_like(a))

    x, p = x0, z
    rr = dot(r, r)
    best_rr = rr
    k = best_k = 0
    # stop on convergence, iteration cap or stagnation; the two tests are
    # read back to the host together, once per iteration
    going = bool(rr > tol2)
    while going and k < maxiter and k - best_k < stall:
        Ap = project(A(p))
        alpha = safe_div(gamma, dot(p, Ap))
        x = x + alpha * p
        r = r - alpha * Ap
        z = project(M(r))
        gamma_new = dot(r, z)
        beta = safe_div(gamma_new, gamma)
        p = z + beta * p
        gamma = gamma_new
        rr = dot(r, r)
        going, improved = torch.stack([rr > tol2, rr < 0.999 * best_rr]).tolist()
        if improved:
            best_rr, best_k = rr, k + 1
        k += 1
    # roundoff reintroduces null components over many iterations: pin
    # the gauge on exit
    x = project(x)
    rn = torch.sqrt(rr)
    return KrylovResult(x=x, iters=k, resnorm=rn, converged=bool(rn * rn <= tol2))
