"""Conjugate Gradients driver (counterpart of ``krylovkit_tpu/solvers/cg.py``;
reference ``src/linsolve/cg.jl``).

Solves ``(a0 + a1·A) x = b`` for a Hermitian positive-definite combined
operator, as an eager loop on the host: the loop test reads the recurrence's
residual norm from the device once per iteration.  Keeps the reference's
robustness feature: on apparent convergence the *true* residual
``b - (a0 + a1 A)x`` is recomputed (a host ``if``) and the recurrence
restarts from it when it fails the tolerance (``src/linsolve/cg.jl:69-75``).
``b`` and ``x0`` may be pytree vectors (``ops/vector.py``).
"""

from __future__ import annotations

import torch

from ..algorithms import CG
from ..info import STARTSTOP, ConvergenceInfo, log_if, warn_if
from ..ops.operator import LinearOperator, apply_shifted
from ..ops.vector import STANDARD, VectorSpace, add, rounded, scalartype

__all__ = ["linsolve_cg"]


def linsolve_cg(op: LinearOperator, b, x0, a0, a1, alg: CG,
                space: VectorSpace = STANDARD):
    tol = rounded(alg.tol, scalartype(b).to_real())

    def shifted(x):
        return apply_shifted(op, x, a0, a1)

    def true_residual(x):
        return add(b, shifted(x), a=-1)

    x = x0
    r = p = true_residual(x0)
    rho = torch.real(space.inner(r, r))
    normr = torch.sqrt(rho)
    numiter, numops = 0, 1
    done = float(normr) <= tol
    while not done:
        Ap = shifted(p)
        pAp = torch.real(space.inner(p, Ap))
        alpha = rho / torch.where(pAp != 0, pAp, 1)
        x = add(x, p, a=alpha)
        r = add(r, Ap, a=-alpha)
        rho_new = torch.real(space.inner(r, r))
        beta = rho_new / torch.where(rho != 0, rho, 1)
        p = add(r, p, a=beta)
        rho = rho_new
        normr = torch.sqrt(rho)
        numiter += 1
        numops += 1
        nr = float(normr)
        if nr <= tol:
            # hard true-residual check on apparent convergence (cg.jl:69-75):
            # restart the recurrence from the true residual
            r = p = true_residual(x)
            rho = torch.real(space.inner(r, r))
            normr = torch.sqrt(rho)
            numops += 1
            nr = float(normr)
        done = nr <= tol or numiter >= alg.maxiter
    conv = int(float(normr) <= tol)
    log_if(
        alg.verbosity, STARTSTOP,
        "CG linsolve finished after {it} iterations: converged = {c}, "
        "normres = {nr}, numops = {no}",
        it=numiter, c=conv, nr=normr, no=numops,
    )
    warn_if(
        alg.verbosity, conv == 0,
        "CG linsolve stopped without converging after {it} iterations: "
        "normres = {nr}", it=numiter, nr=normr,
    )
    info = ConvergenceInfo(converged=conv, residual=r, normres=normr,
                           numiter=numiter, numops=numops)
    return x, info
