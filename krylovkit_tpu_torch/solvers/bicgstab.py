"""BiCGStab driver (counterpart of ``krylovkit_tpu/solvers/bicgstab.py``;
reference ``src/linsolve/bicgstab.jl``).

Solves ``(a0 + a1·A) x = b`` for a general operator with O(1) vector
storage, as an eager host loop.  Keeps the reference's robustness features:

* shadow residual ``r̃ = r₀`` fixed at the start of the solve;
* *both* the half step (after the BiCG α-update) and the full step (after
  the ω-update) check convergence, and each apparent convergence is verified
  against the freshly recomputed true residual ``b − (a0 + a1 A)x``
  (``src/linsolve/bicgstab.jl:139-155, 172-189``);
* breakdown guard: ``ρ ≈ 0`` or ``⟨r̃, v⟩ ≈ 0`` (below ``eps² ‖r₀‖²``) ends
  the solve with ``converged = 0`` (``src/linsolve/bicgstab.jl:39-46``).

``b`` and ``x0`` may be pytree vectors (``ops/vector.py``).
"""

from __future__ import annotations

import torch

from ..algorithms import BiCGStab
from ..info import STARTSTOP, ConvergenceInfo, log_if, warn_if
from ..ops.operator import LinearOperator, apply_shifted, probe_dtype
from ..ops.vector import STANDARD, VectorSpace, add, astype, device_of, rounded, zerovector

__all__ = ["linsolve_bicgstab"]


def linsolve_bicgstab(op: LinearOperator, b, x0, a0, a1, alg: BiCGStab,
                      space: VectorSpace = STANDARD):
    cdt = probe_dtype(op, b)
    rdt = cdt.to_real()
    tol = rounded(alg.tol, rdt)
    eps_break = torch.finfo(rdt).eps ** 2

    def shifted(x):
        return apply_shifted(op, x, a0, a1)

    def true_residual(x):
        return add(b, shifted(x), a=-1)

    x = astype(x0, cdt)
    r = astype(true_residual(x), cdt)
    normr0 = space.norm(r)
    # breakdown threshold, formed in the working type as the JAX package does
    thr = eps_break * normr0 * normr0
    rshadow = r  # fixed shadow residual (bicgstab.jl:20)
    one = torch.ones((), dtype=cdt, device=device_of(b))
    p, v = zerovector(r), zerovector(r)
    rho = alpha = omega = one
    normr = normr0
    numiter, numops = 0, 1
    breakdown = False
    done = float(normr0) <= tol
    while not done:
        rho_new = space.inner(rshadow, r)
        denom_w = torch.where(torch.abs(rho * omega) > 0, rho * omega, 1)
        beta = rho_new * alpha / denom_w  # β = (ρ_new/ρ)(α/ω)
        # p = r + β (p − ω v)
        p = add(r, add(p, v, a=-omega), a=beta)
        v = shifted(p)
        sigma = space.inner(rshadow, v)
        alpha = rho_new / torch.where(torch.abs(sigma) > 0, sigma, 1)
        # half step: s = r − α v, x_half = x + α p (bicgstab.jl:123-155)
        s = add(r, v, a=-alpha)
        norms = space.norm(s)
        numops += 1
        arho, asig, th, ns = torch.stack(
            [torch.abs(rho_new), torch.abs(sigma), thr, norms]
        ).tolist()
        breakdown = arho <= th or asig <= th
        if ns <= tol:
            x = add(x, p, a=alpha)
            r = true_residual(x)
            normr = space.norm(r)
            numops += 1
        else:
            t = shifted(s)
            tt = torch.real(space.inner(t, t))
            omega = space.inner(t, s) / torch.where(tt > 0, tt, 1)
            x = add(add(x, p, a=alpha), s, a=omega)
            r = add(s, t, a=-omega)
            normr = space.norm(r)
            numops += 1
            if float(normr) <= tol:
                r = true_residual(x)
                normr = space.norm(r)
                numops += 1
        rho = rho_new
        numiter += 1
        done = float(normr) <= tol or numiter >= alg.maxiter or breakdown
    conv = int(float(normr) <= tol)
    log_if(
        alg.verbosity, STARTSTOP,
        "BiCGStab linsolve finished after {it} iterations: converged = {c}, "
        "normres = {nr}", it=numiter, c=conv, nr=normr,
    )
    warn_if(
        alg.verbosity, breakdown,
        "BiCGStab linsolve breakdown (rho or sigma ~ 0) after {it} iterations",
        it=numiter,
    )
    warn_if(
        alg.verbosity, conv == 0 and not breakdown,
        "BiCGStab linsolve stopped without converging after {it} iterations: "
        "normres = {nr}", it=numiter, nr=normr,
    )
    info = ConvergenceInfo(converged=conv, residual=r, normres=normr,
                           numiter=numiter, numops=numops)
    return x, info
