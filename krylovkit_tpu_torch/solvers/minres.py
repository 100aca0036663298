"""MINRES driver for Hermitian (possibly indefinite) systems (counterpart of
``krylovkit_tpu/solvers/minres.py``).

The reference declares MINRES but never implements it
(``src/algorithms.jl:397-426``, TODO at ``src/linsolve/linsolve.jl:140-141``);
the JAX package provides it and this is its port.  Solves
``(a0 + a1·A) x = b`` with ``A`` Hermitian and ``a0, a1`` real, using the
Paige–Saunders Lanczos + Givens-QR recurrence with O(1) vector storage, as an
eager host loop (one read of ``(|η|, β)`` per iteration).  Apparent
convergence is re-verified against the freshly computed true residual.
``b`` and ``x0`` may be pytree vectors (``ops/vector.py``).
"""

from __future__ import annotations

import torch

from ..algorithms import MINRES
from ..info import STARTSTOP, ConvergenceInfo, log_if, warn_if
from ..ops.operator import LinearOperator, apply_shifted, probe_dtype
from ..ops.vector import (
    STANDARD, VectorSpace, add, astype, device_of, rounded, scale, zerovector,
)

__all__ = ["linsolve_minres"]


def linsolve_minres(op: LinearOperator, b, x0, a0, a1, alg: MINRES,
                    space: VectorSpace = STANDARD):
    cdt = probe_dtype(op, b)
    rdt = cdt.to_real()
    tol = rounded(alg.tol, rdt)
    eps = torch.finfo(rdt).eps

    def shifted(x):
        return apply_shifted(op, x, a0, a1)

    x = astype(x0, cdt)
    r0 = astype(add(b, shifted(x), a=-1), cdt)
    beta1 = space.norm(r0)
    beta1_h = float(beta1)
    v = scale(r0, (1 / torch.where(beta1 > 0, beta1, 1)).to(cdt))
    one = torch.ones((), dtype=rdt, device=device_of(b))
    zero = torch.zeros((), dtype=rdt, device=device_of(b))
    v_prev, d, d_prev = zerovector(v), zerovector(v), zerovector(v)
    beta, eta = zero, beta1  # β entering the first step is 0 (no v_0 term)
    c1, s1, c2, s2 = one, zero, one, zero
    normr = beta1
    numiter, numops = 0, 1
    done = beta1_h <= tol
    while not done:
        w = shifted(v)
        w = add(w, v_prev, a=-beta.to(cdt))
        alpha = torch.real(space.inner(v, w))  # Hermitian → real
        w = add(w, v, a=-alpha.to(cdt))
        beta_next = space.norm(w)
        v_next = scale(w, (1 / torch.where(beta_next > 0, beta_next, 1)).to(cdt))

        # QR update: rotate the new T column (β_k, α_k, β_{k+1}) by G_{k-2}, G_{k-1}
        eps_k = s2 * beta
        t = c2 * beta
        delta = c1 * t + s1 * alpha
        gamma_hat = -s1 * t + c1 * alpha
        gamma = torch.sqrt(gamma_hat ** 2 + beta_next ** 2)
        safe_g = torch.where(gamma > 0, gamma, 1)
        c_new = torch.where(gamma > 0, gamma_hat / safe_g, one)
        s_new = torch.where(gamma > 0, beta_next / safe_g, zero)
        tau = c_new * eta
        eta_next = -s_new * eta

        # direction: d_k = (v_k − δ d_{k-1} − ε d_{k-2}) / γ
        dk = add(add(v, d, a=-delta.to(cdt)), d_prev, a=-eps_k.to(cdt))
        dk = scale(dk, (1 / safe_g).to(cdt))
        x = add(x, dk, a=tau.to(cdt))
        normr = torch.abs(eta_next)
        numiter += 1
        numops += 1
        nr, bn = torch.stack([normr, beta_next]).tolist()
        if nr <= tol:
            # true-residual verification on apparent convergence
            normr = space.norm(add(b, shifted(x), a=-1))
            numops += 1
            nr = float(normr)
        lucky = bn <= eps * beta1_h  # invariant subspace
        done = nr <= tol or numiter >= alg.maxiter or lucky
        v_prev, v, d_prev, d = v, v_next, d, dk
        beta, eta = beta_next, eta_next
        c2, s2, c1, s1 = c1, s1, c_new, s_new
    conv = int(float(normr) <= tol)
    log_if(
        alg.verbosity, STARTSTOP,
        "MINRES linsolve finished after {it} iterations: converged = {c}, "
        "normres = {nr}", it=numiter, c=conv, nr=normr,
    )
    warn_if(
        alg.verbosity, conv == 0,
        "MINRES linsolve stopped without converging after {it} iterations: "
        "normres = {nr}", it=numiter, nr=normr,
    )
    r_final = add(b, shifted(x), a=-1)
    info = ConvergenceInfo(converged=conv, residual=r_final, normres=normr,
                           numiter=numiter, numops=numops + 1)
    return x, info
