"""φ-function exponential integrator and ``exponentiate`` (counterpart of
``krylovkit_tpu/solvers/expintegrator.py``).

Computes ``y = φ₀(tA)u₀ + t·φ₁(tA)u₁ + … + tᵖ·φ_p(tA)u_p``, the solution of
``ẋ = A x + Σⱼ tʲ/j! u_{j+1}`` at time ``t``, by the augmented-matrix trick
``exp([[Δτ·H, e₁, 0], [0, J_p]])`` on the Krylov projection with adaptive
substepping (reference ``src/matrixfun/expintegrator.jl``):

* augmented matrix (``:196-202``): ``H_aug[0, K] = 1`` and superdiagonal
  ones in the trailing ``p×p`` Jordan block;
* error model ``ϵ = |Δτᵖ · β · normres · expH[K-1, K+p]|`` and the step
  controller with safety factors ``δ = 1.2`` (implicit), ``γ = 0.8`` and the
  order estimate ``q`` (``:203-221``);
* early completion of the remaining interval once the factorization
  residual is small, or in eager mode (``:237-258``);
* ``t = Inf`` fixed-point mode (``:127-135``): ``Δτ`` runs free and the loop
  ends at ``maxiter`` or when the inhomogeneity residual vanishes;
* a ``Lanczos`` algorithm uses the Hermitian recurrence (the Rayleigh
  quotient is then rebuilt from the lower triangle of ``H``), an ``Arnoldi``
  algorithm the general expansion (``:170-175``).

``t`` is a host number.  The JAX package's ``while_loop``/``cond`` structure
is host control flow here: ``K``, the counters and the step controller
(``τ₀``, ``Δτ``, ``Δτ_min``, ``ϵ``, ``ω``, ``q``: 0-d CPU tensors of the
working real type, so the controller rounds as the JAX package's does) live
on the host.  Reads from the device: ``β`` once per expansion step (the
loop test) and the pair ``(ϵ, ω)`` once per evaluation of the augmented
exponential (at most 65 per cycle), plus ``‖w_{p+1}‖`` once per restart when
``p == 1``.  Real float32 Hermitian stencil problems run the one-stream
fused expansion (``kf.fused_expansions(..., min_one=True)``); on a sharded
space (``psum_axis``) every rank runs it on its block of rows, with the
neighbours' edge rows as external halos.  The vectors ``u`` may be pytrees
(``ops/vector.py``), which take the unfused expansion.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from .. import dense
from ..ad._common import refuse_grad
from ..algorithms import Arnoldi, Lanczos
from ..factorizations import krylov as kf
from ..info import STARTSTOP, ConvergenceInfo, log_if, warn_if
from ..ops import basis as bs
from ..ops import orthonormal as on
from ..ops.operator import LinearOperator, as_operator, probe_dtype
from ..ops.vector import STANDARD, VectorSpace, add, astype, device_of, zerovector

__all__ = ["expintegrator", "exponentiate"]


def _build_aug(H, K: int, p: int, coeff, m1p: int):
    """Augmented matrix ``[[coeff·H_active, e₁ e_Kᵀ, J], …]`` on the static
    ``(m+p+1, m+p+1)`` buffer (reference ``src/matrixfun/expintegrator.jl:196-202``)."""
    M = torch.zeros((m1p, m1p), dtype=H.dtype, device=H.device)
    M[:K, :K] = coeff * H[:K, :K]
    M[0, K] += 1
    for r in range(K, K + p):
        M[r, r + 1] += 1
    return M


def _phi_step(H, K: int, p: int, sgn_dtau, beta, normres, m1p: int, eta_dt):
    """Evaluate the augmented exponential for the step ``Δτ`` (inside
    ``sgn_dtau``, a host number).  Returns ``(expH, ϵ, ω)`` with the
    reference's error model; ``ϵ`` and ``ω`` come back as 0-d CPU tensors
    (one read from the device)."""
    M = _build_aug(H, K, p, sgn_dtau, m1p)
    expH = dense.expm_active(M, K + p + 1)
    corr = expH[max(K - 1, 0), K + p]
    dtau_abs = abs(sgn_dtau)
    eps_ = torch.abs(dtau_abs ** p * beta * normres * corr)
    omega = eps_ / (eta_dt * dtau_abs)
    eps_, omega = torch.stack([eps_, omega]).cpu()
    return expH, eps_, omega


def expintegrator(
    A,
    t,
    u,
    *more_u,
    alg=None,
    space: VectorSpace = STANDARD,
    ishermitian: Optional[bool] = None,
    tol: Optional[float] = None,
    krylovdim: Optional[int] = None,
    maxiter: Optional[int] = None,
    orth=None,
    eager: Optional[bool] = None,
    verbosity: Optional[int] = None,
):
    """``y, info = expintegrator(A, t, (u₀, u₁, …))`` on the device of ``u₀``
    (reference ``src/matrixfun/expintegrator.jl:94-101``).  ``info.normres``
    is the accumulated error estimate; ``info.residual`` is ``None``."""
    if more_u:
        u = (u,) + more_u
    if not isinstance(u, tuple):
        u = (u,)
    op = as_operator(A, device=device_of(u[0]))
    refuse_grad("exponentiate/expintegrator", op, *u,
                *((t,) if isinstance(t, torch.Tensor) else ()))
    if alg is None:
        herm = ishermitian
        if herm is None:
            from .eigsolve import _is_concrete, _probe_hermitian

            herm = _probe_hermitian(A) if _is_concrete(A) else False
        cls = Lanczos if herm else Arnoldi
        kw = dict(
            tol=tol, krylovdim=krylovdim, maxiter=maxiter, orth=orth,
            eager=eager, verbosity=verbosity,
        )
        alg = cls(**{k: v for k, v in kw.items() if v is not None})
    elif tol is not None and alg.tol != tol:
        alg = dataclasses.replace(alg, tol=tol)
    t = complex(t) if isinstance(t, complex) or np.iscomplexobj(t) else float(t)
    return _expintegrator_core(op, t, u, alg, space)


def exponentiate(A, t, v, **kw):
    """``y ≈ exp(t·A)·v`` (reference ``src/matrixfun/exponentiate.jl:83-84``:
    ``expintegrator`` with a single vector)."""
    return expintegrator(A, t, (v,), **kw)


def _expintegrator_core(op: LinearOperator, t, u: tuple, alg, space: VectorSpace):
    if len(u) == 1:
        u = (u[0], zerovector(u[0]))
    p = len(u) - 1
    m = alg.krylovdim
    m1p = m + p + 1
    dev = device_of(u[0])

    cdt = probe_dtype(op, u[0])
    if isinstance(t, complex) and t.imag != 0:
        cdt = torch.promote_types(cdt, torch.complex64)
    rdt = cdt.to_real()
    u = tuple(astype(ui, cdt) for ui in u)

    def real(v):
        return torch.tensor(v, dtype=rdt)

    eta = real(alg.tol)
    eps = torch.finfo(rdt).eps

    # time-step parameters
    tau_f = abs(t)
    if isinstance(t, complex):
        sgn = t / tau_f if tau_f > 0 else 1.0
        if not cdt.is_complex:
            sgn = sgn.real
    else:
        sgn = math.copysign(1.0, t) if t != 0 else 1.0
    finite = math.isfinite(tau_f)
    tau = real(tau_f)
    if finite:
        dtau = tau
        dtaumin = tau / alg.maxiter
        maxerr = tau * eta
    else:
        dtau = real(1.0)
        dtaumin = real(0.0)
        maxerr = eta

    def build_w(w0, tau0, numops):
        """``w[j+1] = A w[j] + Σ_l u[j+l+1]·(sgn·τ₀)ˡ/l!`` for ``j < p``
        (reference ``:144-158``, ``:289-301``); returns ``(w, w_{p+1}, ops)``."""
        w = [w0]
        for j in range(p):
            wj1 = op.normal(w[j])
            numops += 1
            lfac = 1.0
            for l in range(p - j):
                coef = sgn ** l * float(tau0) ** l / lfac
                wj1 = add(wj1, u[j + l + 1], a=coef)
                lfac *= l + 1
            w.append(wj1)
        return w[: p + 1], w[p], numops

    tau0 = real(0.0)
    w, wp1, numops = build_w(u[0], tau0, 0)
    beta0 = space.norm(wp1)  # ‖w[p+1]‖ at the start of the cycle

    fact = kf.initialize(wp1, m, cdt, space, vec_dtype=cdt)
    # one-stream fused expansion (ops/fused_lanczos.py): Hermitian Lanczos
    # subspaces of real float32 stencil operators under cgs, or under cgs2
    # (its one-reduce form) while the packed reductions fit
    dgks = type(alg.orth) is on.ClassicalGramSchmidt2 and 2 * (m + 1) + 2 <= 128
    fused = (
        isinstance(alg, Lanczos)
        and not alg.eager
        and (type(alg.orth) is on.ClassicalGramSchmidt or dgks)
        and cdt == torch.float32
        and kf.fused_available(op, u[0], space, kmax=m + 1)
    )
    sc = kf.fused_scales_init(m + 1, device=dev)
    totalerr = real(0.0)
    numiter = 1
    done = fixedpt = False
    # immediate fixed point (reference :127-135), reported with numiter = 0
    # (":163: ConvergenceInfo(1, …, 0, numops)")
    if p == 1 and float(beta0) < float(eta):
        done = fixedpt = True
        numiter = 0

    def _Heff(H):
        # the Hermitian expansion writes only (α, β): rebuild the Rayleigh
        # quotient from the lower triangle
        if isinstance(alg, Lanczos):
            return torch.tril(H) + torch.tril(H, -1).conj().T
        return H

    def expand_one(fact):
        if isinstance(alg, Lanczos):
            return kf.expand_hermitian(op.normal, fact, alg.orth, space,
                                       verbosity=alg.verbosity)
        return kf.expand(op.normal, fact, alg.orth, space, alg.verbosity)

    def trial(fact, dt):
        return _phi_step(_Heff(fact.H), fact.k, p, sgn * float(dt), beta0, fact.beta,
                         m1p, eta.to(dev))

    def take_step(fact, sc, w, expH, dtau_eff):
        """Advance ``w₀`` over ``Δτ`` (reference ``:224-240``)."""
        K = fact.k
        w0 = w[0]
        sgn_dt = sgn * float(dtau_eff)
        jfac = 1.0
        for j in range(1, p):
            w0 = add(w0, w[j], a=sgn_dt ** j / jfac)
            jfac *= j + 1
        # w_{p+1} ← V·expH[0:K, K+p-1] + residual·expH[K-1, K+p]
        col = expH[: m + 1, K + p - 1].clone()
        col[K:] = 0
        corr = expH[max(K - 1, 0), K + p]
        # the fused expansion stores raw rows (v_j = Σ_i L[i,j]·row_i): fold L
        # into the coefficients, and fold the residual correction corr·β·v_K
        # into the same unproject (one pass over the basis)
        colm = kf.fold_scales(sc, col) + (corr * fact.beta.to(cdt)) * sc.L[:, K].to(cdt)
        wp1 = bs.unproject(fact.V, colm)
        w0 = add(w0, wp1, a=beta0.to(cdt) * sgn_dt ** p)
        return [w0] + w[1:]

    while not done:
        # --- expand to krylovdim (or breakdown / small residual / eager) ---
        rem_eta = float((tau - tau0) * eta)
        if fact.k < m and float(fact.beta) > 0:
            if fused:
                # the unfused pair below runs while β > max(eps, (τ−τ₀)·η);
                # min_one: after a rejected partial attempt the loop re-enters
                # with β within that bound and an unnormalized last row, and
                # must still take its one step
                fact, sc, dops = kf.fused_expansions(
                    op, fact, sc, m, max(eps, rem_eta), space,
                    hermitian=True, min_one=True, dgks=dgks,
                )
                numops += dops
            else:
                fact = expand_one(fact)
                numops += 1
        if not fused:
            while fact.k < m and not (alg.eager and fact.k >= 1):
                b = float(fact.beta)
                # stop once the factorization residual covers the remaining
                # interval's error budget (reference :237)
                if not b > eps or b <= rem_eta:
                    break
                fact = expand_one(fact)
                numops += 1

        K = fact.k
        # complete: the subspace is full or invariant (breakdown); then the
        # projected exponential is exact and the adaptive branch applies too
        complete = K >= m or float(fact.beta) <= eps
        if complete:
            # --- full subspace, adaptive Δτ (reference :178-236) ---
            atmax = numiter >= alg.maxiter
            dtau = (tau - tau0) if atmax else torch.minimum(dtau, tau - tau0)
            if not atmax and finite:
                dtaumin = (tau - tau0) / max(alg.maxiter - numiter + 1, 1)
            expH, eps_, omega = trial(fact, dtau)
            q = real(K) / 2
            it = 0
            while not atmax and omega >= 1.0 and dtau > dtaumin and it < 64:
                dtau_prev, eps_prev = dtau, eps_
                dtau = torch.maximum(dtau * (0.8 / omega) ** (1 / (q + 1)), dtaumin)
                expH, eps_, omega = trial(fact, dtau)
                q = torch.clamp(torch.log(eps_ / eps_prev) / torch.log(dtau / dtau_prev) - 1,
                                min=0.0)
                it += 1
            w = take_step(fact, sc, w, expH, dtau)
            totalerr = totalerr + eps_
            tau0 = tau if atmax else tau0 + dtau
            # grow Δτ for the next cycle; the cap keeps an exact step (ω = 0)
            # from pushing Δτ to Inf
            if omega < 0.8:
                growth = (0.8 / torch.clamp(omega, min=1e-12)) ** (1 / (q + 1))
                dtau = dtau * torch.clamp(growth, max=1e3)
        else:
            # --- partial subspace: attempt the remaining interval (:237-258) ---
            dt = tau - tau0
            # with t = Inf the attempt evaluates exp(Inf·H): ω is NaN and the
            # step is always rejected, so it is not evaluated
            if (float(fact.beta) <= rem_eta or alg.eager) and finite:
                expH, eps_, omega = trial(fact, dt)
                if omega < 1.0:
                    w = take_step(fact, sc, w, expH, dt)
                    totalerr = totalerr + eps_
                    tau0 = tau

        done = bool(tau0 >= tau)

        # --- restart if not finished and the subspace is complete ---
        if not done and complete:
            w, wp1, numops = build_w(w[0], tau0, numops)
            beta0 = space.norm(wp1)
            fixedpt = p == 1 and float(beta0) < float(eta)
            fact = kf.initialize(wp1, m, cdt, space, vec_dtype=cdt)
            sc = kf.fused_scales_init(m + 1, device=dev)
            # a fixed point found here exits before the reference increments
            # numiter (src/matrixfun/expintegrator.jl:299-304 returns, :319
            # is the increment)
            if fixedpt:
                done = True
            else:
                numiter += 1

    log_if(
        alg.verbosity, STARTSTOP,
        "expintegrate finished after {it} iterations: total error = {err}, "
        "numops = {no}", it=numiter, err=totalerr, no=numops,
    )
    warn_if(
        alg.verbosity,
        not fixedpt and bool(totalerr > maxerr),
        "expintegrate did not reach sufficiently small error after {it} "
        "iterations: total error = {err}", it=numiter, err=totalerr,
    )
    info = ConvergenceInfo(
        converged=int(fixedpt or bool(totalerr <= maxerr)),
        residual=None,
        normres=beta0 if fixedpt else totalerr.to(dev),
        numiter=numiter,
        numops=numops,
    )
    return w[0], info
