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
from ..ops.vector import STANDARD, VectorSpace, add, astype, device_of, tree_map, zerovector

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
    return _expintegrator_core(op, _host_t(t), u, alg, space)


def _host_t(t):
    """``t`` as a host ``complex`` or ``float``."""
    return complex(t) if isinstance(t, complex) or np.iscomplexobj(t) else float(t)


def exponentiate(A, t, v, **kw):
    """``y ≈ exp(t·A)·v`` (reference ``src/matrixfun/exponentiate.jl:83-84``:
    ``expintegrator`` with a single vector)."""
    return expintegrator(A, t, (v,), **kw)


class _Integrator:
    """One problem's state of the integrator loop (reference
    ``src/matrixfun/expintegrator.jl``) and everything it does between two
    Krylov expansions.  :func:`_expintegrator_core` drives one;
    ``solvers/batched_expintegrator.py`` drives one per problem and makes the
    expansions and the operator applies of ``w`` for all of them at once.

    ``basis``, where given, is the ``(m + 1, ...)`` buffer every cycle's
    factorization lives in (zeroed and refilled at each restart), so a
    batched driver keeps all problems' bases in one stack."""

    def __init__(self, op: LinearOperator, t, u: tuple, alg, space: VectorSpace, cdt=None,
                 basis=None):
        if len(u) == 1:
            u = (u[0], zerovector(u[0]))
        self.op, self.alg, self.space, self.basis = op, alg, space, basis
        self.p = p = len(u) - 1
        self.m = m = alg.krylovdim
        self.m1p = m + p + 1
        self.dev = device_of(u[0])
        if cdt is None:
            cdt = probe_dtype(op, u[0])
            if isinstance(t, complex) and t.imag != 0:
                cdt = torch.promote_types(cdt, torch.complex64)
        self.cdt = cdt
        self.rdt = rdt = cdt.to_real()
        self.u = tuple(astype(ui, cdt) for ui in u)
        self.eta = self.real(alg.tol)
        self.eps = torch.finfo(rdt).eps

        # time-step parameters
        tau_f = abs(t)
        if isinstance(t, complex):
            sgn = t / tau_f if tau_f > 0 else 1.0
            if not cdt.is_complex:
                sgn = sgn.real
        else:
            sgn = math.copysign(1.0, t) if t != 0 else 1.0
        self.sgn = sgn
        self.finite = math.isfinite(tau_f)
        self.tau = self.real(tau_f)
        if self.finite:
            self.dtau = self.tau
            self.dtaumin = self.tau / alg.maxiter
            self.maxerr = self.tau * self.eta
        else:
            self.dtau = self.real(1.0)
            self.dtaumin = self.real(0.0)
            self.maxerr = self.eta
        self.tau0 = self.real(0.0)
        self.numops = 0
        self.w = [self.u[0]]

        # one-stream fused expansion (ops/fused_lanczos.py): Hermitian Lanczos
        # subspaces of real float32 stencil operators under cgs, or under cgs2
        # (its one-reduce form) while the packed reductions fit
        self.dgks = type(alg.orth) is on.ClassicalGramSchmidt2 and 2 * (m + 1) + 2 <= 128
        self.fused = (
            isinstance(alg, Lanczos)
            and not alg.eager
            and (type(alg.orth) is on.ClassicalGramSchmidt or self.dgks)
            and cdt == torch.float32
            and kf.fused_available(op, self.u[0], space, kmax=m + 1)
        )
        self.totalerr = self.real(0.0)
        self.numiter = 1
        self.done = self.fixedpt = False

    def real(self, v):
        return torch.tensor(v, dtype=self.rdt)

    # --- w[j+1] = A w[j] + Σ_l u[j+l+1]·(sgn·τ₀)ˡ/l! (reference :144-158, :289-301)

    def add_w(self, j: int, Aw) -> None:
        """Append ``w[j+1]`` from ``Aw = A w[j]`` (one operator apply)."""
        self.numops += 1
        lfac = 1.0
        for l in range(self.p - j):
            coef = self.sgn ** l * float(self.tau0) ** l / lfac
            Aw = add(Aw, self.u[j + l + 1], a=coef)
            lfac *= l + 1
        self.w.append(Aw)

    def start_cycle(self) -> None:
        """After the ``p`` applies of ``w``: the cycle's ``β₀ = ‖w_{p+1}‖``
        and factorization; at a fixed point (``p == 1``, ``β₀ < η``) the
        loop ends (reference ``:127-135``, ``:299-304``: reported with
        ``numiter`` as it stands)."""
        p = self.p
        self.w = self.w[: p + 1]
        wp1 = self.w[p]
        self.beta0 = self.space.norm(wp1)  # ‖w[p+1]‖ at the start of the cycle
        m, cdt = self.m, self.cdt
        fact = kf.initialize(wp1, m if self.basis is None else 0, cdt, self.space, vec_dtype=cdt)
        if self.basis is not None:
            tree_map(torch.Tensor.zero_, self.basis)
            bs.set(self.basis, 0, bs.get(fact.V, 0))
            H = torch.zeros((m + 1, m + 1), dtype=cdt, device=self.dev)
            fact = kf.KrylovState(self.basis, H, 0, fact.beta)
        self.fact = fact
        self.sc = kf.fused_scales_init(m + 1, device=self.dev)
        self.fixedpt = p == 1 and float(self.beta0) < float(self.eta)

    def rem_eta(self) -> float:
        """The remaining interval's error budget ``(τ − τ₀)·η``."""
        return float((self.tau - self.tau0) * self.eta)

    def _Heff(self, H):
        # the Hermitian expansion writes only (α, β): rebuild the Rayleigh
        # quotient from the lower triangle
        if isinstance(self.alg, Lanczos):
            return torch.tril(H) + torch.tril(H, -1).conj().T
        return H

    def trial(self, dt):
        fact = self.fact
        return _phi_step(self._Heff(fact.H), fact.k, self.p, self.sgn * float(dt), self.beta0,
                         fact.beta, self.m1p, self.eta.to(self.dev))

    def take_step(self, expH, dtau_eff) -> None:
        """Advance ``w₀`` over ``Δτ`` (reference ``:224-240``)."""
        fact, sc, p, w, cdt = self.fact, self.sc, self.p, self.w, self.cdt
        K = fact.k
        w0 = w[0]
        sgn_dt = self.sgn * float(dtau_eff)
        jfac = 1.0
        for j in range(1, p):
            w0 = add(w0, w[j], a=sgn_dt ** j / jfac)
            jfac *= j + 1
        # w_{p+1} ← V·expH[0:K, K+p-1] + residual·expH[K-1, K+p]
        col = expH[: self.m + 1, K + p - 1].clone()
        col[K:] = 0
        corr = expH[max(K - 1, 0), K + p]
        # the fused expansion stores raw rows (v_j = Σ_i L[i,j]·row_i): fold L
        # into the coefficients, and fold the residual correction corr·β·v_K
        # into the same unproject (one pass over the basis)
        colm = kf.fold_scales(sc, col) + (corr * fact.beta.to(cdt)) * sc.L[:, K].to(cdt)
        wp1 = bs.unproject(fact.V, colm)
        w0 = add(w0, wp1, a=self.beta0.to(cdt) * sgn_dt ** p)
        self.w = [w0] + w[1:]

    def after_expansion(self, rem_eta: float) -> bool:
        """The rest of a cycle once the factorization is expanded: the
        adaptive step on a complete subspace, or the attempt of the
        remaining interval on a partial one.  Returns whether the next
        cycle must restart (then the caller rebuilds ``w`` from ``w[0]``
        and calls :meth:`start_cycle`)."""
        alg, fact, real = self.alg, self.fact, self.real
        tau, tau0 = self.tau, self.tau0
        K = fact.k
        # complete: the subspace is full or invariant (breakdown); then the
        # projected exponential is exact and the adaptive branch applies too
        complete = K >= self.m or float(fact.beta) <= self.eps
        if complete:
            # --- full subspace, adaptive Δτ (reference :178-236) ---
            atmax = self.numiter >= alg.maxiter
            dtau = (tau - tau0) if atmax else torch.minimum(self.dtau, tau - tau0)
            if not atmax and self.finite:
                self.dtaumin = (tau - tau0) / max(alg.maxiter - self.numiter + 1, 1)
            dtaumin = self.dtaumin
            expH, eps_, omega = self.trial(dtau)
            q = real(K) / 2
            it = 0
            while not atmax and omega >= 1.0 and dtau > dtaumin and it < 64:
                dtau_prev, eps_prev = dtau, eps_
                dtau = torch.maximum(dtau * (0.8 / omega) ** (1 / (q + 1)), dtaumin)
                expH, eps_, omega = self.trial(dtau)
                q = torch.clamp(torch.log(eps_ / eps_prev) / torch.log(dtau / dtau_prev) - 1,
                                min=0.0)
                it += 1
            self.take_step(expH, dtau)
            self.totalerr = self.totalerr + eps_
            self.tau0 = tau if atmax else tau0 + dtau
            # grow Δτ for the next cycle; the cap keeps an exact step (ω = 0)
            # from pushing Δτ to Inf
            if omega < 0.8:
                growth = (0.8 / torch.clamp(omega, min=1e-12)) ** (1 / (q + 1))
                dtau = dtau * torch.clamp(growth, max=1e3)
            self.dtau = dtau
        else:
            # --- partial subspace: attempt the remaining interval (:237-258) ---
            dt = tau - tau0
            # with t = Inf the attempt evaluates exp(Inf·H): ω is NaN and the
            # step is always rejected, so it is not evaluated
            if (float(fact.beta) <= rem_eta or alg.eager) and self.finite:
                expH, eps_, omega = self.trial(dt)
                if omega < 1.0:
                    self.take_step(expH, dt)
                    self.totalerr = self.totalerr + eps_
                    self.tau0 = tau

        self.done = bool(self.tau0 >= tau)
        # --- restart if not finished and the subspace is complete ---
        return not self.done and complete

    def after_restart(self) -> None:
        """A fixed point found at a restart exits before the reference
        increments ``numiter`` (``src/matrixfun/expintegrator.jl:299-304``
        returns, ``:319`` is the increment)."""
        if self.fixedpt:
            self.done = True
        else:
            self.numiter += 1

    def result(self):
        """``(y, info)`` with the closing log and warning."""
        alg = self.alg
        log_if(
            alg.verbosity, STARTSTOP,
            "expintegrate finished after {it} iterations: total error = {err}, "
            "numops = {no}", it=self.numiter, err=self.totalerr, no=self.numops,
        )
        warn_if(
            alg.verbosity,
            not self.fixedpt and bool(self.totalerr > self.maxerr),
            WARNING, it=self.numiter, err=self.totalerr,
        )
        return self.w[0], self.info()

    def info(self) -> ConvergenceInfo:
        return ConvergenceInfo(
            converged=int(self.fixedpt or bool(self.totalerr <= self.maxerr)),
            residual=None,
            normres=self.beta0 if self.fixedpt else self.totalerr.to(self.dev),
            numiter=self.numiter,
            numops=self.numops,
        )


WARNING = ("expintegrate did not reach sufficiently small error after {it} "
           "iterations: total error = {err}")


def _expintegrator_core(op: LinearOperator, t, u: tuple, alg, space: VectorSpace):
    s = _Integrator(op, t, u, alg, space)
    m = s.m

    def build_w():
        for j in range(s.p):
            s.add_w(j, op.normal(s.w[j]))
        s.start_cycle()

    def expand_one(fact):
        if isinstance(alg, Lanczos):
            return kf.expand_hermitian(op.normal, fact, alg.orth, space,
                                       verbosity=alg.verbosity)
        return kf.expand(op.normal, fact, alg.orth, space, alg.verbosity)

    build_w()
    # immediate fixed point (reference :127-135), reported with numiter = 0
    # (":163: ConvergenceInfo(1, …, 0, numops)")
    if s.fixedpt:
        s.done = True
        s.numiter = 0

    while not s.done:
        # --- expand to krylovdim (or breakdown / small residual / eager) ---
        rem_eta = s.rem_eta()
        if s.fact.k < m and float(s.fact.beta) > 0:
            if s.fused:
                # the unfused pair below runs while β > max(eps, (τ−τ₀)·η);
                # min_one: after a rejected partial attempt the loop re-enters
                # with β within that bound and an unnormalized last row, and
                # must still take its one step
                s.fact, s.sc, dops = kf.fused_expansions(
                    op, s.fact, s.sc, m, max(s.eps, rem_eta), space,
                    hermitian=True, min_one=True, dgks=s.dgks,
                )
                s.numops += dops
            else:
                s.fact = expand_one(s.fact)
                s.numops += 1
        if not s.fused:
            while s.fact.k < m and not (alg.eager and s.fact.k >= 1):
                b = float(s.fact.beta)
                # stop once the factorization residual covers the remaining
                # interval's error budget (reference :237)
                if not b > s.eps or b <= rem_eta:
                    break
                s.fact = expand_one(s.fact)
                s.numops += 1
        if s.after_expansion(rem_eta):
            s.w = s.w[:1]
            build_w()
            s.after_restart()
    return s.result()
