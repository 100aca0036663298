"""Least-squares solver: LSMR on GKL bidiagonalization (counterpart of
``krylovkit_tpu/solvers/lssolve.py``).

The reference solver (``src/lssolve/lsmr.jl``): Fong & Saunders LSMR with the
double plane-rotation recurrence, Tikhonov regularization ``λ`` (rotation
``P̂``, ``src/lssolve/lsmr.jl:93-113``), reorthogonalization of each new
``v`` against a ring buffer of the last ``krylovdim`` vectors
(``src/lssolve/lsmr.jl:76-89``), and a running residual vector ``r`` kept
through ``Ah̄`` updates (``src/lssolve/lsmr.jl:117-120``): no operator
application is spent on the residual.

Convergence measure: ``‖Aᴴ(b − A x) − λ² x‖ = |ζ̄|``, the gradient of the
regularized objective (``src/lssolve/lsmr.jl:123-141``).

The loop is eager Python on the host; the rotations stay 0-d device tensors
and each iteration reads two scalars for its tests (``β`` and ``|ζ̄|``; ``α``
too when ``β`` passes).  It runs no hand-written kernel unless
``ops.basis.use_pallas_projections`` routes the ring sweep to the projection
kernels.  It has no differentiation rule (nor has the JAX package's
``lssolve``), so it refuses an input that requires grad.  ``b`` and ``x``
may be pytrees (``ops/vector.py``), each with the tree of its side of the
map.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..algorithms import LSMR
from ..info import STARTSTOP, ConvergenceInfo, log_if, warn_if
from ..ops import basis as bs
from ..ops import orthonormal as on
from ..ad._common import refuse_grad
from ..ops.operator import (
    LinearOperator,
    as_operator,
    probe_adjoint,
    require_adjoint,
)
from ..ops.vector import (REAL, STANDARD, VectorSpace, add, astype, device_of, rounded,
                          scalartype, tree_map, zerovector)
from .linsolve import _resolve_tol

__all__ = ["lssolve", "reallssolve", "lssolve_lsmr"]


def _div(x, s):
    """``x / s`` leaf by leaf."""
    return tree_map(lambda l: l / s, x)


class _Rotations(NamedTuple):
    """The scalars the plane rotations carry from one LSMR step to the next
    (0-d tensors, or ``(P,)`` ones for a batch)."""

    alphabar: torch.Tensor
    zetabar: torch.Tensor
    rho: torch.Tensor
    theta: torch.Tensor
    rhobar: torch.Tensor
    cbar: torch.Tensor
    sbar: torch.Tensor


def _rotations(rot: _Rotations, alpha, beta, lamr, hypot=torch.hypot):
    """The three plane rotations of one step (``P̂`` for the
    λ-regularization, ``P`` from bidiagonal to ``R``, ``P̄`` from ``Rᵀ`` to
    ``R̄``, reference ``src/lssolve/lsmr.jl:93-113``): ``(rot', c1, c2)``
    with ``c1 = θ̄ρ/(ρ_old ρ̄_old)`` and ``c2 = ζ/(ρ ρ̄)``, the coefficients
    of the ``h̄``/``x`` updates.  Elementwise, so a batch's row is its
    one-problem step's; ``hypot`` is the one a batch takes on the CPU."""
    # rotation P̂ (λ-regularization)
    alphahat = hypot(rot.alphabar, lamr)
    # rotation P: bidiagonal → R
    rho = hypot(alphahat, beta)
    c = alphahat / rho
    s = beta / rho
    theta = s * alpha
    alphabar = c * alpha
    # rotation P̄: Rᵀ → R̄
    thetabar = rot.sbar * rho
    crho = rot.cbar * rho
    rhobar = hypot(crho, theta)
    cbar = crho / rhobar
    sbar = theta / rhobar
    zeta = cbar * rot.zetabar
    zetabar = -sbar * rot.zetabar
    c1 = thetabar * rho / (rot.rho * rot.rhobar)
    c2 = zeta / (rho * rhobar)
    return _Rotations(alphabar, zetabar, rho, theta, rhobar, cbar, sbar), c1, c2


def _start_rotations(alpha, beta) -> _Rotations:
    """The rotations' scalars before the first step."""
    one = torch.ones_like(alpha)
    return _Rotations(alpha, alpha * beta, one, torch.zeros_like(one), one, one,
                      torch.zeros_like(one))


FINISHED = ("LSMR lssolve finished at iteration {it}: converged = {c}, "
            "|| A^H(b - A x) - lam^2 x || = {nr}")
UNCONVERGED = ("LSMR lssolve finished without converging after {it} iterations: "
               "normres = {nr}")


def lssolve_lsmr(op: LinearOperator, b, alg: LSMR, lam=0.0,
                 space: VectorSpace = STANDARD):
    """Returns ``(x, info)`` minimizing ``‖b − A x‖² + λ²‖x‖²``, on ``b``'s
    device."""
    K = alg.krylovdim
    cdt = scalartype(probe_adjoint(op, b), b)
    rdt = cdt.to_real()
    dev = device_of(b)
    tol = rounded(alg.tol, rdt)
    lamr = torch.as_tensor(lam, device=dev).to(rdt)

    u = astype(b, cdt)
    beta = space.norm(u)
    u = _div(u, torch.where(beta > 0, beta, torch.ones_like(beta)).to(cdt))
    v = op.apply_adjoint(u)
    alpha = space.norm(v)
    v = _div(v, torch.where(alpha > 0, alpha, torch.ones_like(alpha)).to(cdt))

    V = bs.set(bs.alloc(v, K), 0, v)  # ring buffer of the last K v's

    x = zerovector(v)
    h, hbar = v, zerovector(v)
    r = tree_map(lambda l: beta.to(cdt) * l, u)
    Ah, Ahbar = zerovector(u), zerovector(u)
    rot = _start_rotations(alpha, beta)
    normres = torch.abs(rot.zetabar)
    numiter, numops = 0, 1
    done = float(normres) <= tol

    while not done:
        numiter += 1
        Av = op.normal(v)
        numops += 1
        # Ah_k = A v_k − (θ_k/ρ_{k−1}) Ah_{k−1}  (the h update of the last step)
        Ah = add(Av, Ah, a=-(rot.theta / rot.rho).to(cdt))

        # β_{k+1} u_{k+1} = A v_k − α_k u_k
        u = add(Av, u, a=-alpha.to(cdt))
        beta = space.norm(u)
        if float(beta) > tol:
            u = _div(u, beta.to(cdt))
            # α_{k+1} v_{k+1} = Aᴴ u_{k+1} − β_{k+1} v_k  (+ ring reorthogonalization)
            w = add(op.apply_adjoint(u), v, a=-beta.to(cdt))
            numops += 1
            if K > 1:
                w, _ = on.orthogonalize(w, V, min(K, numiter), alg.orth, space)
            alpha = space.norm(w)
            if float(alpha) > tol:
                w = _div(w, alpha.to(cdt))
                bs.set(V, numiter % K, w)
            v = w
        else:
            alpha = torch.zeros_like(rot.rho)

        rot, c1, c2 = _rotations(rot, alpha, beta, lamr)
        # vector updates
        coef1 = c1.to(cdt)
        hbar = add(h, hbar, a=-coef1)
        Ahbar = add(Ah, Ahbar, a=-coef1)
        coef2 = c2.to(cdt)
        x = add(x, hbar, a=coef2)
        r = add(r, Ahbar, a=-coef2)
        h = add(v, h, a=-(rot.theta / rot.rho).to(cdt))

        normres = torch.abs(rot.zetabar)
        done = float(normres) <= tol or numiter >= alg.maxiter

    conv = int(float(normres) <= tol)
    log_if(alg.verbosity, STARTSTOP, FINISHED, it=numiter, c=conv, nr=normres)
    warn_if(alg.verbosity, conv == 0, UNCONVERGED, it=numiter, nr=normres)
    info = ConvergenceInfo(
        converged=conv, residual=r, normres=normres, numiter=numiter, numops=numops,
    )
    return x, info


def lssolve(
    A,
    b,
    lam=0.0,
    *,
    alg: Optional[LSMR] = None,
    space: VectorSpace = STANDARD,
    atol: Optional[float] = None,
    rtol: Optional[float] = None,
    tol: Optional[float] = None,
    krylovdim: Optional[int] = None,
    maxiter: Optional[int] = None,
    orth=None,
    verbosity: Optional[int] = None,
):
    """Least-squares solve ``min ‖b − A x‖`` (optionally ``+ λ²‖x‖²``) on
    ``b``'s device.

    Returns ``(x, info)``; ``info.normres`` is the normal-equation residual
    ``‖Aᴴ(b − A x) − λ² x‖`` (reference ``lssolve``,
    ``src/lssolve/lssolve.jl:101-110``; tolerance ``max(atol, rtol·‖b‖)``).
    ``A`` as in ``svdsolve``: a bare callable gets its adjoint derived by
    ``with_adjoint_from`` on ``b`` (a square map)."""
    # an (f, fadjoint) pair from the caller meets the GKL adjoint-consistency
    # guard (reference src/factorizations/gkl.jl:192)
    op = require_adjoint(as_operator(A, device=device_of(b)), b, space)
    refuse_grad("lssolve", op, b, *(lam,) if isinstance(lam, torch.Tensor) else ())
    if tol is None and alg is not None and atol is None and rtol is None:
        # an explicit algorithm carries its own tol (see the linsolve front-end)
        tol = alg.tol
    tol = _resolve_tol(b, atol, rtol, tol, space)
    if alg is None:
        kw = dict(
            tol=tol, krylovdim=krylovdim, maxiter=maxiter, orth=orth,
            verbosity=verbosity,
        )
        alg = LSMR(**{k: v for k, v in kw.items() if v is not None})
    elif alg.tol != tol:
        alg = dataclasses.replace(alg, tol=tol)
    return lssolve_lsmr(op, b, alg, lam, space)


def reallssolve(A, b, lam=0.0, **kw):
    """``lssolve`` over the real inner product, for R-linear maps on complex
    vectors (reference ``reallssolve``, ``src/lssolve/lssolve.jl:190-197``)."""
    space = kw.pop("space", None)
    if space is None:
        space = REAL
    elif not space.real_inner:
        space = dataclasses.replace(space, real_inner=True)
    return lssolve(A, b, lam, space=space, **kw)
