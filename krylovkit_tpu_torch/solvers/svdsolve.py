"""Partial SVD by GKL bidiagonalization with Krylov-Schur thick restart
(counterpart of ``krylovkit_tpu/solvers/svdsolve.py``).

The reference solver (``src/eigsolve/svdsolve.jl``): GKL expansion, SVD of
the projected matrix (``dense.svd_active``; the reference's LAPACK ``bdsqr``,
``src/dense/linalg.jl:123-130``), convergence on ``|β·Q[k-1, i]|``
(``src/eigsolve/svdsolve.jl:198-210``), and a thick restart keeping
``(3·krylovdim + 2·nconv) ÷ 5`` triplets.  As in the JAX package the restart
writes a broken-arrow projected matrix (``factorizations/gkl.py``) with one
rotation per basis, instead of restoring the bidiagonal form with Householder
sweeps (``src/eigsolve/svdsolve.jl:231-274``).

``which`` is ``"LR"`` or ``"SR"``: largest or smallest singular values (the
reference errors on anything else, ``src/eigsolve/svdsolve.jl:137-142``).

The loops are eager Python on the host over device tensors; ``k``, ``keep``,
``nconv`` and the counters are host ``int``s.  Reads from the device: ``β``
once per expansion step (the loop test) and ``nconv`` once per processing
round.  Square real float32 stencil operators with ``(R, 128)`` vectors run
the one-stream fused expansion over both bases (``gf.fused_expansions``).
When gradients are enabled and ``x0`` or a tensor the operator holds
requires grad, the front-end goes through the differentiable
``ad.svdsolve_vjp`` (backward with ``alg_rrule``).  Vectors may be
pytrees (``ops/vector.py``), with a domain tree that differs from the
codomain tree; they take the unfused expansion.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import dense
from ..algorithms import GKL
from ..factorizations import gkl as gf
from ..factorizations import krylov as kf
from ..info import STARTSTOP, ConvergenceInfo, log_if, warn_if
from ..ops import basis as bs
from ..ops import orthonormal as on
from ..ad._common import needs_grad
from ..ops.operator import (
    LinearOperator,
    as_operator,
    probe_adjoint,
    require_adjoint,
    resolve_device,
)
from ..ops.vector import (REAL, STANDARD, VectorSpace, device_of, rounded,
                          scalartype, tree_leaves, tree_map)

__all__ = ["svdsolve", "realsvdsolve", "svdsolve_gkl"]


@dataclass
class _LoopState:
    fact: gf.GKLState
    numiter: int
    numops: int
    nconv: int
    svals: torch.Tensor  # (m+1,) sorted singular values
    P: torch.Tensor  # (m+1, m+1) sorted left singular vectors of the projected B
    Q: torch.Tensor  # (m+1, m+1) sorted right singular vectors of the projected B
    resnorms: torch.Tensor
    scU: kf.FusedScales  # codomain basis bookkeeping (identity unless fused)
    scV: kf.FusedScales  # domain basis bookkeeping


def _process(B, k: int, beta, which, tol: float):
    """Projected SVD + sort + convergence count: ``(nconv, s, P, Q, res)``."""
    s, P, Vh, valid = dense.svd_active(B, k)
    Q = Vh.conj().T
    perm = dense.sort_perm(s, valid, which)
    s, P, Q, valid = s[perm], P[:, perm], Q[:, perm], valid[perm]
    res = torch.abs(beta * Q[max(k - 1, 0)])
    res = torch.where(valid, res, torch.full_like(res, float("inf")))
    flags = (res <= tol).to(torch.int64)
    nconv = int(torch.sum(torch.cumprod(flags, 0)))
    return nconv, s, P, Q, res


def _restart_rotations(fact: gf.GKLState, svals, P, Q, beta, keep: int, gate=None,
                       scales=None):
    """The thick restart's rotations ``(U rotation, V rotation)`` of the
    stored rows and the restarted state (its bases not yet rotated): the
    broken-arrow form of size ``keep``, ``A Ṽ = Ũ Σ + β u_k Q[k-1, :]``
    (``factorizations/gkl.py``).  With ``gate`` false both rotations are
    the identity and ``B``/``k`` keep their values (the JAX package's masked
    restart).  ``scales = (L_U, L_V)`` of the fused mode fold into the
    rotations."""
    U, V, B, k = fact.U, fact.V, fact.B, fact.k
    m1 = B.shape[0]
    dev = B.device
    if gate is not None and not gate:
        eye = torch.eye(m1, dtype=P.dtype, device=dev)
        return eye, eye, gf.GKLState(U, V, B, k, beta)
    rows = torch.arange(m1, device=dev)[:, None]
    cols = torch.arange(m1, device=dev)[None, :]
    keepmask = (cols < keep) & (rows < k)
    zero = torch.zeros((), dtype=P.dtype, device=dev)
    # domain basis: the kept right singular vectors
    Qkeep = torch.where(keepmask, Q, zero)
    if scales is not None:
        # stored rows are raw (v_j = Σ_i L[i,j]·row_i): the rotation acting on
        # stored rows is L·Q, resp. L·P
        Qkeep = scales[1].to(Q.dtype) @ Qkeep
    # codomain basis: the kept left singular vectors + the old residual u_k
    # at slot ``keep``
    Pkeep = torch.where(keepmask, P, zero)
    Pkeep[k, keep] += 1
    if scales is not None:
        Pkeep = scales[0].to(P.dtype) @ Pkeep
    # projected matrix: diag(σ[:keep]) + spike row at ``keep``
    didx = torch.arange(m1, device=dev)
    zb = torch.zeros((), dtype=B.dtype, device=dev)
    Bnew = torch.diag(torch.where(didx < keep, svals.to(B.dtype), zb))
    Bnew[keep, :] += torch.where(didx < keep, (beta * Q[max(k - 1, 0)]).to(B.dtype), zb)
    return Pkeep, Qkeep, gf.GKLState(U, V, Bnew, keep, beta)


def _restart(fact: gf.GKLState, svals, P, Q, beta, keep: int, keep_max: int,
             gate=None, scales=None) -> gf.GKLState:
    """Thick restart (:func:`_restart_rotations`) with both bases rotated.

    With ``gate`` false both rotations are the identity and ``B``/``k`` keep
    their values: the transforms still run, as in the JAX package's masked
    restart, and leave both bases bit-identical.  Mirrors
    ``lanczos._restart``."""
    Prot, Qrot, fact = _restart_rotations(fact, svals, P, Q, beta, keep, gate, scales)
    Vnew = bs.transform_partial(fact.V, Qrot, keep_max + 1)
    Unew = bs.transform_partial(fact.U, Prot, keep_max + 1)
    return gf.GKLState(Unew, Vnew, fact.B, fact.k, beta)


def _check(howmany: int, m: int, which):
    if howmany > m:
        raise ValueError(f"howmany={howmany} exceeds krylovdim={m}")
    w = which.upper() if isinstance(which, str) else which
    if w not in ("LR", "SR"):
        raise ValueError(
            "svdsolve accepts which in ('LR', 'SR') — singular values are "
            "real nonnegative (reference src/eigsolve/svdsolve.jl:137-142)"
        )


def _tolerances(alg: GKL, cdt):
    """``(tol, btol)``: the convergence bound rounded to the real type and
    the breakdown bound ``eps^0.75``."""
    rdt = cdt.to_real()
    return rounded(alg.tol, rdt), float(torch.tensor(torch.finfo(rdt).eps, dtype=rdt) ** 0.75)


def _fused(alg: GKL, cdt, op, x0, space, m1: int) -> bool:
    """Whether the solve runs the fused one-stream GKL kernels
    (``factorizations/gkl.py``): square fusable stencils under either
    cgs-family orthogonalizer (the kernel path always runs the immediate
    scalar-space DGKS correction: cgs2 orthogonality)."""
    return (
        not alg.eager
        and type(alg.orth) in (on.ClassicalGramSchmidt, on.ClassicalGramSchmidt2)
        and cdt == torch.float32
        and gf.fused_kernel_available(op, x0, space, m1)
    )


def _loop_state(fact: gf.GKLState, m1: int, cdt, dev) -> _LoopState:
    rdt = cdt.to_real()
    return _LoopState(
        fact=fact, numiter=0, numops=0, nconv=0,
        svals=torch.zeros(m1, dtype=rdt, device=dev),
        P=torch.zeros((m1, m1), dtype=cdt, device=dev),
        Q=torch.zeros((m1, m1), dtype=cdt, device=dev),
        resnorms=torch.full((m1,), float("inf"), dtype=rdt, device=dev),
        scU=kf.fused_scales_init(m1, device=dev),
        scV=kf.fused_scales_init(m1, device=dev),
    )


def _keep_max(m: int, howmany: int) -> int:
    """Static bound on ``keep``: a restart implies ``nconv < howmany`` and
    ``k == m``."""
    return min((3 * m + 2 * max(howmany - 1, 0)) // 5, m - 1)


def _round(fact: gf.GKLState, numiter: int, which, tol: float, btol: float, howmany: int,
           alg: GKL):
    """The host half of one round: the projected SVD and the decisions.
    Returns ``(nconv, svals, P, Q, res, numiter, done, keep, restart_now)``."""
    m = alg.krylovdim
    nconv, svals, P, Q, res = _process(fact.B, fact.k, fact.beta, which, tol)
    full = fact.k >= m
    numiter = numiter + int(full)
    # ¬(β > btol): a NaN β counts as breakdown (see lanczos.py)
    stalled = not (float(fact.beta) > btol) and fact.k < m
    done = nconv >= howmany or (full and numiter >= alg.maxiter) or stalled
    keep = min(max((3 * m + 2 * nconv) // 5, 1), max(fact.k - 1, 1))
    restart_now = not done and fact.k >= m
    return nconv, svals, P, Q, res, numiter, done, keep, restart_now


def _reseeded(fact: gf.GKLState, m1: int, dev):
    """The fused scales after a restart: a restart renormalizes both bases,
    and the broken-arrow buffer seeds the stored-row images (A V = U·B,
    Aᴴ U = V·Bᵀ exactly).  Returns ``(scU, scV)``."""
    Bs = torch.real(fact.B).to(torch.float32)
    return (dataclasses.replace(kf.fused_scales_init(m1, device=dev), Hs=Bs.T),
            dataclasses.replace(kf.fused_scales_init(m1, device=dev), Hs=Bs))


FINISHED = ("GKL svdsolve finished after {it} iterations: {nc} values converged, "
            "normres = {nr}")


def _unconverged(howmany: int) -> str:
    return ("GKL svdsolve finished without convergence: {nc} of "
            f"{howmany}" + " values converged after {it} iterations")


def _extract(st: _LoopState, howmany: int, cdt):
    """``(vals, lvecs, rvecs, info)`` of :func:`svdsolve_gkl` from its final
    loop state."""
    fact = st.fact
    k = fact.k
    m1 = fact.B.shape[0]
    dev = fact.B.device
    rows = torch.arange(m1, device=dev)[:, None]
    cols = torch.arange(m1, device=dev)[None, :]
    hm = (rows < k) & (cols < howmany)
    zero = torch.zeros((), dtype=cdt, device=dev)
    # u_k (the residual direction) before anything rotates U
    uk = bs.unproject_bucketed(fact.U, st.scU.L[:, k].to(cdt), k + 1)
    lvecs = _leading(bs.transform(fact.U, kf.fold_scales(st.scU, torch.where(hm, st.P, zero))),
                     howmany)
    rvecs = _leading(bs.transform(fact.V, kf.fold_scales(st.scV, torch.where(hm, st.Q, zero))),
                     howmany)
    # residuals r_i = β·Q[k-1, i]·u_k  (= A ṽ_i − σ_i ũ_i)
    s = fact.beta * st.Q[max(k - 1, 0)]
    residuals = tree_map(lambda l: s[:howmany].reshape((howmany,) + (1,) * l.ndim) * l[None], uk)
    info = ConvergenceInfo(
        converged=min(st.nconv, howmany),
        residual=residuals,
        normres=st.resnorms[:howmany],
        numiter=max(st.numiter, 1),
        numops=st.numops,
    )
    return st.svals[:howmany], lvecs, rvecs, info


def svdsolve_gkl(op: LinearOperator, x0, howmany: int, which, alg: GKL,
                 space: VectorSpace = STANDARD):
    """Partial SVD on ``x0``'s device: ``(vals, lvecs, rvecs, info)``
    (reference GKL solver, ``src/eigsolve/svdsolve.jl:144-314``)."""
    m = alg.krylovdim
    _check(howmany, m, which)
    # x0 lives in the codomain: the scalar type comes through the adjoint
    cdt = scalartype(probe_adjoint(op, x0), x0)
    tol, btol = _tolerances(alg, cdt)
    dev = device_of(x0)

    # a complex map and a real x0: the bases take the map's type (the JAX
    # package keeps x0's and drops the imaginary part of Aᴴ u)
    promote = cdt.is_complex and not scalartype(x0).is_complex
    fact = gf.initialize(op, x0, m, cdt, space, vec_dtype=cdt if promote else None,
                         verbosity=alg.verbosity)
    m1 = m + 1
    fused = _fused(alg, cdt, op, x0, space, m1)
    st = _loop_state(fact, m1, cdt, dev)
    keep_max = _keep_max(m, howmany)

    done = False
    while not done:
        fact, numops, scU, scV = st.fact, st.numops, st.scU, st.scV
        if fused:
            fact, scU, scV, dops = gf.fused_expansions(op, fact, scU, scV, m, btol, space)
            numops += dops
        else:
            j = 0
            while fact.k < m and float(fact.beta) > btol:
                if alg.eager and not (j == 0 or fact.k < max(howmany, 1)):
                    break
                fact = gf.expand(op, fact, alg.orth, space, alg.verbosity)
                numops += 2
                j += 1

        nconv, svals, P, Q, res, numiter, done, keep, restart_now = _round(
            fact, st.numiter, which, tol, btol, howmany, alg)
        if alg.eager:
            if restart_now:
                fact = _restart(fact, svals, P, Q, fact.beta, keep, keep_max)
        else:
            # every processing but the last restarts; the last one runs the
            # identity rotations (the JAX package's masked restart)
            fact = _restart(fact, svals, P, Q, fact.beta, keep, keep_max, gate=restart_now,
                            scales=(scU.L, scV.L) if fused else None)
        if restart_now and fused:
            scU, scV = _reseeded(fact, m1, dev)
        st = _LoopState(fact, numiter, numops, nconv, svals, P, Q, res, scU, scV)

    nconv_out = min(st.nconv, howmany)
    log_if(alg.verbosity, STARTSTOP, FINISHED, it=st.numiter, nc=nconv_out,
           nr=st.resnorms[:howmany])
    warn_if(alg.verbosity, nconv_out < howmany, _unconverged(howmany), nc=nconv_out,
            it=st.numiter)
    return _extract(st, howmany, cdt)


def _leading(V, howmany: int):
    """The first ``howmany`` rows of a basis, as tensors of their own."""
    return tree_map(lambda l: l[:howmany].clone(), V)


def _default_x0(A, x0):
    if x0 is not None:
        return x0
    if isinstance(A, (np.ndarray, torch.Tensor)) and A.ndim == 2:
        # start in range(A): a component in the left null space can never be
        # removed by the GKL recurrence and stalls "SR" convergence (the
        # reference's tests start from A[:, 1] for the same reason,
        # test/svdsolve.jl:13)
        if not isinstance(A, torch.Tensor):
            A = torch.as_tensor(A, device=resolve_device("cuda"))
        v = np.random.default_rng(42).standard_normal(A.shape[1])
        return A @ torch.as_tensor(v, device=A.device).to(A.dtype.to_real()).to(A.dtype)
    raise ValueError("x0 is required unless the operator is a concrete matrix")


def svdsolve(
    A,
    x0=None,
    howmany: int = 1,
    which="LR",
    *,
    alg: Optional[GKL] = None,
    space: VectorSpace = STANDARD,
    tol: Optional[float] = None,
    krylovdim: Optional[int] = None,
    maxiter: Optional[int] = None,
    orth=None,
    eager: Optional[bool] = None,
    verbosity: Optional[int] = None,
    alg_rrule=None,
):
    """Find ``howmany`` extremal singular triplets of a linear map.

    Returns ``(vals, lvecs, rvecs, info)`` on the device of ``x0``, which
    lives in the **codomain** (left side) of the map (reference ``svdsolve``,
    ``src/eigsolve/svdsolve.jl:1-142``); it is a tensor or a pytree of them.  ``A`` is a matrix (tensor, or numpy
    array placed on ``x0``'s device), a ``LinearOperator``, an ``(f,
    fadjoint)`` tuple or a bare callable, whose adjoint is derived by
    ``with_adjoint_from`` on ``x0`` (a square map, as in the JAX package).

    Differentiable in the tensors the operator holds (``x0`` gets a zero
    gradient): the backward runs ``alg_rrule``, by default ``GMRES`` with
    the primal's settings; an ``Arnoldi`` ``alg_rrule`` (``which="LR"``)
    takes the Sylvester route."""
    x0 = _default_x0(A, x0)
    # an (f, fadjoint) pair from the caller meets the consistency guard at
    # the start (reference src/factorizations/gkl.jl:192).  As in the JAX
    # package the guard runs in the standard inner product, whatever the
    # solve's: under realsvdsolve it refuses the real adjoint of an R-linear
    # map
    op = require_adjoint(as_operator(A, device=device_of(x0)), x0)
    # Cap the Krylov dimension at the domain dimension: beyond it the domain
    # sweep breaks down (α → 0) with nothing left to find.  The codomain side
    # needs no cap: β → 0 there is caught by the breakdown guard.
    domain_dim = sum(l.numel() for l in tree_leaves(probe_adjoint(op, x0)))
    if space.psum_axis is not None:
        # x0 is this rank's block: the domain is split over the axis too
        domain_dim *= space.psum_axis.size
    if alg is None:
        kw = dict(
            tol=tol, krylovdim=krylovdim, maxiter=maxiter, orth=orth,
            eager=eager, verbosity=verbosity,
        )
        alg = GKL(**{k: v for k, v in kw.items() if v is not None})
    elif tol is not None and alg.tol != tol:
        alg = dataclasses.replace(alg, tol=tol)
    if alg.krylovdim > domain_dim:
        alg = dataclasses.replace(alg, krylovdim=domain_dim)
    if needs_grad(op, x0):
        from ..ad.svdsolve import svdsolve_vjp

        return svdsolve_vjp(howmany, which, alg, alg_rrule, space, op, x0)
    return svdsolve_gkl(op, x0, howmany, which, alg, space)


def realsvdsolve(A, x0=None, howmany: int = 1, which="LR", **kw):
    """``svdsolve`` over the real inner product (R-linear maps on complex
    vectors; cf. reference ``reallssolve``/``RealVec``,
    ``src/KrylovKit.jl:243-256``)."""
    space = kw.pop("space", None)
    if space is None:
        space = REAL
    elif not space.real_inner:
        space = dataclasses.replace(space, real_inner=True)
    return svdsolve(A, x0, howmany, which, space=space, **kw)
