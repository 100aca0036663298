"""Restarted GMRES(m) driver (counterpart of ``krylovkit_tpu/solvers/gmres.py``;
reference ``src/linsolve/gmres.jl``).

Per restart cycle: Arnoldi expansion of the residual's Krylov space,
incremental QR of the shifted Hessenberg ``R = a0·I + a1·H`` via Givens
rotations, masked triangular solve, update ``x += V y``.  The loops are
eager on the host with ``int`` counters; each step reads one or two scalars
from the device for its loop test.

As in the JAX package:

* previous rotations are accumulated in a dense ``(m+1, m+1)`` unitary ``G``,
  so applying them to a new column is one matrix-vector product;
* the end-of-cycle residual is reconstructed as ``V · (Gᴴ e_k ỹ_k)``, one
  unproject, and the true residual is recomputed when the reconstructed one
  converges (``src/linsolve/gmres.jl:120-124``);
* for fusable stencil operators (float32 ``StencilOperator`` /
  ``GridStencilOperator`` with ``(R, 128)`` vectors under ``cgs``, or
  ``cgs2`` when ``2(m+1)+2 <= 128``) the Arnoldi expansion runs the
  one-stream fused kernel (``ops/fused_lanczos.py``) through the shared
  stepper, with the Givens QR carried through the fused loop, so the
  per-column convergence test is kept.  The Krylov space of ``a0 + a1·A`` is
  that of ``A``: the kernel streams the raw stencil and the shift enters only
  the small column.

``b`` and ``x0`` may be pytree vectors (``ops/vector.py``); the fused cycle
takes one tensor only.
"""

from __future__ import annotations

import torch

from ..algorithms import GMRES
from ..dense.givens import givens
from ..dense.triangular import solve_upper_active
from ..factorizations import krylov as kf
from ..info import STARTSTOP, ConvergenceInfo, log_if, warn_if
from ..ops import basis as bs
from ..ops import orthonormal as on
from ..ops.operator import LinearOperator, apply_shifted, probe_dtype
from ..ops.vector import STANDARD, VectorSpace, add, astype, device_of, rounded

__all__ = ["linsolve_gmres"]


def _rot2(v, i: int, j: int, gc, gs):
    """Apply the Givens rotation ``(gc, gs)`` to entries ``(i, j)`` of ``v``,
    in place."""
    vi, vj = gc * v[i] + torch.conj(gs) * v[j], -gs * v[i] + gc * v[j]
    v[i], v[j] = vi, vj
    return v


def _qr_update(G, R, y, col, k: int):
    """One incremental-QR column update, in place: rotate ``col`` (the
    shifted H column ``k``) by the accumulated rotations ``G``, compute and
    apply the new Givens pair zeroing entry ``k+1``, update ``(G, R, y)``.
    Shared by the unfused and fused cycles (reference
    ``src/linsolve/gmres.jl:72-99``)."""
    col = G @ col  # apply all previous rotations: one GEMV
    gc, gs, grr = givens(col[k], col[k + 1])
    col[k], col[k + 1] = grr, 0
    _rot2(y, k, k + 1, gc, gs)
    _rot2(G, k, k + 1, gc, gs)  # rows k, k+1 of G
    R[:, k] = col
    return G, R, y


def linsolve_gmres(op: LinearOperator, b, x0, a0, a1, alg: GMRES,
                   space: VectorSpace = STANDARD):
    m = alg.krylovdim
    dev = device_of(b)
    cdt = probe_dtype(op, b)
    for a in (a0, a1):
        # a 0-d tensor promotes fully; a Python number only widens the kind
        cdt = torch.result_type(torch.empty((), dtype=cdt), a)
    rdt = cdt.to_real()
    tol = rounded(alg.tol, rdt)
    a0c = torch.as_tensor(a0, dtype=cdt, device=dev)
    a1c = torch.as_tensor(a1, dtype=cdt, device=dev)

    def shifted(x):
        return apply_shifted(op, x, a0c, a1c)

    def onehot(i: int):
        e = torch.zeros(m + 1, dtype=cdt, device=dev)
        e[i] = 1
        return e

    # loop-carried vectors have the (possibly promoted) coefficient dtype
    x = astype(x0, cdt)
    r = astype(add(b, shifted(x), a=-1), cdt)
    normr = space.norm(r)

    dgks = type(alg.orth) is on.ClassicalGramSchmidt2 and 2 * (m + 1) + 2 <= 128
    fused = (
        (type(alg.orth) is on.ClassicalGramSchmidt or dgks)
        and cdt == torch.float32
        and kf.fused_available(op, b, space, kmax=m + 1)
    )

    def start(r, normr):
        fact = kf.initialize(r, m, cdt, space, vec_dtype=cdt)
        G = torch.eye(m + 1, dtype=cdt, device=dev)
        R = torch.zeros((m + 1, m + 1), dtype=cdt, device=dev)
        return fact, G, R, normr.to(cdt) * onehot(0)

    def run_cycle_unfused(r, normr, numops):
        fact, G, R, y = start(r, normr)
        while fact.k < m and float(torch.abs(y[fact.k])) > tol:
            k = fact.k  # column index produced by this step
            fact = kf.expand(op.normal, fact, alg.orth, space, alg.verbosity)
            col = a1c * fact.H[:, k] + a0c * onehot(k)
            G, R, y = _qr_update(G, R, y, col, k)
            numops += 1
        return fact.V, kf.fused_scales_init(m + 1, device=dev), G, R, y, fact.k, numops

    def run_cycle_fused(r, normr, numops):
        """Fused Arnoldi cycle on the shared one-stream stepper
        (``kf.make_fused_stepper``): basis rows stored unnormalized with the
        ``FusedScales`` bookkeeping (dgks mode = one-reduce CGS2 for the
        default ``cgs2``).  One extra operator application may occur on
        early convergence (the kernel computes ``A·row_{k+1}`` while column
        ``k`` is being judged); it is counted in ``numops``, as is the
        priming apply."""
        kmax = m + 1
        btol = float(torch.tensor(torch.finfo(rdt).eps, dtype=rdt) ** 0.75)
        fact, G, R, yt = start(r, normr)
        prime, advance, tail = kf.make_fused_stepper(op, kmax, dgks, space)
        carry = prime(fact.V, 0, kf.fused_scales_init(kmax, device=dev))
        numops += 1  # priming apply

        def shifted_col(h, beta_k, k):
            # shifted Hessenberg column: a1·(h + β e_{k+1}) + a0·e_k
            return a1c * (h.to(cdt) + beta_k.to(cdt) * onehot(k + 1)) + a0c * onehot(k)

        while True:
            k = carry.k
            resk, qnorm = torch.stack([torch.abs(yt[k]), torch.sqrt(carry.q)]).tolist()
            live = resk > tol and qnorm > btol
            if not (k < m - 1 and live):
                break
            carry, _, beta_k, h = advance(carry)
            G, R, yt = _qr_update(G, R, yt, shifted_col(h, beta_k, k), k)
            numops += 1
        # tail column m-1: no (wasted) next apply
        go = k == m - 1 and live
        V, sc, _, beta_m, h = tail(carry, go)
        if go:
            G, R, yt = _qr_update(G, R, yt, shifted_col(h, beta_m, k), k)
            k += 1
        return V, sc, G, R, yt, k, numops

    run_cycle = run_cycle_fused if fused else run_cycle_unfused
    numiter, numops = 0, 1
    done = float(normr) <= tol
    while not done:
        V, sc, G, R, yv, k, numops = run_cycle(r, normr, numops)
        # triangular solve on the active k×k block
        coeff = solve_upper_active(R[:m, :m], yv[:m], k)
        coeff = torch.cat([coeff, torch.zeros(1, dtype=cdt, device=dev)])
        # fused cycles store rows unnormalized: fold the bookkeeping into
        # every basis use (identity when unfused)
        x = add(x, bs.unproject(V, kf.fold_scales(sc, coeff)))
        # residual reconstruction: r = V · (Gᴴ e_k · ỹ_k)
        yk = yv[k]
        rc = torch.conj(G.T) @ (yk * onehot(k))
        r = bs.unproject(V, kf.fold_scales(sc, rc))
        normr = torch.abs(yk)
        numiter += 1
        nr = float(normr)
        if nr <= tol:
            # true-residual verification on apparent convergence
            r = add(b, shifted(x), a=-1)
            normr = space.norm(r)
            numops += 1
            nr = float(normr)
        done = nr <= tol or numiter >= alg.maxiter
    conv = int(float(normr) <= tol)
    log_if(
        alg.verbosity, STARTSTOP,
        "GMRES linsolve finished after {it} restarts: converged = {c}, "
        "normres = {nr}, numops = {no}",
        it=numiter, c=conv, nr=normr, no=numops,
    )
    warn_if(
        alg.verbosity, conv == 0,
        "GMRES linsolve stopped without converging after {it} iterations: "
        "normres = {nr}", it=numiter, nr=normr,
    )
    info = ConvergenceInfo(converged=conv, residual=r, normres=normr,
                           numiter=numiter, numops=numops)
    return x, info
