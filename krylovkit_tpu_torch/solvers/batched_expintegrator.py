"""Batched φ-function integrator: ``P`` problems in one host loop (the
counterpart of ``jax.vmap`` over the JAX package's ``expintegrator`` core
and ``exponentiate``).

Each problem is one :class:`~.expintegrator._Integrator`: its own adaptive
``τ₀``/``Δτ``, step controller, step count, ``totalerr`` and fixed-point
exit, frozen once it is done.  Per cycle the problems that go on expand
together, as in ``solvers/batched.py``:

* the applies that build ``w`` at a restart run as one stack apply
  (``solvers/batched.py:_Operators``);
* on a fusable stencil operator with ``(R, 128)`` float32 vectors and a
  ``Lanczos`` algorithm, each step is one batched K1 launch
  (``factorizations/krylov.py:fused_expansions_batched`` in Hermitian
  ``min_one`` mode), every problem at its own bound ``max(eps, (τ−τ₀)·η)``;
* otherwise a step applies the operator to the stack once and
  orthonormalizes through ``factorizations/krylov.py:expand_batched`` (with
  ``ops/basis.py``'s projection flag on, one batched K5 and one batched K6
  launch per sweep);
* the host reads one list of the stepping problems' ``β`` per step, and the
  augmented exponential ``_phi_step`` runs per problem.

``t`` is shared or given per problem (``in_dims``).  A sharded space is
batched as in ``solvers/batched.py`` (the fused step with each problem's
halos, one all-reduce a lock-step).  Pytree vectors (each of ``u₀, u₁,
…`` a tree of one structure) take the unfused lock-step, leaf by leaf.
``eager=True`` takes the unfused lock-step: each problem of a cycle makes
one step and then attempts the remaining interval, as its one-problem
integration does.  Pytree vectors run
on a sharded space too; differentiation is refused (``ValueError``), as
``exponentiate`` and ``expintegrator`` have no rule in either package.
"""

from __future__ import annotations

import functools

import torch

from ..algorithms import Lanczos
from ..factorizations import krylov as kf
from ..info import STARTSTOP, ConvergenceInfo, log_if, warn_if
from ..ops.operator import probe_dtype
from ..ops.vector import (STANDARD, VectorSpace, alloc_batched, device_of, tree_row, tree_stack,
                          zerovector)
from .batched import _batch_size, _count, _differentiated, _Operators, _problems, _read
from .expintegrator import WARNING, _host_t, _Integrator

__all__ = ["expintegrator_batched", "exponentiate_batched"]


def _dims(in_dims, nu: int):
    """``(op_dim, t_dim, (u_dim per vector))`` from ``in_dims = (op, t,
    u)``, ``u`` one dim for every vector or a tuple of one per vector."""
    try:
        op_dim, t_dim, u_dims = in_dims
    except (TypeError, ValueError):
        raise ValueError(f"in_dims must be (op, t, u); got {in_dims}") from None
    u_dims = tuple(u_dims) if isinstance(u_dims, (tuple, list)) else (u_dims,) * nu
    dims = (op_dim, t_dim) + u_dims
    if len(u_dims) != nu or any(d not in (0, None) for d in dims) or 0 not in dims:
        raise ValueError(f"in_dims must give 0 or None for op, t and each of the {nu} "
                         f"vectors, at least one 0; got {in_dims}")
    return op_dim, t_dim, u_dims


def expintegrator_batched(op, t, u: tuple, alg, space: VectorSpace = STANDARD, *,
                          in_dims=(None, None, 0)):
    """``y_p = φ₀(t_p A_p)u₀ₚ + t_p·φ₁(t_p A_p)u₁ₚ + …`` for ``P`` problems,
    each as :func:`~.expintegrator.expintegrator` computes it with the
    algorithm ``alg`` (a ``Lanczos`` or an ``Arnoldi``), in one host loop.

    ``u`` is the tuple of vectors ``(u₀, u₁, …)``.  ``in_dims = (op_dim,
    t_dim, u_dim)``: ``op_dim = 0`` takes ``op`` as a sequence of ``P``
    operators, ``t_dim = 0`` takes ``t`` as ``P`` times, and ``u_dim`` (one
    for every vector, or a tuple of one per vector) names the vectors with a
    leading problem axis.  Returns ``(y (P, ...), info)`` with ``(P,)``
    int64 counts and ``normres``; at ``WARN`` each problem that missed its
    error bound prints its one-problem line, in problem order."""
    if not isinstance(u, tuple):
        u = (u,)
    op_dim, t_dim, u_dims = _dims(in_dims, len(u))
    what = "expintegrator_batched"
    P = _batch_size(_count(op, op_dim, "op", vector=False), _count(t, t_dim, "t", vector=False),
                    *[_count(ui, d, "u") for ui, d in zip(u, u_dims)])
    ops = _Operators(op, P, op_dim == 0)
    ts = _problems(t, t_dim, P, vector=False)
    _differentiated(what, u, ops.distinct(), ts)
    ts = [_host_t(tp) for tp in ts]
    us = [tuple(_problems(ui, d, P)[p] for ui, d in zip(u, u_dims)) for p in range(P)]
    if len(u) == 1:
        us = [(up[0], zerovector(up[0])) for up in us]
    kf.check_sharded_blocks(what, ops.distinct(), [up[0] for up in us], space)
    cdt = functools.reduce(torch.promote_types, [probe_dtype(o, us[0][0]) for o in ops.distinct()])
    if any(isinstance(tp, complex) and tp.imag != 0 for tp in ts):
        cdt = torch.promote_types(cdt, torch.complex64)
    m = alg.krylovdim
    dev = device_of(us[0][0])
    Vb = alloc_batched(us[0][0], P, m + 1, cdt)
    ints = [_Integrator(ops.ops[p], ts[p], us[p], alg, space, cdt, basis=tree_row(Vb, p))
            for p in range(P)]
    fused = ops.shared and ints[0].fused
    hermitian = isinstance(alg, Lanczos)
    eps = ints[0].eps

    def build_w(ps):
        """``w`` of each problem of ``ps`` from its ``w[0]``: ``p`` stack
        applies, then each problem's new cycle."""
        for j in range(ints[0].p):
            Aw = ops({q: ints[q].w[j] for q in ps})
            for q in ps:
                ints[q].add_w(j, Aw[q])
        for q in ps:
            ints[q].start_cycle()

    build_w(range(P))
    # immediate fixed point (reference :127-135), reported with numiter = 0
    for s in ints:
        if s.fixedpt:
            s.done, s.numiter = True, 0

    active = [p for p in range(P) if not ints[p].done]
    while active:
        rem = {p: ints[p].rem_eta() for p in active}
        betas = _read([ints[p].fact.beta for p in active])
        first = [p for p, b in zip(active, betas) if ints[p].fact.k < m and b > 0]
        if fused:
            if first:
                facts, scs, dops = kf.fused_expansions_batched(
                    ops.ops[0], Vb, {p: ints[p].fact for p in first},
                    {p: ints[p].sc for p in first}, m, {p: max(eps, rem[p]) for p in first},
                    dgks=ints[0].dgks, hermitian=True, min_one=True, space=space)
                for p in first:
                    ints[p].fact, ints[p].sc = facts[p], scs[p]
                    ints[p].numops += dops[p]
        else:
            # the one-problem pair: a first step where k < m and β > 0, then
            # steps while β > eps and β exceeds the remaining budget (:237);
            # eager: the first step only
            stepping, cand = first, active
            while stepping:
                facts = kf.expand_batched(ops, {p: ints[p].fact for p in stepping}, alg.orth,
                                          space, alg.verbosity, hermitian=hermitian)
                for p in stepping:
                    ints[p].fact = facts[p]
                    ints[p].numops += 1
                cand = [p for p in cand
                        if ints[p].fact.k < m and not (alg.eager and ints[p].fact.k >= 1)]
                bs_ = _read([ints[p].fact.beta for p in cand])
                cand = stepping = [p for p, b in zip(cand, bs_) if b > eps and not b <= rem[p]]
        restart = [p for p in active if ints[p].after_expansion(rem[p])]
        for p in restart:
            ints[p].w = ints[p].w[:1]
        if restart:
            build_w(restart)
            for p in restart:
                ints[p].after_restart()
        active = [p for p in active if not ints[p].done]

    for s in ints:
        log_if(
            alg.verbosity, STARTSTOP,
            "expintegrate finished after {it} iterations: total error = {err}, "
            "numops = {no}", it=s.numiter, err=s.totalerr, no=s.numops,
        )
    warn_if(alg.verbosity, [not s.fixedpt and bool(s.totalerr > s.maxerr) for s in ints],
            WARNING, it=[s.numiter for s in ints], err=[s.totalerr for s in ints])
    infos = [s.info() for s in ints]
    info = ConvergenceInfo(
        converged=torch.tensor([i.converged for i in infos], dtype=torch.int64, device=dev),
        residual=None,
        normres=torch.stack([i.normres.to(dev) for i in infos]),
        numiter=torch.tensor([i.numiter for i in infos], dtype=torch.int64, device=dev),
        numops=torch.tensor([i.numops for i in infos], dtype=torch.int64, device=dev),
    )
    return tree_stack([s.w[0] for s in ints]), info


def exponentiate_batched(op, t, x, alg, space: VectorSpace = STANDARD, *,
                         in_dims=(None, None, 0)):
    """``y_p ≈ exp(t_p·A_p)·x_p`` for ``P`` problems: :func:`expintegrator_batched`
    with one vector, ``in_dims = (op_dim, t_dim, x_dim)``."""
    return expintegrator_batched(op, t, (x,), alg, space, in_dims=in_dims)
