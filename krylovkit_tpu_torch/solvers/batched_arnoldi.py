"""Batched Krylov-Schur Arnoldi: ``P`` problems in one host loop (the
counterpart of ``jax.vmap`` over the JAX package's ``schursolve``,
``eigsolve_arnoldi`` and ``realeigsolve_arnoldi``).

The loop is :func:`~.arnoldi._arnoldi_loop` with a problem axis, on the
design of ``solvers/batched.py``:

* each problem carries its own ``k``, counts, convergence state, ``keep``
  (block-safe in real arithmetic) and
  :class:`~..factorizations.krylov.FusedScales`, and gives the counts and
  the values of its own one-problem solve;
* a stopped problem is frozen: its basis, projected matrix and counts never
  change again;
* the host reads one list of the active problems' ``β`` per step;
* the projected problems (``_process``/``_process_real``, the Krylov-Schur
  truncation, the extraction's ``trevc``) run per problem through the
  one-problem functions;
* every round ends in one rotation of all active problems' bases at the
  static ``m_out = keep_max + 1``: one batched K2 launch
  (``ops/basis.py:transform_partial_inplace_batched``) on a real
  ``(R, 128)`` float32 basis, a problem that does not restart taking the
  identity, as the JAX package's masked restart does; with ``eager=True``
  a problem processes after every step of its own and only the problems
  that restart rotate, as the eager one-problem solve does;
* on a fusable stencil operator with ``(R, 128)`` float32 vectors, each
  step is one batched K1 launch in Arnoldi mode for the problems that step
  at one live-row count (``factorizations/krylov.py:fused_expansions_batched``;
  problems whose ``keep`` differ step at different counts); otherwise a step
  applies the operator to the stack once (one batched K3 launch for a
  banded operator) and orthonormalizes through
  ``factorizations/krylov.py:expand_batched``, with ``ops/basis.py``'s
  projection flag on one batched K5 and one batched K6 launch per sweep.

``in_dims``, the shared or per-problem operator, a sharded space (one
all-reduce a lock-step for every stepping problem, the fused step's halos
each problem's), pytree vectors (the unfused lock-step, the rotation leaf
by leaf, also on a sharded space) and differentiation are those of
``solvers/batched.py``: :func:`eigsolve_arnoldi_batched` takes the rules
of ``eigsolve`` (``alg_rrule``, ``ad/batched.py``), the Schur and real
drivers refuse it, as their front-ends do.
"""

from __future__ import annotations

import functools

import torch

from ..algorithms import Arnoldi
from ..factorizations import krylov as kf
from ..info import ConvergenceInfo, warn_if
from ..ops.operator import probe_dtype
from ..ops import basis as bs
from ..ops.vector import (STANDARD, VectorSpace, alloc_batched, device_of, rounded, tree_row,
                          tree_stack)
from .arnoldi import (
    REALEIG_WARNING,
    _check,
    _extract_eig,
    _extract_realeig,
    _extract_schur,
    _fused,
    _keep_max,
    _LoopState,
    _process,
    _process_real,
    _require_real,
    _restart_rotation,
    _round,
)
from .batched import (
    _batch_size,
    _count,
    _differentiated,
    _goes_on,
    _in_dims,
    _Operators,
    _problems,
    _read,
    _rotate,
)

__all__ = ["schursolve_batched", "eigsolve_arnoldi_batched", "realeigsolve_arnoldi_batched"]


def _setup(what: str, op, x0, howmany: int, alg: Arnoldi, space: VectorSpace, in_dims,
           rule: bool = False):
    """The problems of a batched call: ``(ops, x0s, probe dtype)``, after
    the refusals; ``(ops, None, None)`` where the call differentiates
    through its rule (``rule``)."""
    op_dim, x_dim = _in_dims(in_dims, ("op", "x0"))
    _check(howmany, alg.krylovdim)
    P = _batch_size(_count(op, op_dim, "op", vector=False), _count(x0, x_dim, "x0"))
    ops = _Operators(op, P, op_dim == 0)
    if _differentiated(what, [x0], ops.distinct(), rule=rule):
        return ops, None, None
    x0s = _problems(x0, x_dim, P)
    kf.check_sharded_blocks(what, ops.distinct(), x0s, space)
    pdt = functools.reduce(torch.promote_types,
                           [probe_dtype(o, x0s[0]) for o in ops.distinct()])
    return ops, x0s, pdt


def _arnoldi_loop_batched(ops: _Operators, x0s, howmany: int, which, alg: Arnoldi,
                          space: VectorSpace, cdt, real: bool) -> list:
    """The final :class:`~.arnoldi._LoopState` of each problem, each as
    :func:`~.arnoldi._arnoldi_loop` leaves it."""
    m = alg.krylovdim
    P = len(x0s)
    rdt = cdt.to_real()
    tol = rounded(alg.tol, rdt)
    btol = float(torch.tensor(torch.finfo(rdt).eps, dtype=rdt) ** 0.75)
    dev = device_of(x0s[0])
    process = _process_real if real else _process

    # one basis for all problems; each problem's factorization holds its row
    Vb, st = None, {}
    for p in range(P):
        f0 = kf.initialize(x0s[p], 0, cdt, space, vec_dtype=None if real else cdt,
                           verbosity=alg.verbosity)
        if Vb is None:
            Vb = alloc_batched(bs.get(f0.V, 0), P, m + 1)
        bs.set(tree_row(Vb, p), 0, bs.get(f0.V, 0))
        st[p] = _LoopState(
            fact=kf.KrylovState(tree_row(Vb, p),
                                torch.zeros((m + 1, m + 1), dtype=cdt, device=dev), 0,
                                f0.beta),
            numiter=0, numops=0, nconv=0,
            T=torch.zeros((m + 1, m + 1), dtype=cdt, device=dev),
            Q=torch.eye(m + 1, dtype=cdt, device=dev),
            resnorms=torch.full((m + 1,), float("inf"), dtype=rdt, device=dev),
            sc=kf.fused_scales_init(m + 1, device=dev),
        )
    fused, dgks = _fused(alg, real, cdt, ops.ops[0], x0s[0], space)
    fused = fused and ops.shared
    keep_max = _keep_max(m, howmany)

    active = list(range(P))
    while active:
        facts = {p: st[p].fact for p in active}
        numops = {p: st[p].numops for p in active}
        scs = {p: st[p].sc for p in active}
        if fused:
            facts, scs, dops = kf.fused_expansions_batched(
                ops.ops[0], Vb, facts, scs, m, btol, dgks=dgks, hermitian=False, space=space)
            for p in active:
                numops[p] += dops[p]
        else:
            j = dict.fromkeys(active, 0)  # each problem's expansions in this round
            stepping = active
            while True:
                cand = [p for p in stepping if facts[p].k < m]
                betas = _read([facts[p].beta for p in cand])
                stepping = [p for p, b in zip(cand, betas)
                             if b > btol and _goes_on(alg, j[p], facts[p].k, howmany)]
                if not stepping:
                    break
                facts.update(kf.expand_batched(ops, {p: facts[p] for p in stepping}, alg.orth,
                                               space, alg.verbosity))
                for p in stepping:
                    numops[p] += 1
                    j[p] += 1

        rotations, finished = {}, []
        for p in active:
            nconv, T, Q, res, numiter, done, keep, restart_now = _round(
                process, facts[p], st[p].numiter, which[p] if isinstance(which, list) else which,
                tol, btol, howmany, alg, real)
            fact = facts[p]
            if not alg.eager:
                # every processing but the last restarts; the last one runs
                # the identity rotation (the JAX package's masked restart)
                rotations[p], fact = _restart_rotation(fact, T, Q, fact.beta, keep,
                                                       gate=restart_now,
                                                       scales=scs[p].L if fused else None)
            elif restart_now:
                # eager processes every step: rotate only when a restart is due
                rotations[p], fact = _restart_rotation(fact, T, Q, fact.beta, keep)
            sc = scs[p]
            if restart_now:
                sc = kf.fused_scales_init(m + 1, H=fact.H if fused else None, device=dev)
            st[p] = _LoopState(fact, numiter, numops[p], nconv, T, Q, res, sc)
            if done:
                finished.append(p)
        # rows < keep_max + 1 survive (kept Schur vectors + relocated residual)
        _rotate(Vb, rotations, keep_max + 1)
        active = [p for p in active if p not in finished]
    return [st[p] for p in range(P)]


def _stack_infos(infos, dev) -> ConvergenceInfo:
    """The ``P`` one-problem infos as one, ``(P,)`` int64 counts."""

    def counts(name):
        return torch.tensor([getattr(i, name) for i in infos], dtype=torch.int64, device=dev)

    return ConvergenceInfo(
        converged=counts("converged"),
        residual=tree_stack([i.residual for i in infos]),
        normres=torch.stack([i.normres for i in infos]),
        numiter=counts("numiter"),
        numops=counts("numops"),
    )


def schursolve_batched(op, x0, howmany: int, which, alg: Arnoldi,
                       space: VectorSpace = STANDARD, *, in_dims=(None, 0)):
    """Partial Schur decompositions of ``P`` problems, each as
    :func:`~.arnoldi.schursolve` computes it, in one host loop.

    ``in_dims = (op_dim, x0_dim)`` as in
    :func:`~.batched.eigsolve_lanczos_batched`.  Returns ``(T (P, howmany,
    howmany), vecs (P, howmany, ...), vals, info)``: ``vals`` is ``(re, im)``
    of ``(P, howmany)`` each for real inputs, else ``(P, howmany)``;
    ``info``'s counts are ``(P,)`` int64 tensors."""
    ops, x0s, pdt = _setup("schursolve_batched", op, x0, howmany, alg, space, in_dims)
    real = not pdt.is_complex
    cdt = pdt if real else torch.promote_types(pdt, torch.complex64)
    sts = _arnoldi_loop_batched(ops, x0s, howmany, which, alg, space, cdt, real)
    outs = [_extract_schur(s, howmany, real, cdt) for s in sts]
    vals = ((torch.stack([o[2][0] for o in outs]), torch.stack([o[2][1] for o in outs]))
            if real else torch.stack([o[2] for o in outs]))
    return (torch.stack([o[0] for o in outs]), tree_stack([o[1] for o in outs]), vals,
            _stack_infos([o[3] for o in outs], device_of(x0s[0])))


def eigsolve_arnoldi_batched(op, x0, howmany: int, which, alg: Arnoldi,
                             space: VectorSpace = STANDARD, *, in_dims=(None, 0),
                             alg_rrule=None):
    """General eigsolves of ``P`` problems, each as
    :func:`~.arnoldi.eigsolve_arnoldi` solves it, in one host loop.  Returns
    ``(vals (P, howmany), vecs (P, howmany, ...), info)``.  ``which`` is one
    selector, or a list of ``P`` (one a problem).

    Differentiable in ``x0`` (zero gradient) and in the tensors of the
    operators, as ``eigsolve`` is (``ad/batched.py``, ``alg_rrule``)."""
    ops, x0s, pdt = _setup("eigsolve_arnoldi_batched", op, x0, howmany, alg, space, in_dims,
                           rule=True)
    if x0s is None:
        from ..ad.batched import eigsolve_batched_vjp

        return eigsolve_batched_vjp(eigsolve_arnoldi_batched, ops.ops, x0, howmany, which, alg,
                                    alg_rrule, space, tuple(in_dims))
    real = not pdt.is_complex
    cdt = torch.promote_types(pdt, torch.complex64)
    sts = _arnoldi_loop_batched(ops, x0s, howmany, which, alg, space, pdt if real else cdt, real)
    outs = [_extract_eig(s, howmany, real, cdt) for s in sts]
    return (torch.stack([o[0] for o in outs]), tree_stack([o[1] for o in outs]),
            _stack_infos([o[2] for o in outs], device_of(x0s[0])))


def realeigsolve_arnoldi_batched(op, x0, howmany: int, which, alg: Arnoldi,
                                 space: VectorSpace = STANDARD, *, in_dims=(None, 0)):
    """Real eigsolves of ``P`` problems, each as
    :func:`~.arnoldi.realeigsolve_arnoldi` solves it, in one host loop.
    Returns ``(vals (P, howmany), vecs (P, howmany, ...), info, maximag
    (P,))``.  At ``WARN`` each problem whose wanted window took a complex
    conjugate pair prints its one-problem line, in problem order."""
    ops, x0s, pdt = _setup("realeigsolve_arnoldi_batched", op, x0, howmany, alg, space, in_dims)
    _require_real(pdt)
    sts = _arnoldi_loop_batched(ops, x0s, howmany, which, alg, space, pdt, True)
    outs = [_extract_realeig(s, howmany, pdt) for s in sts]
    maximag = torch.stack([o[3] for o in outs])
    warn_if(alg.verbosity, [o[3] > 0 for o in outs], REALEIG_WARNING, mi=[o[3] for o in outs])
    return (torch.stack([o[0] for o in outs]), tree_stack([o[1] for o in outs]),
            _stack_infos([o[2] for o in outs], device_of(x0s[0])), maximag)
