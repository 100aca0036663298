"""Batched Block Lanczos ``eigsolve``: ``P`` Hermitian block eigenproblems
in one host loop (the counterpart of ``jax.vmap`` over the JAX package's
``eigsolve_blocklanczos``).

:func:`~.blocklanczos.eigsolve_blocklanczos`'s loop with a problem axis, on
the design of ``solvers/batched.py``:

* each problem carries its own ``k``, block rank ``r``, ``β``, counts and
  convergence state, and gives the counts and the values of its own
  one-problem solve, bit for bit where its operator applies each row as its
  one-problem apply does;
* each problem has its own basis; a problem that is done is frozen;
* a lock-step expands every problem that steps at its own ``k``
  (``factorizations/blocklanczos.py:expand_batched``): their current blocks
  are applied as one stack of ``P_s·b`` rows (``_Operators.apply_stack``,
  each problem's index repeated ``b`` times: one batched K3 launch on
  kernel-backed banded operators), and each column of their block QRs is
  one ``bs.project_batched`` call a pass (one batched K5 launch with
  ``ops/basis.py``'s projection flag on).  The zero rows of a
  rank-deficient block are applied and counted, as in the one-problem
  solve;
* the host reads one list of the stepping problems' ``(β, r)`` a
  lock-step; a problem steps while ``k + r <= krylovdim``, ``r > 0`` and
  ``β > btol`` (with ``eager``, also while ``k < max(howmany, 1)``), after
  one step of each round where ``k + r <= krylovdim`` and ``r > 0``;
* the dense round, the thick restart (``bs.transform``, as the one-problem
  driver and the JAX package rotate: no K2) and the extraction run per
  problem through :mod:`.blocklanczos`'s ``_round``, ``_restart`` and
  ``_extract``, the functions the one-problem driver calls.

``in_dims = (op_dim, X0_dim)`` takes ``0`` or ``None`` per argument.  On
a sharded space (``solvers/batched.py``; a rank holds its batch row's
``(P_b, b, ...)`` blocks of rows) a lock-step is one all-reduce of each
kind for all its stepping problems: the stack apply, each Gram pass, the
block QRs' input norms, and each QR column's two projection passes and its
norms; the dense round runs no collective.  A start of pytree vectors is a
tree whose leaves are ``(P, b, ...)`` with ``in_dims`` ``0`` (a
:class:`~..ops.block.Block` of trees, or its stacked tree, shared with
``None``); its rows apply problem by problem.  Pytree vectors
run on a sharded space too; differentiation is refused (``ValueError``),
as a Block start has no rule in either package; an ``(f, fadjoint)``
tuple is one shared operator, never two problems.
"""

from __future__ import annotations

import functools

import torch

from ..algorithms import BlockLanczos
from ..factorizations import blocklanczos as bf
from ..info import STARTSTOP, log_if, warn_if
from ..ops import basis as bs
from ..ops.block import Block
from ..ops.operator import probe_dtype
from ..ops.vector import STANDARD, VectorSpace, astype, device_of, rounded, tree_stack
from .batched import _batch_size, _count, _differentiated, _in_dims, _Operators, _problems, _read
from .batched_arnoldi import _stack_infos
from .blocklanczos import _eps_pow, _extract, _restart, _round

__all__ = ["eigsolve_blocklanczos_batched"]


def eigsolve_blocklanczos_batched(op, X0, howmany: int, which, alg: BlockLanczos,
                                  space: VectorSpace = STANDARD, *, in_dims=(None, 0)):
    """Hermitian block eigensolves of ``P`` problems, each as
    :func:`~.blocklanczos.eigsolve_blocklanczos` solves it, in one host
    loop (module docstring).

    ``in_dims = (op_dim, X0_dim)``: ``op_dim = 0`` takes ``op`` as a
    sequence of ``P`` operators (``None``: one shared operator; an ``(f,
    fadjoint)`` tuple is always one shared operator); ``X0_dim = 0`` takes a
    ``(P, b, ...)`` tensor, or a tree of such leaves, one start block per
    problem (``None``: one shared ``(b, ...)`` block or
    :class:`~..ops.block.Block`).  Returns
    ``(vals (P, howmany), vecs (P, howmany, ...), info)``; ``info``'s
    counts are ``(P,)`` int64 tensors, ``normres`` and ``residual`` carry
    the leading ``P``.  At ``WARN`` each unconverged problem prints its
    one-problem line, in problem order."""
    what = "eigsolve_blocklanczos_batched"
    op_dim, x_dim = _in_dims(in_dims, ("op", "X0"))
    m = alg.krylovdim
    if howmany > m:
        raise ValueError(f"howmany={howmany} exceeds krylovdim={m}")
    if isinstance(X0, Block):
        if x_dim == 0:
            raise ValueError(f"{what}: a Block is one shared start block; give one block per "
                             "problem as a (P, b, ...) tensor or a tree of such leaves")
        X0 = X0.stacked
    _differentiated(what, [X0], [])
    P = _batch_size(_count(op, op_dim, "op", vector=False), _count(X0, x_dim, "X0"))
    ops = _Operators(op, P, op_dim == 0)
    _differentiated(what, [], ops.distinct())
    X0s = _problems(X0, x_dim, P)
    b = bs.capacity(X0s[0])
    cdt = functools.reduce(torch.promote_types,
                           [probe_dtype(o, bs.get(X0s[0], 0)) for o in ops.distinct()])
    rdt = cdt.to_real()
    tol = rounded(alg.tol, rdt)
    qr_tol = rounded(alg.qr_tol, rdt) if alg.qr_tol >= 0 else _eps_pow(rdt)
    btol = _eps_pow(rdt)
    dev = device_of(X0s[0])

    st = bf.initialize_batched([astype(x, cdt) for x in X0s], m, cdt, qr_tol, space)
    for p, r in enumerate(_read([s.r for s in st])):
        st[p].r = int(r)
    beta = [1.0] * P
    numiter, numops = [0] * P, [0] * P
    rounds = {}

    def steps(p):
        return st[p].k + st[p].r <= m and st[p].r > 0

    active = list(range(P))
    while active:
        # lock-steps, each problem at its own k: one step of every problem
        # that can, then on while β > btol (¬(β > btol): a NaN β stops)
        stepping = [p for p in active if steps(p)]
        while stepping:
            new = bf.expand_batched(ops.apply_stack, {p: st[p] for p in stepping}, qr_tol, space,
                                    alg.verbosity)
            read = _read([torch.stack([new[p].beta.double(), new[p].r.double()])
                          for p in stepping])
            for p, (beta_p, r_p) in zip(stepping, read):
                st[p] = new[p]
                st[p].r = int(r_p)
                beta[p] = beta_p
                numops[p] += b
            stepping = [p for p in stepping if steps(p) and beta[p] > btol
                        and not (alg.eager and st[p].k >= max(howmany, 1))]

        finished = []
        for p in active:
            w, U, SU, res, nconv = _round(st[p], b, which, tol)
            rounds[p] = (w, U, res, nconv)
            full = st[p].k + st[p].r > m
            numiter[p] += int(full)
            exhausted = st[p].r <= 0 or not (beta[p] > btol)
            if nconv >= howmany or (full and numiter[p] >= alg.maxiter) or exhausted:
                finished.append(p)
            elif full:
                st[p] = _restart(st[p], w, U, SU, nconv, m, b)
        active = [p for p in active if p not in finished]

    conv = [min(rounds[p][3], howmany) for p in range(P)]
    for p in range(P):
        log_if(
            alg.verbosity, STARTSTOP,
            "BlockLanczos eigsolve finished after {it} iterations: {nc} values "
            "converged, normres = {nr}",
            it=numiter[p], nc=conv[p], nr=rounds[p][2][:howmany],
        )
    warn_if(
        alg.verbosity, [c < howmany for c in conv],
        "BlockLanczos eigsolve stopped without convergence: {nc} of "
        f"{howmany}" + " values converged after {it} iterations",
        nc=conv, it=numiter,
    )
    outs = [_extract(st[p], rounds[p][0], rounds[p][1], rounds[p][2], conv[p],
                     max(numiter[p], 1), numops[p], howmany, b) for p in range(P)]
    return (torch.stack([o[0] for o in outs]), tree_stack([o[1] for o in outs]),
            _stack_infos([o[2] for o in outs], dev))
