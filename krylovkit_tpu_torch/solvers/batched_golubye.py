"""Batched Golub-Ye ``geneigsolve``: ``P`` pencils in one host loop (the
counterpart of ``jax.vmap`` over the JAX package's ``geneigsolve_golubye``).

:func:`~.golubye.geneigsolve_golubye`'s loop with a problem axis, on the
design of ``solvers/batched.py``:

* each problem carries its own ``k``, shift ``ρ``, counts, ``nconv``,
  previous outer iterate and converged Ritz vectors, and gives the counts
  and the values of its own one-problem solve, bit for bit where its
  operators apply each row as their one-problem applies do;
* the three bases ``V``, ``AV`` and ``BV`` are ``(P, mcap, ...)`` stacks; a
  stopped problem is frozen;
* ``A`` and ``B`` are two sets of operators (``_Operators``; ``B = None``
  is the identity, always shared): one batched apply of the pencil is one
  batched apply of each, two batched K3 launches on banded operators, as
  the one-problem apply is two K3 launches;
* the host reads one list of the stepping problems' ``β`` per Lanczos step
  (a problem steps while ``k_p < m − nconv_p`` and ``β_p > tol``) and one
  list of norms per batch of appends;
* every orthonormalization (the start's residual, each Lanczos step, the
  LOCG append of the previous iterate from the second cycle, the ``i``-th
  deflation append of the problems with ``nconv_p > i``, the restart's
  residual) runs through ``ops/orthonormal.py:orthonormalize_batched``:
  with ``ops/basis.py``'s projection flag on, one batched K5 and one
  batched K6 launch per sweep for the problems it carries;
* the projected pencil (``bs.gram``, ``dense.geneigh_active``), its sort,
  the Ritz data (``bs.transform`` of the three bases) and the restart's
  zeroing run per problem through :mod:`.golubye`'s ``_ritz`` and
  ``_restart``, the functions the one-problem driver calls.

``in_dims = (opA_dim, opB_dim, x0_dim)`` takes ``0`` or ``None`` per
argument, as ``vmap``'s ``in_axes``.  On a sharded space
(``solvers/batched.py``) a pencil apply is one stack apply of each
operator (one halo all-reduce each) and every orthonormalization and
norm one all-reduce for all its problems; ``_ritz`` (two Gram products,
three row-wise products) and ``_restart`` (one norm) keep one all-reduce
per problem a round.  Pytree vectors are batched as in
``solvers/batched.py``; pytree vectors
run on a sharded space too; differentiation is refused (``ValueError``),
as ``geneigsolve`` has no rule in either package; an ``(f, fadjoint)``
tuple is one shared operator, never two problems.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from ..algorithms import GolubYe
from ..info import STARTSTOP, ConvergenceInfo, log_if, warn_if
from ..ops import basis as bs
from ..ops import orthonormal as on
from ..ops.operator import probe_dtype
from ..ops.vector import (STANDARD, VectorSpace, alloc_batched, astype, device_of, inner_batched,
                          norm_batched, rounded, tree_leaves, tree_map, tree_row, tree_rows,
                          tree_stack)
from .batched import _batch_size, _count, _differentiated, _in_dims, _Operators, _problems, _read
from .batched_arnoldi import _stack_infos
from .batched_linsolve import _scaled
from .golubye import _restart, _ritz, _shifted

__all__ = ["geneigsolve_golubye_batched"]


def geneigsolve_golubye_batched(opA, opB, x0, howmany: int, which, alg: GolubYe,
                                space: VectorSpace = STANDARD, *, in_dims=(None, None, 0)):
    """Generalized Hermitian eigensolves ``A_p x = λ B_p x`` of ``P``
    pencils, each as :func:`~.golubye.geneigsolve_golubye` solves it, in one
    host loop (module docstring).

    ``in_dims = (opA_dim, opB_dim, x0_dim)``: ``0`` takes the argument as a
    sequence of ``P`` operators (``x0``: its leading axis as the problem
    axis), ``None`` as one shared operator (start).  ``opB = None`` is the
    identity, shared whatever its entry.  Returns ``(vals (P, howmany), vecs
    (P, howmany, ...), info)``; ``info``'s counts are ``(P,)`` int64
    tensors.  At ``WARN`` each unconverged problem prints its one-problem
    line, in problem order."""
    what = "geneigsolve_golubye_batched"
    a_dim, b_dim, x_dim = _in_dims(in_dims, ("opA", "opB", "x0"))
    m = alg.krylovdim
    if howmany > m:
        raise ValueError(f"howmany={howmany} exceeds krylovdim={m}")
    if isinstance(which, str) and which.upper() in ("LI", "SI"):
        raise ValueError("which=LI/SI invalid for Hermitian pencils (real spectrum)")
    if opB is None:
        b_dim = None
    _differentiated(what, [x0], [])
    P = _batch_size(_count(opA, a_dim, "opA", vector=False),
                    _count(opB, b_dim, "opB", vector=False), _count(x0, x_dim, "x0"))
    opsA = _Operators(opA, P, a_dim == 0)
    opsB: Optional[_Operators] = None if opB is None else _Operators(opB, P, b_dim == 0)
    _differentiated(what, [], opsA.distinct() + (opsB.distinct() if opsB else []))
    x0s = _problems(x0, x_dim, P)
    cdt = functools.reduce(torch.promote_types,
                           [probe_dtype(o, x0s[0]) for o in opsA.distinct()])
    rdt = cdt.to_real()
    tol = rounded(alg.tol, rdt)
    dev = device_of(x0s[0])
    hm1 = howmany + 1
    mcap = m + hm1 + 2  # the Lanczos space, x_old and the deflation vectors

    def pencil(X, ps):
        """``(A_p X[i], B_p X[i])`` for the rows of ``X``: one batched apply
        of each operator set."""
        return opsA.apply_stack(X, ps), X if opsB is None else opsB.apply_stack(X, ps)

    def inv_norm(nrm):
        return (1 / torch.where(nrm > 0, nrm, torch.ones_like(nrm))).to(cdt)

    # the starts, normalised in the caller's space as the one-problem solve does
    X0 = tree_stack([astype(x, cdt) for x in x0s])
    V0 = _scaled(X0, inv_norm(norm_batched(tree_rows(X0), space)))
    every = list(range(P))
    AV0, BV0 = pencil(V0, every)
    rho = list(torch.real(inner_batched(tree_rows(V0), tree_rows(AV0), space))
               / torch.real(inner_batched(tree_rows(V0), tree_rows(BV0), space)))
    Vb, AVb, BVb = (alloc_batched(tree_row(Y, 0), P, mcap) for Y in (V0, AV0, BV0))
    for basis, Y in ((Vb, V0), (AVb, AV0), (BVb, BV0)):
        for lb, lY in zip(tree_leaves(basis), tree_leaves(Y)):
            lb[:, 0] = lY

    def orthonormalize(ws: dict, ks: dict):
        """Each ``ws[p]`` orthonormalized against ``V_p[:ks[p]]``, all in one
        batched call: ``{p: (v, β)}``."""
        ps = list(ws)
        outs = on.orthonormalize_batched([ws[p] for p in ps], [tree_row(Vb, p) for p in ps],
                                         [ks[p] for p in ps], alg.orth, space)
        return {p: (v, b) for p, (v, b, _) in zip(ps, outs)}

    # each problem's residual direction and its norm, orthogonal to the start
    resid = orthonormalize({p: _shifted(tree_row(AV0, p), rho[p].to(cdt), tree_row(BV0, p))
                            for p in every}, dict.fromkeys(every, 1))
    k, nconv, numiter, numops = [1] * P, [0] * P, [1] * P, [1] * P
    vold, cvecs, result = {}, {}, {}

    def append(ws: dict):
        """``_append`` of :mod:`.golubye` for each problem of ``ws`` at once:
        both operators applied and counted whether or not the vector is
        appended."""
        outs = orthonormalize(ws, {p: k[p] for p in ws})
        ps = list(outs)
        X = tree_stack([outs[p][0] for p in ps])
        AX, BX = pencil(X, ps)
        kept = _read([outs[p][1] for p in ps])
        for i, p in enumerate(ps):
            if kept[i] > 0:
                for basis, Y in ((Vb, X), (AVb, AX), (BVb, BX)):
                    bs.set(tree_row(basis, p), k[p], tree_row(Y, i))
                k[p] += 1
            numops[p] += 1

    active = every
    while active:
        # one Lanczos cycle on A − ρB per problem, ρ frozen for the cycle
        shift = {p: rho[p].to(cdt) for p in active}
        stepping = active
        while True:
            cand = [p for p in stepping if k[p] < m - nconv[p]]
            betas = _read([resid[p][1] for p in cand])
            stepping = [p for p, b in zip(cand, betas) if b > tol]
            if not stepping:
                break
            X = tree_stack([resid[p][0] for p in stepping])
            AX, BX = pencil(X, stepping)
            for i, p in enumerate(stepping):
                for basis, Y in ((Vb, X), (AVb, AX), (BVb, BX)):
                    bs.set(tree_row(basis, p), k[p], tree_row(Y, i))
            resid.update(orthonormalize({p: _shifted(tree_row(AX, i), shift[p], tree_row(BX, i))
                                         for i, p in enumerate(stepping)},
                                        {p: k[p] + 1 for p in stepping}))
            for p in stepping:
                k[p] += 1
                numops[p] += 1

        # the LOCG correction (from the second cycle) and the converged vectors
        locg = {p: vold[p] for p in active if numiter[p] > 1}
        if locg:
            append(locg)
        for i in range(max(nconv[p] for p in active)):
            append({p: bs.get(cvecs[p], i) for p in active if nconv[p] > i})

        restarting, finished = {}, []
        for p in active:
            nconv[p], rhos, betas_p, Rv, Rav, Rbv, Rres = _ritz(
                tree_row(Vb, p), tree_row(AVb, p), tree_row(BVb, p), k[p], howmany, which, tol,
                space, cdt)
            result[p] = (rhos, betas_p, Rv, Rres)
            if nconv[p] >= howmany or numiter[p] >= alg.maxiter:
                finished.append(p)
                continue
            vold[p], rho[p], restarting[p] = _restart(
                tree_row(Vb, p), tree_row(AVb, p), tree_row(BVb, p), (Rv, Rav, Rbv, Rres), rhos,
                min(nconv[p], hm1 - 1), space, cdt)
            cvecs[p] = bs.prefix(Rv, howmany)
            k[p] = 1
            numiter[p] += 1
        if restarting:
            resid.update(orthonormalize(restarting, dict.fromkeys(restarting, 1)))
        active = [p for p in active if p not in finished]

    conv = [min(nconv[p], howmany) for p in every]
    for p in every:
        log_if(
            alg.verbosity, STARTSTOP,
            "GolubYe geneigsolve finished after {it} iterations: {nc} values "
            "converged, normres = {nr}",
            it=numiter[p], nc=conv[p], nr=result[p][1][:howmany],
        )
    warn_if(
        alg.verbosity, [c < howmany for c in conv],
        "GolubYe geneigsolve stopped without convergence: {nc} of "
        f"{howmany}" + " values converged",
        nc=conv,
    )
    infos = [ConvergenceInfo(
        converged=conv[p],
        residual=tree_map(torch.clone, bs.prefix(result[p][3], howmany)),
        normres=result[p][1][:howmany],
        numiter=numiter[p],
        numops=numops[p],
    ) for p in every]
    vals = torch.stack([result[p][0][:howmany] for p in every])
    vecs = tree_stack([bs.prefix(result[p][2], howmany) for p in every])
    return vals, vecs, _stack_infos(infos, dev)
