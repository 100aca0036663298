"""Batched BiArnoldi ``bieigsolve``: ``P`` two-sided eigenproblems in one
host loop (the counterpart of ``jax.vmap`` over the JAX package's
``bieigsolve_driver``).

:func:`~.biarnoldi.bieigsolve_driver`'s loop with a problem axis, on the
design of ``solvers/batched.py``:

* each problem carries its own two factorizations (right ``V`` for ``A``,
  left ``W`` for ``Aᴴ``), its ``M = WᴴV``, ``k``, counts, convergence state
  and ``keep``, and gives the counts and the values of its own one-problem
  solve, bit for bit where the operator applies each row as its
  one-problem apply does;
* the two bases are ``(P, m+1, ...)`` stacks; a stopped problem is frozen;
* the lock-step expansion runs every problem that steps at its own ``k``:
  the right side through ``factorizations/krylov.py:expand_batched`` over
  the operators' stack apply, the left side over their adjoint stack apply
  (one batched K3 launch each on banded operators, the adjoint's planes
  stacked on first use); the host reads one list of the stepping problems'
  two ``β`` per lock-step;
* the projections of ``_update_M`` and of the oblique correction run
  through ``ops/basis.py:project_batched`` (one batched K5 launch each with
  the projection flag on), the cgs sweeps through ``orthonormalize_batched``
  (one batched K5 and one batched K6 launch per sweep);
* the two Schur forms and their sorts, the 2×2-block ``nconv`` and ``keep``
  adjustments, the dual restart (``bs.transform``, as the one-problem
  driver and the JAX package rotate: no K2) and the extraction run per
  problem through :mod:`.biarnoldi`'s ``_round`` and ``_extract``, the
  functions the one-problem driver calls.  Problems restart at their own
  ``keep``, so they go on expanding at different ``k``; with
  ``eager=True`` each problem runs its round after every step of its own,
  as the eager one-problem solve does.

``in_dims = (op_dim, v0_dim, w0_dim)`` takes ``0`` or ``None`` per
argument.  Every operator gets its adjoint through ``require_adjoint``:
derived for a bare callable, as ``bieigsolve`` derives it, and a caller's
``(f, fadjoint)`` pair checked, as ``svdsolve`` checks it.  On a sharded
space (``solvers/batched.py``) a lock-step is one all-reduce of each kind
for all its stepping problems (the stack apply, the adjoint stack apply,
each side's sweeps and norms, the two projections of ``M``), as are the
starts' norms, ``M[0, 0]`` and the oblique correction's projections;
``_round`` keeps its two residual norms (four with a restart) per problem.
Pytree vectors are batched as in ``solvers/batched.py`` (a ``(v0, w0)``
pair of trees of one structure), also on a sharded space; differentiation
is refused (``ValueError``), as ``bieigsolve`` has no rule in either
package; an ``(f, fadjoint)`` tuple is one shared operator, never two
problems.
"""

from __future__ import annotations

import functools

import torch

from ..algorithms import BiArnoldi
from ..factorizations import krylov as kf
from ..info import STARTSTOP, log_if, warn_if
from ..ops import basis as bs
from ..ops.operator import probe_dtype
from ..ops.vector import (STANDARD, VectorSpace, alloc_batched, device_of, inner_batched, rounded,
                          tree_leaves, tree_row, tree_stack)
from .batched import (_batch_size, _count, _differentiated, _goes_on, _in_dims, _Operators,
                      _problems, _read)
from .batched_arnoldi import _stack_infos
from .biarnoldi import _extract, _LoopState, _round

__all__ = ["bieigsolve_batched"]


def _update_M_batched(sts: dict, js: dict, space: VectorSpace):
    """``_update_M`` of :mod:`.biarnoldi` for each problem of ``js``: row and
    column ``js[p]`` of ``M_p``, its two projections each one
    ``project_batched`` call for all of them."""
    ps = list(js)
    colj = bs.project_batched([sts[p].fW.V for p in ps], [bs.get(sts[p].fV.V, js[p]) for p in ps],
                              [js[p] + 1 for p in ps], space)  # ⟨W_i, v_j⟩, i <= j
    rowj = bs.project_batched([sts[p].fV.V for p in ps], [bs.get(sts[p].fW.V, js[p]) for p in ps],
                              [js[p] + 1 for p in ps], space)  # ⟨w_j, v_i⟩
    for p, c, r in zip(ps, colj, rowj):
        M, j = sts[p].M, js[p]
        M[:, j] = c.to(M.dtype)
        M[j, :] = torch.conj(r).to(M.dtype)


def bieigsolve_batched(op, v0, w0, howmany: int, which, alg: BiArnoldi,
                       space: VectorSpace = STANDARD, *, in_dims=(None, 0, 0)):
    """Two-sided eigensolves of ``P`` problems, each as
    :func:`~.biarnoldi.bieigsolve_driver` solves it, in one host loop
    (module docstring).

    ``in_dims = (op_dim, v0_dim, w0_dim)``: ``op_dim = 0`` takes ``op`` as a
    sequence of ``P`` operators (``None``: one shared operator; an ``(f,
    fadjoint)`` tuple is always one shared operator); ``v0_dim``/``w0_dim =
    0`` take the starts' leading axis as the problem axis (``None``: one
    shared start).  Returns ``(values (P, howmany), (vecsV (P, howmany,
    ...), vecsW), (infoV, infoW))``; the infos' counts are ``(P,)`` int64
    tensors.  At ``WARN`` each unconverged problem prints its one-problem
    line, in problem order."""
    what = "bieigsolve_batched"
    op_dim, v_dim, w_dim = _in_dims(in_dims, ("op", "v0", "w0"))
    m = alg.krylovdim
    if howmany > m:
        raise ValueError(f"howmany={howmany} exceeds krylovdim={m}")
    _differentiated(what, [v0, w0], [])
    P = _batch_size(_count(op, op_dim, "op", vector=False), _count(v0, v_dim, "v0"),
                    _count(w0, w_dim, "w0"))
    vs, ws = _problems(v0, v_dim, P), _problems(w0, w_dim, P)
    ops = _Operators(op, P, op_dim == 0, templates=vs)
    _differentiated(what, [], ops.distinct())
    pdt = functools.reduce(torch.promote_types, [probe_dtype(o, vs[0]) for o in ops.distinct()])
    real = not pdt.is_complex and isinstance(which, str)
    cdt = pdt if real else torch.promote_types(pdt, torch.complex64)
    rdt = cdt.to_real()
    tol = rounded(alg.tol, rdt)
    btol = float(torch.tensor(torch.finfo(rdt).eps, dtype=rdt) ** 0.75)
    m1 = m + 1
    dev = device_of(vs[0])

    # one stack per side; each problem's factorizations hold its rows.  The
    # starts are normalised with one norm_batched for both sides and M[0, 0]
    # is one inner_batched
    starts = kf.normalized_batched(vs + ws, space, None if real else cdt)
    Vb = alloc_batched(starts[0], P, m1)
    Wb = alloc_batched(starts[P], P, m1)
    for basis, S in ((Vb, tree_stack(starts[:P])), (Wb, tree_stack(starts[P:]))):
        for lb, lS in zip(tree_leaves(basis), tree_leaves(S)):
            lb[:, 0] = lS
    M00 = inner_batched([bs.get(tree_row(Vb, p), 0) for p in range(P)],
                        [bs.get(tree_row(Wb, p), 0) for p in range(P)], space).conj().to(cdt)

    def start(basis):
        return kf.KrylovState(basis, torch.zeros((m1, m1), dtype=cdt, device=dev), 0,
                              torch.ones((), dtype=rdt, device=dev))

    st = {}
    for p in range(P):
        M = torch.zeros((m1, m1), dtype=cdt, device=dev)
        M[0, 0] = M00[p]
        st[p] = _LoopState(fV=start(tree_row(Vb, p)), fW=start(tree_row(Wb, p)), M=M)

    active = list(range(P))
    while active:
        # lock-step expansion, each problem at its own k (do-while: at least
        # one step where possible)
        j = dict.fromkeys(active, 0)  # each problem's expansions in this round
        stepping = active
        while True:
            cand = [p for p in stepping if st[p].fV.k < m]
            betas = _read([torch.stack([st[p].fV.beta, st[p].fW.beta]) for p in cand])
            stepping = [p for p, (bv, bw) in zip(cand, betas)
                        if bv > btol and bw > btol and _goes_on(alg, j[p], st[p].fV.k, howmany)]
            if not stepping:
                break
            fVs = kf.expand_batched(ops, {p: st[p].fV for p in stepping}, alg.orth, space,
                                    alg.verbosity)
            fWs = kf.expand_batched(ops.adjoint, {p: st[p].fW for p in stepping}, alg.orth,
                                    space, alg.verbosity)
            for p in stepping:
                st[p].fV, st[p].fW = fVs[p], fWs[p]
                st[p].numops += 2
                j[p] += 1
            _update_M_batched(st, {p: st[p].fV.k for p in stepping}, space)

        # the oblique correction's projections, then each problem's round
        Ls = [st[p].fV.k for p in active]
        Whv = bs.project_batched([st[p].fW.V for p in active],
                                 [bs.get(st[p].fV.V, L) for p, L in zip(active, Ls)], Ls, space)
        Vhw = bs.project_batched([st[p].fV.V for p in active],
                                 [bs.get(st[p].fW.V, L) for p, L in zip(active, Ls)], Ls, space)
        restarts, finished = {}, []
        for p, a, b in zip(active, Whv, Vhw):
            done, restart = _round(st[p], a, b, howmany, which, alg, space, cdt, real, tol, btol)
            if done:
                finished.append(p)
            elif restart is not None:
                keep, Vn, Wn, Hn, Kn, Mn = restart
                for basis, new in ((Vb, Vn), (Wb, Wn)):
                    for lb, ln in zip(tree_leaves(tree_row(basis, p)), tree_leaves(new)):
                        lb.copy_(ln)
                st[p].M = Mn
                st[p].fV = kf.KrylovState(tree_row(Vb, p), Hn, keep, st[p].fV.beta)
                st[p].fW = kf.KrylovState(tree_row(Wb, p), Kn, keep, st[p].fW.beta)
                restarts[p] = keep
        if restarts:
            _update_M_batched(st, restarts, space)
        active = [p for p in active if p not in finished]

    conv = [min(st[p].nconv, howmany) for p in range(P)]
    for p in range(P):
        log_if(
            alg.verbosity, STARTSTOP,
            "BiArnoldi bieigsolve finished after {it} iterations: {nc} values "
            "converged", it=st[p].numiter, nc=conv[p],
        )
    warn_if(
        alg.verbosity, [st[p].nconv < howmany for p in range(P)],
        "BiArnoldi bieigsolve stopped without convergence: {nc} of "
        f"{howmany}" + " values converged after {it} iterations",
        nc=[st[p].nconv for p in range(P)], it=[st[p].numiter for p in range(P)],
    )
    outs = [_extract(st[p], howmany, cdt, real) for p in range(P)]
    return (torch.stack([o[0] for o in outs]),
            (tree_stack([o[1] for o in outs]), tree_stack([o[2] for o in outs])),
            (_stack_infos([o[3] for o in outs], dev), _stack_infos([o[4] for o in outs], dev)))
