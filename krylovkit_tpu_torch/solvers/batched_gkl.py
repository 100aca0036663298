"""Batched GKL ``svdsolve`` and batched LSMR ``lssolve``: ``P`` problems in
one host loop (the counterpart of ``jax.vmap`` over the JAX package's
``svdsolve_gkl`` and ``lssolve_lsmr``).

``svdsolve_gkl_batched`` is :func:`~.svdsolve.svdsolve_gkl`'s loop with a
problem axis, on the design of ``solvers/batched_arnoldi.py``:

* each problem carries its own ``k``, counts, convergence state, ``keep``
  and two :class:`~..factorizations.krylov.FusedScales`, and gives the
  counts and the values of its own one-problem solve, bit for bit where the
  operator applies each row as its one-problem apply does;
* the two bases are stacks, ``U (P, m+1, ...)`` in the codomain and ``V
  (P, m+1, ...)`` in the domain; a stopped problem is frozen;
* the host reads one list of the stepping problems' ``β`` a step;
* the projected SVD, the decisions and the extraction run per problem
  through the one-problem functions;
* every round ends in one rotation of each stack at the static ``m_out =
  keep_max + 1``: one batched K2 launch
  (``ops/basis.py:transform_partial_inplace_batched``) on a real ``(R,
  128)`` float32 basis, a problem that does not restart taking the
  identity; with ``eager=True`` a problem processes after every step of its
  own and only the problems that restart rotate, as the eager one-problem
  solve does;
* on a square fusable stencil with ``(R, 128)`` float32 vectors, each step
  is two batched K1 half-steps, the normal spec over the V stack and the
  adjoint spec over the U stack, one launch each per distinct live-row
  count (``factorizations/gkl.py:fused_expansions_batched``); otherwise a
  step applies the adjoint to the U rows and the operator to the new V rows
  as two stacks (one batched K3 launch each on a banded operator) and
  sweeps through ``factorizations/gkl.py:expand_batched`` (with the
  projection flag on, one batched K5 and one batched K6 launch a half-step).

``lssolve_lsmr_batched`` runs the LSMR recurrence of
:func:`~.lssolve.lssolve_lsmr` on ``(P, ...)`` stacks, every scalar a
``(P,)`` tensor, as ``solvers/batched_linsolve.py`` runs CG: a step applies
the operator to the stepping rows once and its adjoint once (one batched K3
launch each on a banded operator), the ring sweep runs through
``ops/orthonormal.py:orthogonalize_batched``, and the one-problem branches
on ``β > tol`` and ``α > tol`` become masks that select, row by row, what
the one-problem branch computes (a row whose ``β`` fell to the tolerance
takes the adjoint apply with the others and drops it, uncounted, as the
vmapped ``cond`` computes both branches).  The host reads one list a step.

``in_dims`` takes ``0`` or ``None`` per argument, never guessed from shapes.
A batched operator is a list of ``P`` operators; an ``(f, fadjoint)`` tuple
of callables is always ONE shared operator (``in_dims`` ``None``), never two
problems.  Every operator gets its adjoint as the one-problem front-ends
give it (``require_adjoint``: derived for a bare callable, checked for a
caller's pair).  On a sharded space (``solvers/batched.py``) both drivers
step every problem of a rank's batch row in one all-reduce of each kind a
lock-step (the stack apply, the adjoint stack apply, a sweep's
coefficients, the norms); the fused GKL gate refuses such a space, so
``svdsolve`` runs unfused there.  Pytree vectors are batched as in
``solvers/batched.py`` (a domain tree may differ from the codomain tree:
give ``(f, fadjoint)`` on the trees), also on a sharded space.
:func:`svdsolve_gkl_batched` is differentiable as ``svdsolve`` is
(``alg_rrule``, ``ad/batched.py``), on a sharded space too; LSMR refuses
differentiation, as ``lssolve`` does (``ValueError``).
"""

from __future__ import annotations

import functools

import torch

from ..algorithms import GKL, LSMR
from ..factorizations import gkl as gf
from ..info import STARTSTOP, ConvergenceInfo, log_if, warn_if
from ..ops import orthonormal as on
from ..ops.operator import probe_adjoint
from ..ops.vector import (STANDARD, VectorSpace, alloc_batched, device_of, norm_batched, rounded,
                          scalartype, tree_leaves, tree_map, tree_row, tree_rows, tree_stack,
                          zerovector)
from . import svdsolve as sv
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
from .batched_arnoldi import _stack_infos
from .batched_linsolve import _Active, _axpy, _col, _where
from .lssolve import FINISHED, UNCONVERGED, _Rotations, _rotations, _start_rotations

__all__ = ["svdsolve_gkl_batched", "lssolve_lsmr_batched"]


def _setup(what: str, op, x, in_dims, names, scalars=(), check_space=None,
           space: VectorSpace = STANDARD, rule: bool = False):
    """The problems of a batched call: ``(ops, vectors, probe dtype)``,
    after the refusals (``(ops, None, None)`` where the call differentiates
    through its rule, ``rule``); every operator with its adjoint, a caller's
    ``(f, fadjoint)`` pair checked in ``check_space`` as the one-problem
    front-end checks it.  On a sharded space every rank runs the same
    probes and guard on its own block (the guard's applies are collective;
    the probes run on ``meta`` copies, which make none)."""
    op_dim, x_dim = _in_dims(in_dims, names)
    P = _batch_size(_count(op, op_dim, names[0], vector=False), _count(x, x_dim, names[1]))
    # the adjoint guard runs in the vectors, detached
    xs = _problems(tree_map(torch.Tensor.detach, x), x_dim, P)
    ops = _Operators(op, P, op_dim == 0, templates=xs, check_space=check_space)
    if _differentiated(what, [x], ops.distinct(), scalars, rule):
        return ops, None, None
    # the vectors live in the codomain: the scalar type comes through the adjoint
    cdt = functools.reduce(torch.promote_types,
                           [scalartype(probe_adjoint(o, xs[0]), xs[0]) for o in ops.distinct()])
    return ops, xs, cdt


def svdsolve_gkl_batched(op, x0, howmany: int, which, alg: GKL, space: VectorSpace = STANDARD,
                         *, in_dims=(None, 0), alg_rrule=None):
    """Partial SVDs of ``P`` problems, each as
    :func:`~.svdsolve.svdsolve_gkl` computes it, in one host loop (module
    docstring).

    ``in_dims = (op_dim, x0_dim)``: ``op_dim = 0`` takes ``op`` as a list of
    ``P`` operators (``None``: one shared operator; an ``(f, fadjoint)``
    tuple is always one shared operator); ``x0_dim = 0`` takes ``x0``'s
    leading axis as the problem axis (``None``: one shared start, in the
    codomain).  Returns ``(vals (P, howmany), lvecs (P, howmany, ...), rvecs
    (P, howmany, ...), info)``; ``info``'s counts are ``(P,)`` int64 tensors.
    At ``WARN`` each unconverged problem prints its one-problem line, in
    problem order.

    Differentiable in ``x0`` (zero gradient) and in the tensors of the
    operators, as ``svdsolve`` is (``ad/batched.py``, ``alg_rrule``)."""
    m = alg.krylovdim
    sv._check(howmany, m, which)
    # the pair's guard runs in the standard inner product, as svdsolve's does
    ops, x0s, cdt = _setup("svdsolve_gkl_batched", op, x0, in_dims, ("op", "x0"), space=space,
                           rule=True)
    if x0s is None:
        from ..ad.batched import svdsolve_batched_vjp

        return svdsolve_batched_vjp(svdsolve_gkl_batched, ops.ops, x0, howmany, which, alg,
                                    alg_rrule, space, tuple(in_dims))
    P = len(x0s)
    tol, btol = sv._tolerances(alg, cdt)
    dev = device_of(x0s[0])
    promote = cdt.is_complex and not scalartype(x0s[0]).is_complex
    m1 = m + 1
    Ub, Vb, facts0 = gf.initialize_batched(ops.ops, x0s, m, cdt, space,
                                           vec_dtype=cdt if promote else None,
                                           verbosity=alg.verbosity)
    st = {p: sv._loop_state(facts0[p], m1, cdt, dev) for p in range(P)}
    fused = ops.shared and sv._fused(alg, cdt, ops.ops[0], x0s[0], space, m1)
    keep_max = sv._keep_max(m, howmany)

    active = list(range(P))
    while active:
        facts = {p: st[p].fact for p in active}
        numops = {p: st[p].numops for p in active}
        scU = {p: st[p].scU for p in active}
        scV = {p: st[p].scV for p in active}
        if fused:
            facts, scU, scV, dops = gf.fused_expansions_batched(ops, Ub, Vb, facts, scU, scV,
                                                                m, btol)
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
                facts.update(gf.expand_batched(ops, {p: facts[p] for p in stepping}, alg.orth,
                                               space, alg.verbosity))
                for p in stepping:
                    numops[p] += 2
                    j[p] += 1

        rotU, rotV, finished = {}, {}, []
        for p in active:
            fact = facts[p]
            nconv, svals, Pm, Qm, res, numiter, done, keep, restart_now = sv._round(
                fact, st[p].numiter, which, tol, btol, howmany, alg)
            if not alg.eager:
                # every processing but the last restarts; the last one runs
                # the identity rotations (the JAX package's masked restart)
                rotU[p], rotV[p], fact = sv._restart_rotations(
                    fact, svals, Pm, Qm, fact.beta, keep, gate=restart_now,
                    scales=(scU[p].L, scV[p].L) if fused else None)
            elif restart_now:
                # eager processes every step: rotate only when a restart is due
                rotU[p], rotV[p], fact = sv._restart_rotations(fact, svals, Pm, Qm, fact.beta,
                                                               keep)
            fact = gf.GKLState(tree_row(Ub, p), tree_row(Vb, p), fact.B, fact.k, fact.beta)
            if restart_now and fused:
                scU[p], scV[p] = sv._reseeded(fact, m1, dev)
            st[p] = sv._LoopState(fact, numiter, numops[p], nconv, svals, Pm, Qm, res,
                                  scU[p], scV[p])
            if done:
                finished.append(p)
        # rows < keep_max + 1 survive (kept singular vectors + relocated residual)
        _rotate(Vb, rotV, keep_max + 1)
        _rotate(Ub, rotU, keep_max + 1)
        active = [p for p in active if p not in finished]

    conv = [min(st[p].nconv, howmany) for p in range(P)]
    for p in range(P):
        log_if(alg.verbosity, STARTSTOP, sv.FINISHED, it=st[p].numiter, nc=conv[p],
               nr=st[p].resnorms[:howmany])
    warn_if(alg.verbosity, [c < howmany for c in conv], sv._unconverged(howmany), nc=conv,
            it=[st[p].numiter for p in range(P)])
    outs = [sv._extract(st[p], howmany, cdt) for p in range(P)]
    return (torch.stack([o[0] for o in outs]), tree_stack([o[1] for o in outs]),
            tree_stack([o[2] for o in outs]), _stack_infos([o[3] for o in outs], dev))


def _hypot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.hypot`` of each row as the one-problem solve's 0-d call
    rounds it: one launch on the card, whose kernel is the same for any
    length; row by row on the CPU, whose vectorized loop rounds float64
    otherwise than its scalar one."""
    if a.device.type != "cpu":
        return torch.hypot(a, b)
    b = b.expand_as(a)
    return torch.stack([torch.hypot(x, y) for x, y in zip(a, b)])


def _divided(X, s: torch.Tensor):
    """Each row of the stack ``X`` divided by its entry of the ``(p,)``
    ``s``, leaf by leaf."""
    return tree_map(lambda l: l / _col(s, l), X)


def _set_col(V, j: int, X) -> None:
    """``V[:, j] = X`` leaf by leaf: row ``j`` of every problem's ring."""
    for lV, lX in zip(tree_leaves(V), tree_leaves(X)):
        lV[:, j] = lX


def lssolve_lsmr_batched(op, b, alg: LSMR, lam=0.0, space: VectorSpace = STANDARD, *,
                         in_dims=(None, 0)):
    """LSMR least-squares solves of ``P`` problems ``min ‖b_p − A_p x‖² +
    λ²‖x‖²``, each as :func:`~.lssolve.lssolve_lsmr` solves it, in one host
    loop (module docstring).

    ``in_dims = (op_dim, b_dim)`` as in :func:`svdsolve_gkl_batched`;
    ``lam`` is shared.  Returns ``(x (P, ...), info)`` with ``(P,)`` counts;
    at ``WARN`` each unconverged problem prints its one-problem line, in
    problem order."""
    ops, bs_, cdt = _setup("lssolve_lsmr_batched", op, b, in_dims, ("op", "b"), (lam,),
                           check_space=space, space=space)
    P = len(bs_)
    K = alg.krylovdim
    rdt = cdt.to_real()
    dev = device_of(bs_[0])
    tol = rounded(alg.tol, rdt)
    lamr = torch.as_tensor(lam, device=dev).to(rdt)
    every = list(range(P))

    u = tree_map(lambda l: l.to(cdt), tree_stack(bs_))
    beta = norm_batched(tree_rows(u), space)
    u = _divided(u, torch.where(beta > 0, beta, torch.ones_like(beta)).to(cdt))
    v = ops.apply_adjoint_stack(u, every)
    alpha = norm_batched(tree_rows(v), space)
    v = _divided(v, torch.where(alpha > 0, alpha, torch.ones_like(alpha)).to(cdt))
    V = alloc_batched(tree_row(v, 0), P, K)
    _set_col(V, 0, v)  # each problem's ring buffer of its last K v's

    rot = _start_rotations(alpha, beta)
    normres = torch.abs(rot.zetabar)
    x = zerovector(v)
    r = tree_map(lambda l: _col(beta.to(cdt), l) * l, u)
    out = {"x": x, "r": r, "normres": normres.clone()}
    nr_host = _read([normres])[0]
    numiter, numops = [0] * P, [1] * P
    act = _Active([p for p in range(P) if not nr_host[p] <= tol], {
        "x": x, "u": u, "v": v, "h": v, "hbar": zerovector(v), "r": r,
        "Ah": zerovector(u), "Ahbar": zerovector(u), "V": V, "alpha": alpha,
        "normres": normres, **rot._asdict()})
    it = 0
    while act.ps:
        s = act.s
        it += 1
        rot = _Rotations(**{f: s[f] for f in _Rotations._fields})
        alpha, v, Vr = s["alpha"], s["v"], s["V"]
        Av = ops.apply_stack(v, act.ps)
        # Ah_k = A v_k − (θ_k/ρ_{k−1}) Ah_{k−1}  (the h update of the last step)
        Ah = _axpy(Av, s["Ah"], -(rot.theta / rot.rho).to(cdt))
        # β_{k+1} u_{k+1} = A v_k − α_k u_k
        u = _axpy(Av, s["u"], -alpha.to(cdt))
        beta = norm_batched(tree_rows(u), space)
        bgood = beta > tol
        u = _where(bgood, _divided(u, beta.to(cdt)), u)
        # α_{k+1} v_{k+1} = Aᴴ u_{k+1} − β_{k+1} v_k  (+ ring reorthogonalization)
        w = _axpy(ops.apply_adjoint_stack(u, act.ps), v, -beta.to(cdt))
        if K > 1:
            swept = on.orthogonalize_batched(tree_rows(w), tree_rows(Vr),
                                             [min(K, it)] * len(act.ps), alg.orth, space)
            w = tree_stack([wp for wp, _ in swept])
        alpha = torch.where(bgood, norm_batched(tree_rows(w), space), torch.zeros_like(beta))
        agood = alpha > tol
        w = _where(agood, _divided(w, alpha.to(cdt)), w)
        _set_col(Vr, it % K, _where(agood, w, tree_map(lambda l: l[:, it % K], Vr)))
        v = _where(bgood, w, v)

        rot, c1, c2 = _rotations(rot, alpha, beta, lamr, hypot=_hypot)
        # vector updates
        coef1 = c1.to(cdt)
        hbar = _axpy(s["h"], s["hbar"], -coef1)
        Ahbar = _axpy(Ah, s["Ahbar"], -coef1)
        coef2 = c2.to(cdt)
        x = _axpy(s["x"], hbar, coef2)
        r = _axpy(s["r"], Ahbar, -coef2)
        h = _axpy(v, s["h"], -(rot.theta / rot.rho).to(cdt))
        normres = torch.abs(rot.zetabar)
        act.s = {"x": x, "u": u, "v": v, "h": h, "hbar": hbar, "r": r, "Ah": Ah,
                 "Ahbar": Ahbar, "V": Vr, "alpha": alpha, "normres": normres, **rot._asdict()}
        nrs, good = _read([normres, bgood.to(normres.dtype)])
        done = []
        for i, q in enumerate(act.ps):
            numiter[q] = it
            numops[q] += 1 + int(good[i])
            if nrs[i] <= tol or it >= alg.maxiter:
                done.append(i)
        if done:
            act.retire(done, out)

    nr_host = _read([out["normres"]])[0]
    conv = [int(v <= tol) for v in nr_host]
    for p in range(P):
        log_if(alg.verbosity, STARTSTOP, FINISHED, it=numiter[p], c=conv[p],
               nr=out["normres"][p])
    warn_if(alg.verbosity, [c == 0 for c in conv], UNCONVERGED, it=numiter, nr=out["normres"])
    info = ConvergenceInfo(
        converged=torch.tensor(conv, dtype=torch.int64, device=dev),
        residual=out["r"], normres=out["normres"],
        numiter=torch.tensor(numiter, dtype=torch.int64, device=dev),
        numops=torch.tensor(numops, dtype=torch.int64, device=dev),
    )
    return out["x"], info
