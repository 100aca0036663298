"""Differentiation through a batched solve (the counterpart of ``jax.grad``
over ``jax.vmap`` of the JAX front-ends ``linsolve``, ``eigsolve`` and
``svdsolve``); port-only, as ``solvers/batched*.py`` are.

Under ``jax.vmap`` a front-end's ``jax.custom_vjp`` maps its forward (the
driver, over the problems) and its backward (the rule's own Krylov solves,
over the problems alike).  Here one ``torch.autograd.Function`` per rule
does the same with the batched drivers:

* the forward is the batched driver on detached inputs (each problem's
  values and counts are its one-problem solve's);
* the backward builds each problem's inner solves as its one-problem rule
  does (``ad/linsolve.py``, ``ad/eigsolve.py:route``,
  ``ad/svdsolve.py:route``: the formulas exist once) and solves all
  problems' in one batched call of the driver of ``alg_rrule``'s family:
  the linsolve rule's adjoint systems ``(conj(a0) + conj(a1) A_pᴴ) u_p =
  x̄_p`` (a banded operator's adjoint planes in one batched K3 launch a
  lock-step), the bordered systems of the GMRES rules (``P × howmany``
  per-problem callables on ``(vector, scalar)`` or ``(x, y)`` tuples), and
  the Sylvester rules' ``P`` Arnoldi eigensolves on ``(w, x)`` or ``(x, y,
  z)`` tuples, each problem with its own nearest-value sorter;
* the operator cotangent is the one-problem rules' (the plain form of each
  operator, ``_common.operator_cotangent``): a shared operator (``in_dims``
  ``None``) gets the sum over the problems, as ``jax.vmap`` with
  ``in_axes=None`` gives, a sequence of operators each its own, and a
  matrix stack (its matrices' views) the stack's.  Shared ``a0`` and
  ``a1`` get the sums over the problems; a shared ``b`` the sum of the
  ``u_p``.  ``x0`` gets no gradient.

Each problem's gradient is its one-problem front-end's, to rounding (the
bits, where the batched drivers keep them).

On a sharded space (``VectorSpace(psum_axis=...)``) the rules run as the
one-problem sharded rules do (``ad/_common.py``), every rank alike: the
inner solves are one batched call on the space, whose lock-steps
all-reduce once of each kind for every problem; the adjoint of a shared
sharded operator keeps its stack applies (``_common.adjoint_operator``:
one halo all-reduce for all rows); a per-problem callable (a
``ParametricOperator``, the bordered and Sylvester maps) makes its own
collectives, problem by problem, and so do each problem's route
reductions (``space.inner`` and the Gram matrices of ``euclidean``).  A
replicated leaf of a tuple vector (the bordered systems' scalar) is
summed with the other leaves' local partials before the row's one
all-reduce, as the one-problem inner product sums it.  Each rank's
cotangent of a sharded input is its block, of a replicated one (``a0``,
``a1``, a shared operator's tensor) its partial; a sum over the problems
(``shift_cotangents``, a shared ``b``, a shared operator) is a sum of the
problems' local partials, which the caller sums over the ranks once.
"""

from __future__ import annotations

import torch

from ..ops.vector import (scalartype, tree_flatten, tree_leaves, tree_rows, tree_stack,
                          tree_unflatten, zerovector)
from ._common import Call, adjoint_operator, detached, operator_cotangent, real_safe, row
from . import eigsolve as _eig
from . import linsolve as _lin
from . import svdsolve as _svd

__all__ = ["linsolve_batched_vjp", "eigsolve_batched_vjp", "svdsolve_batched_vjp",
           "solve_inner_batched"]


def linsolve_batched(alg):
    """The batched driver of ``alg``'s family."""
    from ..algorithms import CG, GMRES, MINRES, BiCGStab
    from ..solvers import batched as bt
    from ..solvers import batched_linsolve as bl

    for cls, driver in ((CG, bl.linsolve_cg_batched), (MINRES, bl.linsolve_minres_batched),
                        (BiCGStab, bl.linsolve_bicgstab_batched),
                        (GMRES, bt.linsolve_gmres_batched)):
        if isinstance(alg, cls):
            return driver
    raise TypeError(f"unsupported linsolve algorithm {alg!r}")


def solve_inner_batched(inners, space) -> list:
    """Each problem's operator-cotangent terms, the inner solves of all
    problems (``inners``, one :class:`~._common.Inner` a problem, of one
    kind and algorithm) in one batched call, each a per-problem operator
    (``in_dims`` 0)."""
    kind, alg = inners[0].kind, inners[0].alg
    probs = [pr for inner in inners for pr in inner.problems]
    ops = [pr[0] for pr in probs]
    if kind == "linsolve":
        X, _ = linsolve_batched(alg)(ops, tree_stack([pr[1] for pr in probs]),
                                     tree_stack([pr[2] for pr in probs]), *inners[0].shifts,
                                     alg, space, in_dims=(0, 0, 0))
    else:
        from ..solvers.batched_arnoldi import eigsolve_arnoldi_batched

        _, X, _ = eigsolve_arnoldi_batched(ops, tree_stack([pr[1] for pr in probs]),
                                           probs[0][2], [pr[3] for pr in probs], alg, space,
                                           in_dims=(0, 0))
    sols = tree_rows(X)
    out, q = [], 0
    for inner in inners:
        k = len(inner.problems)
        out.append(inner.finish(sols[q:q + k]))
        q += k
    return out


class _Ops:
    """The operators of a batch: the distinct ones (by identity, each made
    ready by ``prepare``), each problem's index among them, and their
    tensors in order (the inputs that the Function differentiates)."""

    def __init__(self, ops, shared: bool, prepare=lambda o: o):
        first = {}
        for o in ops:
            first.setdefault(id(o), len(first))
        uniq = list({id(o): o for o in ops}.values())
        self.distinct = [prepare(o) for o in uniq]
        self.index = [first[id(o)] for o in ops]
        self.shared = shared
        self.sizes = [len(o.tensors()) for o in self.distinct]

    def tensors(self) -> list:
        return [t for o in self.distinct for t in o.tensors()]

    def detached(self, flat) -> list:
        out, q = [], 0
        for o, k in zip(self.distinct, self.sizes):
            out.append(detached(o, list(flat[q:q + k])))
            q += k
        return out

    def arg(self, ds):
        """The driver's operator argument from the distinct operators
        ``ds``: the shared one, or one a problem."""
        return ds[0] if self.shared else [ds[i] for i in self.index]

    def of(self, ds, p: int):
        return ds[self.index[p]]

    def cotangents(self, terms) -> list:
        """The gradients of the tensors of every distinct operator, from
        each problem's terms (``terms[p]``): an operator's cotangent sums
        the terms of the problems that share it."""
        grads = []
        for d, o in enumerate(self.distinct):
            grads += operator_cotangent(
                o, [t for p, ts in enumerate(terms) if self.index[p] == d for t in ts])
        return grads


def _conj(a):
    return torch.conj(a) if isinstance(a, torch.Tensor) else a.conjugate()


def _finish(grads, dtypes):
    return (None,) + tuple(real_safe(g, dt) if g is not None else None
                           for g, dt in zip(grads, dtypes))


class _LinsolveBatched(torch.autograd.Function):
    @staticmethod
    def forward(ctx, call, *flat):
        nb, nx, ns = call.nb, call.nx, len(call.slots)
        b = tree_unflatten([t.detach() for t in flat[:nb]], call.spec_b)
        x0 = tree_unflatten([t.detach() for t in flat[nb:nb + nx]], call.spec_x0)
        shifts = list(call.shifts)
        for i, t in zip(call.slots, flat[nb + nx:nb + nx + ns]):
            shifts[i] = t.detach()
        ds = call.ops.detached(flat[nb + nx + ns:])
        x, info = call.driver(call.ops.arg(ds), b, x0, *shifts, call.alg, call.space,
                              in_dims=call.in_dims)
        xl, call.spec_x = tree_flatten(x)
        call.info = info
        ctx.call, ctx.ds, ctx.shifts = call, ds, shifts
        ctx.save_for_backward(*xl)
        return tuple(xl)

    @staticmethod
    def backward(ctx, *gx):
        call, ds, (a0, a1) = ctx.call, ctx.ds, ctx.shifts
        need = ctx.needs_input_grad[1:]
        nb, nx, ns = call.nb, call.nx, len(call.slots)
        X = tree_unflatten([t.detach() for t in ctx.saved_tensors], call.spec_x)
        G = tree_unflatten(list(gx), call.spec_x)
        adj = [adjoint_operator(o, scalartype(X)) for o in ds]
        U, call.info_rrule = linsolve_batched(call.alg_rrule)(
            call.ops.arg(adj), G, zerovector(G), _conj(a0), _conj(a1), call.alg_rrule,
            call.space, in_dims=(call.in_dims[0], 0, 0))
        xs, us = tree_rows(X), tree_rows(U)
        grads = [None] * len(need)
        if any(need[:nb]):
            grads[:nb] = [l if call.in_dims[1] == 0 else l.sum(0) for l in tree_leaves(U)]
        for j, i in enumerate(call.slots):
            if need[nb + nx + j]:
                parts = [_lin.shift_cotangents(call.ops.of(ds, p), xs[p], us[p], i == 0,
                                               i == 1)[i] for p in range(len(xs))]
                grads[nb + nx + j] = sum(parts[1:], parts[0])
        if any(need[nb + nx + ns:]):
            grads[nb + nx + ns:] = call.ops.cotangents(
                [_lin.operator_terms(x, u, a1) for x, u in zip(xs, us)])
        return _finish(grads, call.dtypes)


def linsolve_batched_vjp(driver, ops, b, x0, a0, a1, alg, alg_rrule, space, in_dims):
    """``driver(ops, b, x0, a0, a1, alg, space, in_dims=in_dims)`` (a batched
    linear driver; ``ops`` the problems' resolved operators) as a
    ``torch.autograd.Function`` of ``b``, ``x0``, the tensor shifts and the
    tensors of the distinct operators.  Returns ``(x, info)``; the backward
    solves the adjoint systems with ``alg_rrule`` (default ``alg``) in one
    batched call."""
    from ..ops.vector import tree_row

    tmpl = tree_row(b, 0) if in_dims[1] == 0 else b
    bops = _Ops(ops, in_dims[0] is None, lambda o: o.with_adjoint_from(tmpl))
    bl, spec_b = tree_flatten(b)
    xl, spec_x0 = tree_flatten(x0)
    slots = [i for i, a in enumerate((a0, a1)) if isinstance(a, torch.Tensor)]
    flat = (*bl, *xl, *[(a0, a1)[i] for i in slots], *bops.tensors())
    call = Call(driver=driver, ops=bops, alg=alg, alg_rrule=alg_rrule or alg, space=space,
                 in_dims=in_dims, nb=len(bl), nx=len(xl), spec_b=spec_b, spec_x0=spec_x0,
                 shifts=(a0, a1), slots=slots, dtypes=[t.dtype for t in flat])
    out = _LinsolveBatched.apply(call, *flat)
    return tree_unflatten(list(out), call.spec_x), call.info


class _EigsolveBatched(torch.autograd.Function):
    """The batched eigsolve (``call.svd`` false) or GKL svdsolve."""

    @staticmethod
    def forward(ctx, call, *flat):
        nx = call.nx
        x0 = tree_unflatten([t.detach() for t in flat[:nx]], call.spec_x0)
        ds = call.ops.detached(flat[nx:])
        out = call.driver(call.ops.arg(ds), x0, call.howmany, call.which, call.alg, call.space,
                          in_dims=call.in_dims, **call.kw)
        vals, vecs, call.info = out[0], out[1:-1], out[-1]
        call.specs, leaves = [], []
        for v in vecs:
            vl, spec = tree_flatten(v)
            call.specs.append((len(vl), spec))
            leaves += vl
        ctx.call, ctx.ds = call, ds
        ctx.save_for_backward(vals, *leaves)
        return (vals, *leaves)

    @staticmethod
    def backward(ctx, gvals, *gl):
        call, ds = ctx.call, ctx.ds
        saved = [t.detach() for t in ctx.saved_tensors]
        vals, vecs, gvecs, q = saved[0], [], [], 1
        for k, spec in call.specs:
            vecs.append(tree_unflatten(saved[q:q + k], spec))
            gvecs.append(tree_unflatten(list(gl[q - 1:q - 1 + k]), spec))
            q += k
        grads = [None] * len(call.dtypes)
        if any(ctx.needs_input_grad[1 + call.nx:]):
            route = _svd.route if call.svd else _eig.route
            inners = []
            for p in range(vals.shape[0]):
                inners.append(route(call.howmany, call.which, call.alg, call.alg_rrule, call.space,
                                    call.ops.of(ds, p), vals[p], *[row(v, p) for v in vecs],
                                    gvals[p], *[row(g, p) for g in gvecs]))
            grads[call.nx:] = call.ops.cotangents(solve_inner_batched(inners, call.space))
        return _finish(grads, call.dtypes)


def _eig_vjp(driver, ops, x0, howmany, which, alg, alg_rrule, space, in_dims, svd, prepare,
             kw):
    bops = _Ops(ops, in_dims[0] is None, prepare)
    xl, spec_x0 = tree_flatten(x0)
    flat = (*xl, *bops.tensors())
    call = Call(driver=driver, ops=bops, howmany=howmany, which=which, alg=alg,
                 alg_rrule=alg_rrule, space=space, in_dims=in_dims, nx=len(xl), spec_x0=spec_x0,
                 svd=svd, kw=kw, dtypes=[t.dtype for t in flat])
    out = _EigsolveBatched.apply(call, *flat)
    vecs, q = [], 1
    for k, spec in call.specs:
        vecs.append(tree_unflatten(list(out[q:q + k]), spec))
        q += k
    return (out[0], *vecs, call.info)


def eigsolve_batched_vjp(driver, ops, x0, howmany, which, alg, alg_rrule, space, in_dims,
                         **kw):
    """The batched Lanczos or Arnoldi eigsolve ``driver`` as a
    ``torch.autograd.Function`` of ``x0`` and the tensors of the distinct
    operators (``ops`` the problems' resolved operators).  Returns ``(vals,
    vecs, info)``; the backward takes the rule ``alg_rrule`` picks, as
    ``ad/eigsolve.py`` does, all problems' inner solves in one batched
    call."""
    from ..ops.vector import tree_row

    tmpl = tree_row(x0, 0) if in_dims[1] == 0 else x0
    return _eig_vjp(driver, ops, x0, howmany, which, alg, alg_rrule, space, in_dims, False,
                    lambda o: o.with_adjoint_from(tmpl), kw)


def svdsolve_batched_vjp(driver, ops, x0, howmany, which, alg, alg_rrule, space, in_dims):
    """The batched GKL svdsolve ``driver`` as a ``torch.autograd.Function``
    of ``x0`` and the tensors of the distinct operators (``ops`` with their
    adjoints).  Returns ``(vals, lvecs, rvecs, info)``; the backward is
    ``ad/svdsolve.py``'s rule, all problems' inner solves in one batched
    call."""
    return _eig_vjp(driver, ops, x0, howmany, which, alg, alg_rrule, space, in_dims, True,
                    lambda o: o, {})
