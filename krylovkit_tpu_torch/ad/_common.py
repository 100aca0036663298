"""What the three differentiable solves share: the routing test, the
detached operator of a forward solve, and the operator cotangent.

An operator's differentiable inputs are the tensors it holds
(``LinearOperator.tensors``).  Its cotangent is ``torch.autograd.grad`` of
its applies with respect to fresh copies of those tensors, with the
operator rebuilt in its plain form (``with_tensors(..., plain=True)``): a
hand-written kernel's launch records no graph, so an operator whose apply is
a kernel is differentiated through the kernel's plain version, which is
what XLA computes for the JAX package off the TPU.  The solves themselves
run on the detached operator and still launch the kernels.

On a sharded space (``VectorSpace(psum_axis=...)``) every rank runs the
backward alike: the adjoint solves reduce through the space, the operator's
collectives differentiate to their transposes (``ops/collectives.py``),
and each rank's cotangent is the derivative of the global loss with respect
to its own copy of each input, as each device's is in the JAX package's
``shard_map``: a rank's block of a sharded input, and a rank's partial of a
replicated one (``a0``, ``a1``, a replicated parameter), which the caller
sums over the ranks (one ``dist.all_reduce``, as a JAX caller sums with
``psum``).  The cotangents a rank gives the solve's outputs are taken as the
global loss's; a loss reduced through the space's psum reaches them summed
over the ranks (``MeshAxis.psum``), so ``D`` times.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..ops.collectives import strict_collectives
from ..ops.operator import TypedOperator
from ..ops.vector import STANDARD, VectorSpace, psum, tree_leaves

__all__ = ["Call", "Inner", "SplitOperator", "split_operator", "split_apply_batched",
           "needs_grad", "refuse_grad", "detached", "operator_cotangent", "adjoint_operator",
           "solve_inner", "real_safe", "row", "euclidean"]


class Call:
    """The non-tensor arguments of one differentiable solve, and what its
    forward learns (output structure, ``info``).  ``info`` is not
    differentiable, so it leaves the ``torch.autograd.Function`` outside
    its outputs."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


@dataclasses.dataclass(frozen=True)
class SplitOperator(TypedOperator):
    """A pullback's map whose apply ends in inner products of ``space`` (the
    bordered systems' ``⟨v, x⟩``, the coupled SVD system's projections):
    ``local(x)`` gives the image before them and their local partials
    (``space.local_inner``, a list), ``finish(y, sums)`` the image from the
    partials' sums over the ranks.  One apply sums each partial in one
    all-reduce, as ``space.inner`` would; a batched driver's stack apply of
    several (``solvers/batched.py:_Operators``) sums every problem's
    partials in one all-reduce."""

    local: Callable = None
    finish: Callable = None
    space: Any = None


def split_operator(local, finish, space, dtype) -> SplitOperator:
    """The :class:`SplitOperator` of ``local`` and ``finish`` in ``space``."""
    def split_normal(x):
        y, parts = local(x)
        return finish(y, [space.finish_inner(psum(p, space.psum_axis)) for p in parts])

    return SplitOperator(split_normal, None, dtype=dtype, local=local, finish=finish,
                         space=space)


def split_apply_batched(ops, rows):
    """``[o.normal(x) for o, x in zip(ops, rows)]`` for :class:`SplitOperator`
    maps of one sharded space: every row's partials summed in one
    all-reduce (each a copy: a row of an all-reduced stack enters no
    product as a view)."""
    locs = [o.local(x) for o, x in zip(ops, rows)]
    space = ops[0].space
    sums = psum(torch.stack([torch.stack(parts) for _, parts in locs]), space.psum_axis)
    return [o.finish(y, [space.finish_inner(s.clone()) for s in row])
            for o, (y, _), row in zip(ops, locs, sums)]


def _requires_grad(op, vectors) -> bool:
    ops = op if isinstance(op, list) else [op] if op is not None else []
    tensors = [t for o in ops for t in o.tensors()]
    tensors += [l for v in vectors for l in tree_leaves(v)]
    return any(isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def needs_grad(op, *vectors) -> bool:
    """True when gradients are enabled and a tensor of ``op`` (an operator,
    or a list of them: a batch's operators) or a leaf of one of ``vectors``
    (vectors, stacks of them, shift scalars) requires grad: the solve then
    goes through its ``torch.autograd.Function``."""
    return torch.is_grad_enabled() and _requires_grad(op, vectors)


def refuse_grad(what: str, op, *vectors) -> None:
    """Raise ``NotImplementedError`` when :func:`needs_grad` holds for a
    front-end with no differentiation rule: the JAX package cannot
    reverse-differentiate it either (its ``lax.while_loop`` has no
    transpose), and an unrolled autograd graph through every apply is not a
    substitute."""
    if needs_grad(op, *vectors):
        raise NotImplementedError(
            f"{what} has no differentiation rule (nor has the JAX package's): an input "
            "requires grad; differentiate eigsolve, linsolve or svdsolve, or detach the "
            "inputs or run under torch.no_grad()"
        )


def detached(op, tensors=None):
    """``op`` on detached copies of its tensors (or of ``tensors``): the
    operator of a forward or backward solve, which records no graph and
    which the kernel wrappers accept."""
    ts = op.tensors() if tensors is None else tensors
    if not ts:
        return op
    return op.with_tensors([t.detach() for t in ts])


def operator_cotangent(op, terms):
    """Gradients of the tensors of ``op`` that require grad, ``None`` for the
    others: the sum over ``terms`` of the vector-Jacobian products of
    ``t ↦ op_t.normal(v)`` (``side == "normal"``) or ``t ↦
    op_t.apply_adjoint(v)`` (``"adjoint"``) at the cotangent ``cot``, for
    ``(side, v, cot)`` in ``terms``, in torch's (conjugate) convention."""
    ts = op.tensors()
    want = [t.requires_grad for t in ts]
    if not any(want):
        return [None] * len(ts)
    with torch.enable_grad(), strict_collectives():
        fresh = [t.detach().requires_grad_(w) for t, w in zip(ts, want)]
        opg = op.with_tensors(fresh, plain=True)
        outs, cots = [], []
        for side, v, cot in terms:
            y = opg.normal(v) if side == "normal" else opg.apply_adjoint(v)
            for ly, lc in zip(tree_leaves(y), tree_leaves(cot)):
                if ly.requires_grad:
                    outs.append(ly)
                    cots.append(real_safe(lc, ly.dtype))
        inputs = [t for t, w in zip(fresh, want) if w]
        grads = (torch.autograd.grad(outs, inputs, cots, allow_unused=True)
                 if outs else [None] * len(inputs))
    it = iter(grads)
    out = []
    for t, w in zip(ts, want):
        g = next(it) if w else None
        out.append(torch.zeros_like(t) if w and g is None else g)
    return out


def euclidean(space) -> VectorSpace:
    """The standard inner product over the ranks of ``space``: the Gram
    matrices of the Sylvester pullbacks are Euclidean whatever the solve's
    inner product, as in the JAX package, and on a sharded space they are
    all-reduced (the JAX package's ``bs.gram`` sums only the local rows
    inside ``shard_map``, ROADMAP queue 3)."""
    return STANDARD if space.psum_axis is None else VectorSpace(psum_axis=space.psum_axis)


def real_safe(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` in ``dtype``, the complex → real truncation made explicit (the
    JAX package's ``_astype_real_safe``: the imaginary parts cancel for a
    real primal)."""
    if torch.is_complex(x) and not dtype.is_complex:
        x = torch.real(x)
    return x.to(dtype)


def row(stacked, i: int):
    """Row ``i`` of every leaf of a stacked pytree."""
    from ..ops.vector import tree_map

    return tree_map(lambda l: l[i], stacked)


def adjoint_operator(op, dtype: torch.dtype):
    """``Aᴴ`` as the operator of an adjoint solve in ``dtype``: the adjoint
    planes of a banded operator, the self-adjoint 1-D Laplacian, the
    conjugate transpose of a matrix (operators that a batched driver applies
    to a stack in one launch or one product), else ``op``'s adjoint as a
    typed callable, which keeps a sharded operator's stack applies swapped
    (``adjoint_stack`` as its ``normal_stack``: one halo all-reduce for all
    rows of a batched adjoint solve).  Each applies as ``op.apply_adjoint``
    does."""
    from ..ops.banded import BandedOperator
    from ..ops.operator import MatrixOperator, TypedOperator
    from ..ops.stencil_1d import Laplacian1DOperator

    if type(op) is BandedOperator and op.adj is not None:
        return op.adj
    if type(op) is Laplacian1DOperator:
        return op
    if type(op) is MatrixOperator:
        return MatrixOperator(op.A.conj().T)
    return TypedOperator(op.apply_adjoint, op.normal, op.adjoint_stack, op.normal_stack,
                         dtype=dtype)


class Inner:
    """The Krylov solves of one problem's pullback, and what the rule makes
    of them.  ``kind`` ``"linsolve"``: ``problems`` are ``(operator, rhs,
    x0)`` of ``(a0 + a1·A) x = rhs`` (the shifts ``shifts = (a0, a1)``);
    ``"eigsolve"``: ``(operator, w0, howmany, which)`` Arnoldi eigsolves,
    whose eigenvectors the rule takes.  ``alg`` solves them all, and
    ``finish(solutions)`` gives the operator-cotangent terms
    (:func:`operator_cotangent`).  The one-problem rules solve them one by
    one (:func:`solve_inner`), a batched rule all problems' at once
    (``ad/batched.py``)."""

    def __init__(self, kind: str, alg, problems, finish, shifts=None):
        self.kind, self.alg, self.problems, self.finish = kind, alg, problems, finish
        self.shifts = shifts


def solve_inner(inner: Inner, space):
    """The terms of one problem's pullback, its solves one by one."""
    if inner.kind == "linsolve":
        from ..solvers.linsolve import _linsolve_impl

        a0, a1 = inner.shifts
        sols = [_linsolve_impl(A, rhs, x0, a0, a1, inner.alg, space)[0]
                for A, rhs, x0 in inner.problems]
    else:
        from ..solvers.arnoldi import eigsolve_arnoldi

        sols = [eigsolve_arnoldi(A, w0, n, which, inner.alg, space)[1]
                for A, w0, n, which in inner.problems]
    return inner.finish(sols)
