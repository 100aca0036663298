"""Vector space of tensors and pytrees of tensors — the PyTorch counterpart
of ``krylovkit_tpu/ops/vector.py``.

A vector is one tensor of any shape (real or complex), or a tuple, list or
dict of them, nested (the reference's "any object with ``inner``, ``norm``,
``scale!!``, ``add!!``"; the JAX package's pytree).  The main path uses one
``(n/128, 128)`` float32 tensor, the layout the fused Lanczos kernel reads;
a plain tensor takes the same operations as it would without the tree
helpers, which check for a tensor first.  Inner products are one sum of
per-leaf ``vdot``s.  Custom inner products (the reference's
``InnerProductVec``) and the "real inner product" of ``realeigsolve`` are
carried by a frozen :class:`VectorSpace`, as in the JAX package.  A sharded
space (``psum_axis``, a :class:`~.collectives.MeshAxis`) finishes every
inner product with one all-reduce over the ranks that hold the vector's
blocks; :func:`inner_batched` finishes the ``(P,)`` inner products of a
batched solve's problems with one.

The tree helpers (``tree_map``, ``tree_leaves``, ``tree_flatten``,
``tree_unflatten``) are built on ``torch.utils._pytree`` and live here only.
A batched solve holds the vectors of its ``P`` problems as a stack: a tree
whose every leaf carries the problem axis first (``jax.vmap``'s layout);
:func:`tree_row`, :func:`tree_rows`, :func:`tree_stack`, :func:`stack_size`
and :func:`alloc_batched` take and make such stacks leaf by leaf.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
from torch.utils import _pytree as _pt

from .collectives import as_axis

__all__ = [
    "VectorSpace",
    "STANDARD",
    "REAL",
    "inner",
    "inner_batched",
    "norm",
    "norm_batched",
    "scale",
    "add",
    "zerovector",
    "scalartype",
    "real_scalartype",
    "from_template",
    "randn_like",
    "rounded",
    "tree_map",
    "tree_leaves",
    "tree_flatten",
    "tree_unflatten",
    "tree_row",
    "tree_rows",
    "tree_stack",
    "stack_size",
    "alloc_batched",
    "astype",
    "device_of",
    "psum",
]

PyTree = Any


def tree_leaves(x: PyTree) -> list:
    """The tensors of ``x`` in flattening order (``[x]`` for a tensor; a
    plain tuple leaf by leaf here, without ``torch.utils._pytree``'s
    per-call cost, in the same order)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if type(x) is tuple:
        return [l for e in x for l in tree_leaves(e)]
    return _pt.tree_leaves(x)


def tree_flatten(x: PyTree):
    """``(leaves, spec)``; :func:`tree_unflatten` rebuilds ``x`` from them."""
    return _pt.tree_flatten(x)


def tree_unflatten(leaves, spec) -> PyTree:
    return _pt.tree_unflatten(list(leaves), spec)


def tree_map(fn: Callable, x: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` leaf by leaf over ``x`` and trees of its structure; a tensor
    ``x`` is one call of ``fn``, a plain tuple (the pullbacks' ``(vector,
    scalar)`` and ``(w, x)`` vectors) mapped element by element here, as
    ``torch.utils._pytree`` maps it, without its per-call cost."""
    if isinstance(x, torch.Tensor):
        return fn(x, *rest)
    if type(x) is tuple and all(type(r) is tuple and len(r) == len(x) for r in rest):
        return tuple(tree_map(fn, *args) for args in zip(x, *rest))
    return _pt.tree_map(fn, x, *rest)


def tree_row(X: PyTree, i: int) -> PyTree:
    """Row ``i`` of a stack: every leaf's ``l[i]``, a view, so an in-place
    write to the row lands in the stack."""
    return tree_map(lambda l: l[i], X)


def tree_rows(X: PyTree) -> list:
    """The rows of a stack (views), as a list of :func:`tree_row`."""
    return [tree_row(X, i) for i in range(stack_size(X))]


def tree_stack(xs) -> PyTree:
    """The trees ``xs`` (one structure) stacked leaf by leaf along a new
    leading axis: one tree whose leaves are ``(len(xs), ...)``."""
    return tree_map(lambda *ls: torch.stack(ls), *xs)


def stack_size(X: PyTree, name: str = "the vector") -> int:
    """The leading (problem) axis every leaf of ``X`` carries; a
    ``ValueError`` where a leaf has none or the leaves disagree, as
    ``jax.vmap`` refuses inconsistent sizes."""
    leaves = tree_leaves(X)
    if not leaves or any(not isinstance(l, torch.Tensor) or l.ndim == 0 for l in leaves):
        raise ValueError(f"{name} has no leading problem axis")
    sizes = sorted({l.shape[0] for l in leaves})
    if len(sizes) != 1:
        raise ValueError(f"the leaves of {name} disagree on the problem count: {sizes}")
    return sizes[0]


def alloc_batched(template: PyTree, P: int, rows: int, dtype=None, device=None) -> PyTree:
    """A zeroed ``(P, rows) + leaf.shape`` stack for every leaf of the
    vector ``template`` (on ``device``, default the leaf's): the bases of
    ``P`` problems, problem ``p``'s basis its :func:`tree_row`."""
    return tree_map(lambda l: torch.zeros((P, rows) + tuple(l.shape), dtype=dtype or l.dtype,
                                          device=device or l.device), template)


def astype(x: PyTree, dtype: torch.dtype) -> PyTree:
    """Every leaf of ``x`` in ``dtype``."""
    return tree_map(lambda l: l.to(dtype), x)


def device_of(x: PyTree) -> torch.device:
    """The device of the first leaf (a solve runs on it)."""
    return tree_leaves(x)[0].device


@dataclasses.dataclass(frozen=True)
class VectorSpace:
    """Inner-product space the solver works in.

    Attributes:
      inner_fn: optional custom inner product ``(x, y) -> scalar tensor``,
        conjugate-linear in ``x``.  ``None`` is the Euclidean inner product
        summed over all leaves.
      real_inner: use ``real(inner(x, y))`` (complex space treated as real).
      psum_axis: the mesh axis (``parallel.make_mesh(...).axis("vec")``, or a
        process group, made a :class:`~.collectives.MeshAxis` here) over
        which every rank holds a block of the vector's rows (SPMD): inner
        products, and the batched projections of ``ops.basis``, compute
        local partials and finish with one all-reduce over it.
    """

    inner_fn: Optional[Callable[[PyTree, PyTree], torch.Tensor]] = None
    real_inner: bool = False
    psum_axis: Any = None

    def __post_init__(self):
        if self.psum_axis is not None:
            object.__setattr__(self, "psum_axis", as_axis(self.psum_axis))

    def inner(self, x: PyTree, y: PyTree) -> torch.Tensor:
        return self.finish_inner(psum(self.local_inner(x, y), self.psum_axis))

    def local_inner(self, x: PyTree, y: PyTree) -> torch.Tensor:
        """This rank's partial of :meth:`inner` (all of it unsharded)."""
        return self.inner_fn(x, y) if self.inner_fn is not None else _tree_inner(x, y)

    def finish_inner(self, ip: torch.Tensor) -> torch.Tensor:
        """:meth:`inner` from the partials' sum over the ranks."""
        return torch.real(ip) if self.real_inner else ip

    def norm(self, x: PyTree) -> torch.Tensor:
        nrm2 = torch.real(self.inner(x, x))
        return torch.sqrt(torch.clamp(nrm2, min=0))


STANDARD = VectorSpace()
REAL = VectorSpace(real_inner=True)


def psum(t: torch.Tensor, axis) -> torch.Tensor:
    """The sum of the local partial ``t`` over the :class:`MeshAxis`
    ``axis`` (one all-reduce; ``t`` itself when ``axis`` is ``None``)."""
    return t if axis is None else axis.psum(t)


def _inner(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Euclidean inner product ``Σ conj(x)·y`` of two tensors, 0-d."""
    dt = torch.promote_types(x.dtype, y.dtype)
    return torch.vdot(x.reshape(-1).to(dt), y.reshape(-1).to(dt))


def _tree_inner(x: PyTree, y: PyTree) -> torch.Tensor:
    """Euclidean inner product over all leaves, conjugate-linear in ``x``:
    one ``vdot`` per leaf, summed."""
    if isinstance(x, torch.Tensor):
        return _inner(x, y)
    parts = [_inner(a, b) for a, b in zip(tree_leaves(x), tree_leaves(y))]
    return sum(parts[1:], parts[0])


def inner(x, y, space: VectorSpace = STANDARD) -> torch.Tensor:
    return space.inner(x, y)


def norm(x, space: VectorSpace = STANDARD) -> torch.Tensor:
    return space.norm(x)


def inner_batched(X, Y, space: VectorSpace = STANDARD) -> torch.Tensor:
    """``space.inner(X[p], Y[p])`` for every ``p`` of two ``(P, ...)``
    stacks (or lists of vectors), as a ``(P,)`` tensor.  Each row's local
    partial is the one ``space.inner`` takes, stacked, and on a sharded
    space one all-reduce of the ``(P,)`` partials finishes them all.  Each
    entry thus has the bits of ``space.inner`` of its row (over more than two
    ranks the ring may add the ranks' partials in another order): a batched
    reduction would sum in another order, and near the float32 floor of a
    solve that moves its counts."""
    local = space.inner_fn or _tree_inner
    ip = psum(torch.stack([local(x, y) for x, y in zip(X, Y)]), space.psum_axis)
    return torch.real(ip) if space.real_inner else ip


def norm_batched(X, space: VectorSpace = STANDARD) -> torch.Tensor:
    """``space.norm(X[p])`` for every ``p`` of a ``(P, ...)`` stack (or a
    list of vectors), each with the bits of ``space.norm`` of its row."""
    return torch.sqrt(torch.clamp(torch.real(inner_batched(X, X, space)), min=0))


def scale(x: PyTree, a) -> PyTree:
    """``a * x`` (reference VectorInterface ``scale``)."""
    return tree_map(lambda l: a * l, x)


def add(y: PyTree, x: PyTree, a=1, b=1) -> PyTree:
    """``b*y + a*x`` — the reference's ``add!!(y, x, a, b)`` convention."""
    return tree_map(lambda ly, lx: b * ly + a * lx, y, x)


def zerovector(x: PyTree, dtype=None) -> PyTree:
    return tree_map(lambda l: torch.zeros_like(l, dtype=dtype or l.dtype), x)


def scalartype(*trees) -> torch.dtype:
    """Joint scalar dtype of the leaves of one or more vectors (the
    value-domain part of the reference's ``apply_scalartype``,
    ``src/apply.jl:26-36``)."""
    leaves = [l for t in trees for l in tree_leaves(t)]
    out = leaves[0].dtype
    for t in leaves[1:]:
        out = torch.promote_types(out, t.dtype)
    return out


def real_scalartype(dtype: torch.dtype) -> torch.dtype:
    """Real counterpart of a (possibly complex) floating dtype."""
    return dtype.to_real()


def from_template(template: PyTree, flat: torch.Tensor) -> PyTree:
    """Unravel a flat tensor into the structure, shapes and dtypes of
    ``template``."""
    leaves, spec = tree_flatten(template)
    out, pos = [], 0
    for l in leaves:
        out.append(flat[pos: pos + l.numel()].reshape(l.shape).to(l.dtype))
        pos += l.numel()
    return tree_unflatten(out, spec)


def randn_like(generator: torch.Generator, x: PyTree, dtype=None) -> PyTree:
    """Standard normal vector with the structure of ``x``, drawn from
    ``generator`` leaf by leaf; a complex leaf gets normal real and
    imaginary parts."""

    def leaf(l):
        dt = dtype or l.dtype
        draw = lambda: torch.randn(l.shape, generator=generator, dtype=dt.to_real(),  # noqa: E731
                                   device=l.device)
        return torch.complex(draw(), draw()) if dt.is_complex else draw()

    return tree_map(leaf, x)


def rounded(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to the real type ``dtype``, as a Python float.  A host
    test ``float(t) <= rounded(tol, t.dtype)`` then decides as the JAX
    package's device comparison in ``dtype`` does."""
    return float(torch.tensor(v, dtype=dtype))
