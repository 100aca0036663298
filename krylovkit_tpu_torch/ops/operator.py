"""Linear-operator protocol (counterpart of ``krylovkit_tpu/ops/operator.py``).

A :class:`LinearOperator` holds ``normal``/``adjoint`` callables on vectors
(tensors or pytrees of them, ``ops/vector.py``).  The tensors an operator
holds (:meth:`LinearOperator.tensors`: a matrix, a
:class:`ParametricOperator`'s ``params``, banded or ELL planes; none for a
callable or a stencil) are what the differentiable solves (``ad/``)
differentiate, in the order of the JAX package's pytree registrations;
:meth:`LinearOperator.with_tensors` rebuilds the operator on others.  A
bare callable's adjoint is derived by ``torch.autograd``
(:meth:`LinearOperator.with_adjoint_from`), across the ranks too for a
sharded map: its edge, halo and psum collectives carry their transposes
(``ops/collectives.py``).
:class:`StencilOperator` and :class:`GridStencilOperator` carry their
offsets and coefficients as static metadata, which makes them *fusable*: the
Lanczos fused expansion (``ops/fused_lanczos.py``) applies them inside its
kernel.  Their plain ``normal``/``adjoint`` are shift-and-add applies with
zero (Dirichlet) boundaries, the semantics of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from .collectives import strict_collectives
from .vector import scalartype, tree_flatten, tree_leaves, tree_map, tree_unflatten, zerovector

__all__ = [
    "LinearOperator",
    "ParametricOperator",
    "TypedOperator",
    "StencilOperator",
    "GridStencilOperator",
    "MatrixOperator",
    "as_operator",
    "as_generalized_pair",
    "concrete_start",
    "apply_shifted",
    "apply_shifted_batched",
    "probe_dtype",
    "probe_adjoint",
    "require_adjoint",
    "check_adjoint_compatibility",
    "resolve_device",
]


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; a CUDA device without a card is an error."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def _derived_adjoint(f, x_template, params=None):
    """``y ↦ Aᴴ y`` for the C-linear map ``f``: the vector-Jacobian product
    of ``f`` at a zero vector shaped like ``x_template``, by
    ``torch.autograd.grad``.  torch's vector-Jacobian product of ``x ↦ A x``
    is already ``Aᴴ y`` (its cotangents are conjugate Wirtinger
    derivatives), so unlike the JAX package's ``conj(fᵀ(conj y))`` no
    conjugation surrounds it.  Each call evaluates ``f`` once more.

    On a sharded space ``f`` acts on this rank's block and its collectives
    (``MeshAxis.psum``, ``MeshAxis.edges``, the halo round of
    ``ShardedELLOperator``) differentiate to their transposes, so the result
    is this rank's block of ``Aᴴ y`` across the ranks; every rank must call
    it alike.  A collective with no derivative raises
    (``collectives.strict_collectives``) rather than drop its term.  The
    result records a graph only where gradients are enabled and a tensor of
    ``params`` requires grad (a ``ParametricOperator``'s adjoint inside an
    operator cotangent)."""
    leaves, spec = tree_flatten(zerovector(x_template))

    def adj(y):
        create = torch.is_grad_enabled() and any(
            isinstance(p, torch.Tensor) and p.requires_grad for p in tree_leaves(params))
        with torch.enable_grad(), strict_collectives():
            xs = [l.detach().requires_grad_(True) for l in leaves]
            out = f(tree_unflatten(xs, spec))
            outs, cots = [], []
            for lo, ly in zip(tree_leaves(out), tree_leaves(y)):
                if lo.requires_grad:
                    outs.append(lo)
                    cots.append(ly)
            grads = (torch.autograd.grad(outs, xs, cots, allow_unused=True, create_graph=create)
                     if outs else [None] * len(xs))
        return tree_unflatten([torch.zeros_like(x) if g is None else g
                               for x, g in zip(xs, grads)], spec)

    return adj


@dataclasses.dataclass(frozen=True)
class LinearOperator:
    """A linear map on vectors with an optional adjoint: ``normal(x) = A x``,
    ``adjoint(y) = Aᴴ y``.  ``normal_stack`` and ``adjoint_stack``, where an
    operator has them, map a ``(p, ...)`` stack of tensor vectors to the
    stack of their images in one pass, each row the bits of ``normal`` /
    ``adjoint`` on it: the batched drivers (``solvers/batched.py``) apply a
    shared sharded operator so, with one collective for all rows."""

    normal: Callable[[Any], Any]
    adjoint: Optional[Callable[[Any], Any]] = None
    normal_stack: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    adjoint_stack: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

    def __call__(self, x):
        return self.normal(x)

    def apply_adjoint(self, y):
        if self.adjoint is None:
            raise ValueError(
                "this operator has no adjoint; pass a (f, fadjoint) tuple, a matrix, "
                "or derive one with with_adjoint_from(x_template)"
            )
        return self.adjoint(y)

    def tensors(self) -> tuple:
        """The tensors the operator holds, which a differentiable solve
        differentiates (none for a callable)."""
        return ()

    def with_tensors(self, tensors, plain: bool = False) -> "LinearOperator":
        """The same operator on ``tensors`` (as many as :meth:`tensors`).
        With ``plain`` its applies are differentiable PyTorch: an operator
        whose apply is a hand-written kernel swaps in the kernel's plain
        version."""
        return self

    def with_adjoint_from(self, x_template) -> "LinearOperator":
        """``self`` if it has an adjoint, else an operator whose adjoint is
        derived from ``normal`` by ``torch.autograd`` on vectors shaped like
        ``x_template`` (``_derived_adjoint``).  ``normal`` must then be
        differentiable PyTorch: the kernel wrappers refuse a tensor that
        requires grad."""
        if self.adjoint is not None:
            return self
        return LinearOperator(self.normal, _derived_adjoint(self.normal, x_template))


@dataclasses.dataclass(frozen=True)
class TypedOperator(LinearOperator):
    """A callable operator whose scalar type is known: ``probe_dtype``
    answers ``dtype`` without an apply (the pullbacks' bordered maps).  With
    ``domain`` (the shape of a domain vector) ``probe_adjoint`` needs no
    apply either."""

    dtype: torch.dtype = None
    domain: Optional[Tuple[int, ...]] = None


def _shift_flat(xf: torch.Tensor, d: int) -> torch.Tensor:
    """``out[..., i] = xf[..., i + d]`` for ``0 <= i + d < n``, else 0,
    along the last axis (a flat vector, or each row of a stack)."""
    n = xf.shape[-1]
    out = torch.zeros_like(xf)
    if abs(d) >= n:
        return out
    if d >= 0:
        out[..., : n - d] = xf[..., d:]
    else:
        out[..., -d:] = xf[..., : n + d]
    return out


def _stencil_apply_fn(offsets, coeffs):
    """Constant stencil on the row-major flattening of a vector of any
    shape, zero outside ``[0, n)``; terms added in offset order."""

    def apply(x):
        xf = x.reshape(-1)
        y = None
        for coef, d in zip(coeffs, offsets):
            t = coef * _shift_flat(xf, d)
            y = t if y is None else y + t
        return y.reshape(x.shape)

    return apply


def _adjoint_stencil(offsets, coeffs):
    adj_off = tuple(-d for d in reversed(offsets))
    adj_cf = tuple(
        (c.conjugate() if isinstance(c, complex) else c) for c in reversed(coeffs)
    )
    return adj_off, adj_cf


def _clean_coeffs(coeffs):
    return tuple(
        complex(c).real if complex(c).imag == 0 else complex(c) for c in coeffs
    )


@dataclasses.dataclass(frozen=True)
class StencilOperator(LinearOperator):
    """Constant-coefficient stencil ``(A x)[i] = Σ_p coeffs[p]·x[i + offsets[p]]``
    on the row-major flattening of the vector, zero outside ``[0, n)``.
    The adjoint is the reversed stencil with conjugated coefficients."""

    offsets: Tuple[int, ...] = ()
    coeffs: Tuple[float, ...] = ()

    def __init__(self, offsets, coeffs, normal=None, adjoint=None, normal_stack=None,
                 adjoint_stack=None):
        offsets = tuple(int(d) for d in offsets)
        coeffs = _clean_coeffs(coeffs)
        object.__setattr__(self, "offsets", offsets)
        object.__setattr__(self, "coeffs", coeffs)
        object.__setattr__(self, "normal", normal or _stencil_apply_fn(offsets, coeffs))
        if adjoint is None:
            adjoint = _stencil_apply_fn(*_adjoint_stencil(offsets, coeffs))
        object.__setattr__(self, "adjoint", adjoint)
        object.__setattr__(self, "normal_stack", normal_stack)
        object.__setattr__(self, "adjoint_stack", adjoint_stack)


def _grid_stencil_apply_fn(grid, offsets2, coeffs):
    """2-D grid stencil with zero boundaries on both axes, on any layout whose
    row-major flattening is the ``(grid_rows, grid_cols)`` grid."""
    gr_, gc_ = grid
    n = gr_ * gc_

    def apply(x):
        if x.numel() != n:
            raise ValueError(f"vector of {x.numel()} entries on a {gr_}x{gc_} grid")
        xf = x.reshape(-1)
        ix = torch.arange(n, device=x.device) % gc_
        y = None
        for c, (dy, dx) in zip(coeffs, offsets2):
            # the flat range covers dy; the column mask stops dx wrapping
            t = _shift_flat(xf, dy * gc_ + dx)
            if dx:
                valid = (ix + dx >= 0) & (ix + dx < gc_)
                t = torch.where(valid, t, torch.zeros((), dtype=t.dtype, device=t.device))
            t = c * t
            y = t if y is None else y + t
        return y.reshape(x.shape)

    return apply


@dataclasses.dataclass(frozen=True)
class GridStencilOperator(LinearOperator):
    """Constant-coefficient stencil on the row-major flattening of a
    ``(grid_rows, grid_cols)`` grid with ``(dy, dx)`` offsets and zero
    boundaries on both axes: an ``ix ± 1`` neighbour never wraps into the
    next grid row."""

    grid: Tuple[int, int] = ()
    offsets2: Tuple[Tuple[int, int], ...] = ()
    coeffs: Tuple[float, ...] = ()

    def __init__(self, grid, offsets2, coeffs, normal=None, adjoint=None, normal_stack=None,
                 adjoint_stack=None):
        grid = (int(grid[0]), int(grid[1]))
        offsets2 = tuple((int(dy), int(dx)) for dy, dx in offsets2)
        coeffs = _clean_coeffs(coeffs)
        object.__setattr__(self, "grid", grid)
        object.__setattr__(self, "offsets2", offsets2)
        object.__setattr__(self, "coeffs", coeffs)
        object.__setattr__(
            self, "normal", normal or _grid_stencil_apply_fn(grid, offsets2, coeffs)
        )
        if adjoint is None:
            adj_off = tuple((-dy, -dx) for dy, dx in reversed(offsets2))
            adj_cf = tuple(
                (c.conjugate() if isinstance(c, complex) else c) for c in reversed(coeffs)
            )
            adjoint = _grid_stencil_apply_fn(grid, adj_off, adj_cf)
        object.__setattr__(self, "adjoint", adjoint)
        object.__setattr__(self, "normal_stack", normal_stack)
        object.__setattr__(self, "adjoint_stack", adjoint_stack)


@dataclasses.dataclass(frozen=True)
class MatrixOperator(LinearOperator):
    """Dense-matrix operator ``x ↦ A @ x``."""

    A: torch.Tensor = None

    def __init__(self, A: torch.Tensor):
        if A.ndim != 2:
            raise ValueError(f"operator array must be 2-D, got shape {tuple(A.shape)}")
        object.__setattr__(self, "A", A)
        object.__setattr__(self, "normal", self._normal)
        object.__setattr__(self, "adjoint", self._adjoint)

    def _normal(self, x):
        return _promoted_matmul(self.A, x)

    def _adjoint(self, y):
        return _promoted_matmul(self.A.conj().T, y)

    def tensors(self) -> tuple:
        return (self.A,)

    def with_tensors(self, tensors, plain: bool = False) -> "MatrixOperator":
        return MatrixOperator(tensors[0])


@dataclasses.dataclass(frozen=True)
class ParametricOperator(LinearOperator):
    """Operator ``x ↦ apply_fn(params, x)`` whose parameters (a tensor or a
    pytree of tensors) are explicit: a differentiable solve gives their
    gradient, which a callable's closure would hide (the JAX package's
    ``ParametricOperator``).  ``adjoint_fn(params, y)`` is ``Aᴴ y``, or
    ``None``.

    Example::

        op = ParametricOperator(lambda g, x: g * x, params=g)
        vals, vecs, info = kt.eigsolve(op, x0, 1, "SR", ishermitian=True)
    """

    apply_fn: Callable = None
    params: Any = None
    adjoint_fn: Optional[Callable] = None

    def __init__(self, apply_fn, params, adjoint_fn=None):
        object.__setattr__(self, "apply_fn", apply_fn)
        object.__setattr__(self, "params", params)
        object.__setattr__(self, "adjoint_fn", adjoint_fn)
        object.__setattr__(self, "normal", lambda x: apply_fn(params, x))
        object.__setattr__(
            self, "adjoint",
            (lambda y: adjoint_fn(params, y)) if adjoint_fn is not None else None,
        )

    def tensors(self) -> tuple:
        return tuple(tree_leaves(self.params))

    def with_tensors(self, tensors, plain: bool = False) -> "ParametricOperator":
        _, spec = tree_flatten(self.params)
        return ParametricOperator(self.apply_fn, tree_unflatten(tensors, spec), self.adjoint_fn)

    def with_adjoint_from(self, x_template) -> "ParametricOperator":
        # params stay explicit: the derived adjoint takes them as an argument
        if self.adjoint is not None:
            return self
        f = self.apply_fn

        def adjoint_fn(params, y):
            return _derived_adjoint(lambda x: f(params, x), x_template, params)(y)

        return ParametricOperator(f, self.params, adjoint_fn)


def _promoted_matmul(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` in the promoted type of the two (a real matrix applied to a
    complex vector, as ``jnp.matmul`` promotes; ``torch.matmul`` raises)."""
    dt = torch.promote_types(A.dtype, x.dtype)
    return A.to(dt) @ x.to(dt)


def as_operator(A, device=None) -> LinearOperator:
    """Normalize an operator encoding into a :class:`LinearOperator`: an
    operator, a ``(f, fadjoint)`` tuple, a callable, or a matrix (tensor or
    numpy array, the latter placed on ``device``)."""
    if isinstance(A, LinearOperator):
        return A
    if isinstance(A, tuple):
        if len(A) != 2:
            raise ValueError("tuple operator must be (f, fadjoint)")
        f, fadj = A
        return LinearOperator(as_operator(f, device).normal, as_operator(fadj, device).normal)
    if isinstance(A, torch.Tensor):
        return MatrixOperator(A)
    if isinstance(A, np.ndarray):
        return MatrixOperator(torch.as_tensor(A, device=resolve_device(device or "cuda")))
    if callable(A):
        return LinearOperator(A, None)
    raise TypeError(f"cannot make an operator of {type(A).__name__}")


def concrete_start(A) -> torch.Tensor:
    """The JAX package's start vector for a concrete matrix ``A``:
    ``default_rng(42)`` normals over ``A.shape[1]`` in ``A``'s type, on
    ``A``'s device (a numpy matrix: the card)."""
    if isinstance(A, torch.Tensor):
        dt, dev = A.dtype, A.device
    else:
        dt, dev = torch.from_numpy(np.asarray(A)).dtype, resolve_device("cuda")
    x = np.random.default_rng(42).standard_normal(A.shape[1])
    return torch.as_tensor(x, device=dev).to(dt.to_real()).to(dt)


def as_generalized_pair(AB, device=None) -> Tuple[LinearOperator, Optional[LinearOperator]]:
    """Normalize the ``(A, B)`` encoding of a generalized eigenproblem
    (reference ``genapply``, ``src/apply.jl:22-23``): ``(A, B)``, ``(A,
    None)`` or a bare ``A``, each by :func:`as_operator`; ``B`` ``None``
    means the identity."""
    if isinstance(AB, tuple) and len(AB) == 2:
        A, B = AB
        return as_operator(A, device), (as_operator(B, device) if B is not None else None)
    return as_operator(AB, device), None


def apply_shifted(op: LinearOperator, x, a0, a1):
    """``a0·x + a1·A(x)`` leaf by leaf (reference ``src/apply.jl:5-11``).
    ``a0``/``a1`` are Python numbers or 0-d tensors; as 0-d operands they
    never widen a vector's precision (a float64 shift on a float32 vector
    stays float32), only its kind (a complex shift makes a real vector
    complex)."""
    return tree_map(lambda lx, la: a0 * lx + a1 * la, x, op(x))


def apply_shifted_batched(apply: Callable, X, a0, a1):
    """``a0·X + a1·A(X)`` for a ``(P, ...)`` stack ``X`` (a tree of stacks
    leaf by leaf), where ``apply`` maps the stack to its rows' images (a
    batched operator apply); ``a0`` and ``a1`` are shared by the rows and
    enter as in :func:`apply_shifted`, so each row is that function's
    result on it."""
    return tree_map(lambda lx, la: a0 * lx + a1 * la, X, apply(X))


def probe_dtype(op: LinearOperator, x0) -> torch.dtype:
    """Scalar type of the problem (reference ``apply_scalartype``,
    ``src/apply.jl:26-36``), from one application to a ``meta`` copy of
    ``x0``: no arithmetic, and no count in ``numops``.  Operators that hold
    their data (a matrix, banded or ELL planes) or state their type
    (:class:`TypedOperator`) answer without an apply, and a
    :class:`ParametricOperator` runs on meta copies of its parameters too.
    A callable that mixes the meta copy with tensors it holds cannot run on
    it; it is applied once to a zero vector instead (still not counted)."""
    from .banded import BandedOperator
    from .sparse import ELLOperator

    xdt = scalartype(x0)
    if isinstance(op, MatrixOperator):
        out = torch.promote_types(op.A.dtype, xdt)
    elif isinstance(op, BandedOperator):
        out = torch.promote_types(op.diags.dtype, xdt)
    elif isinstance(op, ELLOperator):
        out = torch.promote_types(op.vals.dtype, xdt)
    elif isinstance(op, TypedOperator):
        out = op.dtype
    elif isinstance(op, ParametricOperator):
        out = scalartype(_probe_parametric(op, x0))
    else:
        out = scalartype(_probe_apply(op.normal, x0))
    return torch.promote_types(out, xdt)


def _meta(l):
    return torch.empty_like(l, device="meta") if isinstance(l, torch.Tensor) else l


def _probe_parametric(op: "ParametricOperator", x0):
    """``apply_fn`` on ``meta`` copies of both the parameters and ``x0``:
    the parameters are the tensors a :class:`ParametricOperator` mixes with
    the vector, so the probe runs no arithmetic.  A function that still
    cannot run on meta tensors takes :func:`_probe_apply`."""
    try:
        return op.apply_fn(tree_map(_meta, op.params), tree_map(_meta, x0))
    except (RuntimeError, NotImplementedError):
        return _probe_apply(op.normal, x0)


def _probe_apply(fn, x0):
    """``fn(x0)`` as ``meta`` tensors (shapes and dtypes, no data): ``fn``
    runs on a meta copy of ``x0``, or, when it holds tensors of its own, once
    on a zero vector."""
    try:
        return fn(tree_map(_meta, x0))
    except (RuntimeError, NotImplementedError):
        return tree_map(lambda l: l.to("meta"), fn(zerovector(x0)))


def probe_adjoint(op: LinearOperator, y0):
    """Shapes and dtypes of ``Aᴴ y0`` as ``meta`` tensors, the domain
    template of a map whose start vector lives in the codomain (the JAX
    package asks ``jax.eval_shape(op.apply_adjoint, y0)``).  Not counted in
    ``numops``."""
    from .banded import BandedOperator

    if isinstance(op, MatrixOperator):
        dt = torch.promote_types(op.A.dtype, scalartype(y0))
        return torch.empty((op.A.shape[1],) + tuple(y0.shape[1:]), dtype=dt, device="meta")
    if isinstance(op, TypedOperator) and op.domain is not None:
        dt = torch.promote_types(op.dtype, scalartype(y0))
        return torch.empty(op.domain, dtype=dt, device="meta")
    if isinstance(op, BandedOperator):
        dt = torch.promote_types(op.diags.dtype, scalartype(y0))
        return torch.empty(y0.shape, dtype=dt, device="meta")
    return _probe_apply(op.apply_adjoint, y0)


def require_adjoint(op: LinearOperator, x_template, space=None) -> LinearOperator:
    """``op`` with an adjoint, as the JAX front-ends of ``svdsolve`` and
    ``lssolve`` make it: a bare callable gets ``with_adjoint_from(x_template)``
    (exact by construction, unchecked; ``x_template`` lives in the codomain,
    so the derived adjoint needs a square map); an ``(f, fadjoint)`` pair
    from the caller passes :func:`check_adjoint_compatibility` in ``space``
    (the standard inner product by default); a matrix's, a stencil's or a
    banded operator's adjoint is exact and unchecked."""
    if op.adjoint is None:
        return op.with_adjoint_from(x_template)
    if type(op) is LinearOperator or getattr(type(op), "pair_from_caller", False):
        check_adjoint_compatibility(op, x_template, space)
    return op


def check_adjoint_compatibility(op: LinearOperator, x0, space=None) -> None:
    """Adjoint-consistency guard for ``(f, fadjoint)`` pairs given by the
    caller (reference GKL initialization, ``src/factorizations/gkl.jl:188-192``):
    with ``β₀ = ‖u₀‖``, ``α = ‖Aᴴu₀‖/β₀`` and ``α² = ⟨u₀, A(Aᴴu₀)⟩/β₀²`` must
    agree, else the pair is not an operator and its adjoint and GKL/LSMR
    would return wrong answers silently.  Two applies, not counted."""
    from .vector import STANDARD

    space = space or STANDARD
    b0 = float(space.norm(x0))
    if b0 == 0.0:
        raise ValueError("initial vector should not have norm zero")
    v = op.apply_adjoint(x0)
    aa = (float(space.norm(v)) / b0) ** 2
    a2 = complex(space.inner(x0, op.normal(v))) / (b0 * b0)
    eps = torch.finfo(scalartype(x0)).eps
    if abs(a2 - aa) > (eps ** 0.5) * max(abs(a2), aa, 1e-30):
        raise ValueError(
            f"operator and its adjoint are not compatible: <u0, A A^H u0>/|u0|^2 "
            f"= {a2} but |A^H u0|^2/|u0|^2 = {aa} "
            "(reference src/factorizations/gkl.jl:192)"
        )
