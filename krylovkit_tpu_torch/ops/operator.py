"""Linear-operator protocol (counterpart of ``krylovkit_tpu/ops/operator.py``).

A :class:`LinearOperator` holds ``normal``/``adjoint`` callables on tensors.
:class:`StencilOperator` and :class:`GridStencilOperator` carry their
offsets and coefficients as static metadata, which makes them *fusable*: the
Lanczos fused expansion (``ops/fused_lanczos.py``) applies them inside its
kernel.  Their plain ``normal``/``adjoint`` are shift-and-add applies with
zero (Dirichlet) boundaries, the semantics of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "LinearOperator",
    "StencilOperator",
    "GridStencilOperator",
    "MatrixOperator",
    "as_operator",
    "as_generalized_pair",
    "concrete_start",
    "apply_shifted",
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


@dataclasses.dataclass(frozen=True)
class LinearOperator:
    """A linear map on tensors with an optional adjoint: ``normal(x) = A x``,
    ``adjoint(y) = Aᴴ y``."""

    normal: Callable[[torch.Tensor], torch.Tensor]
    adjoint: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.normal(x)

    def apply_adjoint(self, y: torch.Tensor) -> torch.Tensor:
        if self.adjoint is None:
            raise ValueError(
                "this operator has no adjoint; pass a (f, fadjoint) tuple or a matrix"
            )
        return self.adjoint(y)


def _shift_flat(xf: torch.Tensor, d: int) -> torch.Tensor:
    """``out[i] = xf[i + d]`` for ``0 <= i + d < n``, else 0."""
    n = xf.shape[0]
    out = torch.zeros_like(xf)
    if abs(d) >= n:
        return out
    if d >= 0:
        out[: n - d] = xf[d:]
    else:
        out[-d:] = xf[: n + d]
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

    def __init__(self, offsets, coeffs, normal=None, adjoint=None):
        offsets = tuple(int(d) for d in offsets)
        coeffs = _clean_coeffs(coeffs)
        object.__setattr__(self, "offsets", offsets)
        object.__setattr__(self, "coeffs", coeffs)
        object.__setattr__(self, "normal", normal or _stencil_apply_fn(offsets, coeffs))
        if adjoint is None:
            adjoint = _stencil_apply_fn(*_adjoint_stencil(offsets, coeffs))
        object.__setattr__(self, "adjoint", adjoint)


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

    def __init__(self, grid, offsets2, coeffs, normal=None, adjoint=None):
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


def apply_shifted(op: LinearOperator, x: torch.Tensor, a0, a1) -> torch.Tensor:
    """``a0·x + a1·A(x)`` (reference ``src/apply.jl:5-11``).  ``a0``/``a1``
    are Python numbers or 0-d tensors; as 0-d operands they never widen a
    vector's precision (a float64 shift on a float32 vector stays float32),
    only its kind (a complex shift makes a real vector complex)."""
    return a0 * x + a1 * op(x)


def probe_dtype(op: LinearOperator, x0: torch.Tensor) -> torch.dtype:
    """Scalar type of the problem (reference ``apply_scalartype``,
    ``src/apply.jl:26-36``), from one application to a ``meta`` copy of
    ``x0``: no arithmetic, and no count in ``numops``.  Operators that hold
    their data (a matrix, banded or ELL planes) answer from its dtype.  A callable
    that mixes the meta copy with tensors it holds cannot run on it; it is
    applied once to a zero vector instead (still not counted)."""
    from .banded import BandedOperator
    from .sparse import ELLOperator

    if isinstance(op, MatrixOperator):
        out = torch.promote_types(op.A.dtype, x0.dtype)
    elif isinstance(op, BandedOperator):
        out = torch.promote_types(op.diags.dtype, x0.dtype)
    elif isinstance(op, ELLOperator):
        out = torch.promote_types(op.vals.dtype, x0.dtype)
    else:
        out = _probe_apply(op.normal, x0).dtype
    return torch.promote_types(out, x0.dtype)


def _probe_apply(fn, x0: torch.Tensor) -> torch.Tensor:
    """``fn(x0)`` as a ``meta`` tensor (shape and dtype, no data): ``fn`` runs
    on a meta copy of ``x0``, or, when it holds tensors of its own, once on a
    zero vector."""
    try:
        return fn(torch.empty_like(x0, device="meta"))
    except (RuntimeError, NotImplementedError):
        return fn(torch.zeros_like(x0)).to("meta")


def probe_adjoint(op: LinearOperator, y0: torch.Tensor) -> torch.Tensor:
    """Shape and dtype of ``Aᴴ y0`` as a ``meta`` tensor, the domain template
    of a map whose start vector lives in the codomain (the JAX package asks
    ``jax.eval_shape(op.apply_adjoint, y0)``).  Not counted in ``numops``."""
    from .banded import BandedOperator

    if isinstance(op, MatrixOperator):
        dt = torch.promote_types(op.A.dtype, y0.dtype)
        return torch.empty((op.A.shape[1],) + tuple(y0.shape[1:]), dtype=dt, device="meta")
    if isinstance(op, BandedOperator):
        dt = torch.promote_types(op.diags.dtype, y0.dtype)
        return torch.empty(y0.shape, dtype=dt, device="meta")
    return _probe_apply(op.apply_adjoint, y0)


def require_adjoint(op: LinearOperator) -> LinearOperator:
    """``op`` if it has an adjoint.  The JAX package derives the adjoint of a
    bare callable by linear transposition; that needs differentiation through
    the callable, which is not ported."""
    if op.adjoint is None:
        raise NotImplementedError(
            "a bare callable has no adjoint: deriving one by linear "
            "transposition (with_adjoint_from) is not ported yet (ROADMAP.md "
            "queue 1, item 7); pass a (f, fadjoint) tuple or a matrix"
        )
    return op


def check_adjoint_compatibility(op: LinearOperator, x0: torch.Tensor, space=None) -> None:
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
    eps = torch.finfo(x0.dtype).eps
    if abs(a2 - aa) > (eps ** 0.5) * max(abs(a2), aa, 1e-30):
        raise ValueError(
            f"operator and its adjoint are not compatible: <u0, A A^H u0>/|u0|^2 "
            f"= {a2} but |A^H u0|^2/|u0|^2 = {aa} "
            "(reference src/factorizations/gkl.jl:192)"
        )
