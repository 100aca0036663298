"""Public iterator API over the Krylov factorizations (counterpart of
``krylovkit_tpu/factorizations/iterators.py``).

The reference's iterator protocol (``src/factorizations/krylov.jl:30-134``):
``initialize`` / ``expand`` / ``shrink`` and the accessors ``basis``,
``rayleighquotient``, ``residual``, ``normres``, so the user steps the
factorization (``src/factorizations/lanczos.jl:110-127``).  The iterators are
frozen dataclasses; their states are the factorizations' own
(``KrylovState``, ``Lanczos3State``, ``GKLState``, ``BlockLanczosState``, a
``(right, left)`` pair of ``KrylovState`` for BiArnoldi).  As everywhere in
the port, an expansion writes the state's buffers in place: a state is
current until it, or a state made from it, is expanded.

Where the problem is complex and the start vector real, the basis takes the
problem's type (the solvers do the same, ``solvers/lanczos.py``); the JAX
package keeps the start's type and drops the imaginary part of ``A v``.
Every iterator takes pytree vectors and a sharded space (``psum_axis``), as
its factorization does; the fused GKL expansion is not used here.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..ops import basis as bs
from ..ops import orthonormal as on
from ..ops.operator import as_operator, probe_adjoint, probe_dtype
from ..ops.vector import STANDARD, VectorSpace, astype, device_of, rounded, scalartype
from . import blocklanczos as bf
from . import gkl as gf
from . import krylov as kf

__all__ = [
    "LanczosIterator",
    "ArnoldiIterator",
    "GKLIterator",
    "BlockLanczosIterator",
    "BiArnoldiIterator",
    "basis",
    "rayleighquotient",
    "residual",
    "normres",
]


def _operator(A, x):
    """``A`` as an operator; a numpy matrix goes to ``x``'s device."""
    return as_operator(A, device=device_of(x))


def _start(x0, cdt):
    """``x0`` in the problem's complex type where ``x0`` is real and the
    problem complex; else ``x0``."""
    return astype(x0, cdt) if cdt.is_complex and not scalartype(x0).is_complex else x0


@dataclasses.dataclass(frozen=True)
class _KrylovIterator:
    """Shared machinery of the Lanczos and Arnoldi iterators."""

    op: Any
    x0: Any
    krylovdim: int = 30
    orth: on.Orthogonalizer = on.cgs2
    space: VectorSpace = STANDARD
    hermitian_expand: bool = False

    def _cdt(self):
        return probe_dtype(_operator(self.op, self.x0), self.x0)

    def initialize(self) -> kf.KrylovState:
        cdt = self._cdt()
        return kf.initialize(_start(self.x0, cdt), self.krylovdim, cdt, self.space)

    def expand(self, state: kf.KrylovState) -> kf.KrylovState:
        fn = kf.expand_hermitian if self.hermitian_expand else kf.expand
        return fn(_operator(self.op, self.x0).normal, state, self.orth, self.space)

    def shrink(self, state: kf.KrylovState, k: int) -> kf.KrylovState:
        """Truncate to the first ``k`` vectors: ``H`` keeps rows ``<= k`` of
        columns ``< k`` and ``β = |H[k, k-1]|`` (reference ``shrink!``,
        ``src/factorizations/lanczos.jl:273-291``).  The basis is shared."""
        H = state.H.clone()
        H[k + 1:, :] = 0
        H[:, k:] = 0
        beta = state.H[k, max(k - 1, 0)].abs()
        return kf.KrylovState(state.V, H, int(k), beta)


@dataclasses.dataclass(frozen=True)
class LanczosIterator(_KrylovIterator):
    """Hermitian 3-term recurrence + drift sweep (reference
    ``src/factorizations/lanczos.jl``).

    With ``keepvecs=False`` it runs the pure 3-term recurrence with O(1)
    vector storage: no stored basis, only the rolling ``(v_{k-1}, v_k)`` pair
    (reference ``src/factorizations/lanczos.jl:133-144``).  Like the
    reference (``:137-141``) this is refused for reorthogonalizing
    strategies, which need the full basis."""

    hermitian_expand: bool = True
    keepvecs: bool = True

    def __post_init__(self):
        if not self.keepvecs and not isinstance(
            self.orth, (on.ClassicalGramSchmidt, on.ModifiedGramSchmidt)
        ):
            raise ValueError(
                "keepvecs=False requires a non-reorthogonalizing strategy "
                "(cgs or mgs) — reference src/factorizations/lanczos.jl:137-141"
            )

    def initialize(self):
        if self.keepvecs:
            return super().initialize()
        cdt = self._cdt()
        return kf.initialize_3term(_start(self.x0, cdt), self.krylovdim, cdt, self.space)

    def expand(self, state):
        if self.keepvecs:
            return super().expand(state)
        return kf.expand_3term(_operator(self.op, self.x0).normal, state, self.space)

    def shrink(self, state, k):
        if self.keepvecs:
            return super().shrink(state, k)
        raise ValueError(
            "cannot shrink a keepvecs=False factorization (no stored basis) — "
            "reference src/factorizations/lanczos.jl:273-291"
        )


@dataclasses.dataclass(frozen=True)
class ArnoldiIterator(_KrylovIterator):
    """Full orthogonalization against the basis (reference
    ``src/factorizations/arnoldi.jl``)."""

    hermitian_expand: bool = False


@dataclasses.dataclass(frozen=True)
class GKLIterator:
    """Golub-Kahan-Lanczos bidiagonalization iterator (reference
    ``src/factorizations/gkl.jl``); a bare callable's adjoint is derived
    (``with_adjoint_from``)."""

    op: Any
    x0: Any  # codomain (left) starting vector
    krylovdim: int = 30
    orth: on.Orthogonalizer = on.cgs2
    space: VectorSpace = STANDARD

    def _op(self):
        return _operator(self.op, self.x0).with_adjoint_from(self.x0)

    def initialize(self) -> gf.GKLState:
        op = self._op()
        cdt = scalartype(probe_adjoint(op, self.x0), self.x0)
        return gf.initialize(op, _start(self.x0, cdt), self.krylovdim, cdt, self.space)

    def expand(self, state: gf.GKLState) -> gf.GKLState:
        return gf.expand(self._op(), state, self.orth, self.space)


@dataclasses.dataclass(frozen=True)
class BlockLanczosIterator:
    """Block Lanczos iterator (reference ``src/factorizations/blocklanczos.jl``)."""

    op: Any
    X0: Any  # stacked starting block (a pytree: every leaf stacked)
    krylovdim: int = 30
    qr_tol: float = -1.0  # < 0: eps**(3/4) of the problem's real type
    space: VectorSpace = STANDARD

    def _qr_tol(self, cdt):
        rdt = cdt.to_real()
        if self.qr_tol >= 0:
            return rounded(self.qr_tol, rdt)
        return float(torch.tensor(torch.finfo(rdt).eps, dtype=rdt) ** 0.75)

    def initialize(self) -> bf.BlockLanczosState:
        cdt = probe_dtype(_operator(self.op, self.X0), bs.get(self.X0, 0))
        return bf.initialize(_start(self.X0, cdt), self.krylovdim, cdt, self._qr_tol(cdt),
                             self.space)

    def expand(self, state: bf.BlockLanczosState) -> bf.BlockLanczosState:
        return bf.expand(_operator(self.op, self.X0).normal, state, self._qr_tol(state.H.dtype),
                         self.space)


@dataclasses.dataclass(frozen=True)
class BiArnoldiIterator:
    """Pair of Arnoldi factorizations for ``A`` and ``Aᴴ`` expanded in
    lock-step (reference ``src/factorizations/biarnoldi.jl:1-83``).  The
    state is a ``(right, left)`` tuple of ``KrylovState``."""

    op: Any
    v0: Any
    w0: Any
    krylovdim: int = 30
    orth: on.Orthogonalizer = on.cgs2
    space: VectorSpace = STANDARD

    def _op(self):
        return _operator(self.op, self.v0).with_adjoint_from(self.v0)

    def initialize(self):
        cdt = probe_dtype(self._op(), self.v0)
        return (
            kf.initialize(_start(self.v0, cdt), self.krylovdim, cdt, self.space),
            kf.initialize(_start(self.w0, cdt), self.krylovdim, cdt, self.space),
        )

    def expand(self, state):
        op = self._op()
        fV, fW = state
        fV = kf.expand(op.normal, fV, self.orth, self.space)
        fW = kf.expand(op.apply_adjoint, fW, self.orth, self.space)
        return fV, fW


# ---- accessors (reference src/factorizations/krylov.jl:30-92) ----

def basis(state):
    """The stacked basis of a factorization state (``V``; for GKL read
    ``.U`` and ``.V`` for the two sides)."""
    return state.V


def rayleighquotient(state):
    """The projected matrix buffer (active block ``[:k, :k]``)."""
    if isinstance(state, gf.GKLState):
        return state.B
    return state.H


def residual(state):
    """The normalized residual direction: the next basis vector slot."""
    if isinstance(state, gf.GKLState):
        return bs.get(state.U, state.k)
    if isinstance(state, bf.BlockLanczosState):
        return state.X
    if isinstance(state, kf.Lanczos3State):
        return state.v_cur
    return bs.get(state.V, state.k)


def normres(state):
    """Residual norm β of the factorization."""
    return state.beta
