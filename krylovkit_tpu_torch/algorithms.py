"""Algorithm configuration structs + global defaults (counterpart of
``krylovkit_tpu/algorithms.py``).

Frozen dataclasses carrying ``orth / krylovdim / maxiter / tol / eager /
verbosity`` (reference ``src/algorithms.jl:83-526``) and the mutable
``KrylovDefaults`` (``src/algorithms.jl:556-564``).  The default
orthogonalizer is ``cgs2``, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Union

from .info import WARN
from .ops.orthonormal import (
    ClassicalGramSchmidt,
    ClassicalGramSchmidt2,
    ClassicalGramSchmidtIR,
    ModifiedGramSchmidt,
    ModifiedGramSchmidt2,
    ModifiedGramSchmidtIR,
    Orthogonalizer,
    cgs,
    cgs2,
    cgsir,
    mgs,
    mgs2,
    mgsir,
)

__all__ = [
    "KrylovDefaults",
    "Lanczos",
    "BlockLanczos",
    "Arnoldi",
    "BiArnoldi",
    "GKL",
    "GolubYe",
    "CG",
    "MINRES",
    "GMRES",
    "BiCGStab",
    "LSMR",
    "EigSorter",
    "Orthogonalizer",
    "ClassicalGramSchmidt",
    "ClassicalGramSchmidt2",
    "ClassicalGramSchmidtIR",
    "ModifiedGramSchmidt",
    "ModifiedGramSchmidt2",
    "ModifiedGramSchmidtIR",
    "cgs",
    "mgs",
    "cgs2",
    "mgs2",
    "cgsir",
    "mgsir",
]


class KrylovDefaults:
    """Mutable module-wide defaults (reference ``src/algorithms.jl:556-564``)."""

    orth: Orthogonalizer = cgs2
    krylovdim: int = 30
    maxiter: int = 100
    blockkrylovdim: int = 100
    tol: float = 1e-12
    verbosity: int = WARN


def _orth_default():
    return KrylovDefaults.orth


@dataclasses.dataclass(frozen=True)
class _KrylovAlgorithm:
    """Shared fields of subspace algorithms (reference src/algorithms.jl:83-117)."""

    orth: Orthogonalizer = dataclasses.field(default_factory=_orth_default)
    krylovdim: int = dataclasses.field(
        default_factory=lambda: KrylovDefaults.krylovdim
    )
    maxiter: int = dataclasses.field(default_factory=lambda: KrylovDefaults.maxiter)
    tol: float = dataclasses.field(default_factory=lambda: KrylovDefaults.tol)
    eager: bool = False
    verbosity: int = dataclasses.field(
        default_factory=lambda: KrylovDefaults.verbosity
    )


@dataclasses.dataclass(frozen=True)
class Lanczos(_KrylovAlgorithm):
    """Lanczos for Hermitian eigenproblems (reference ``src/algorithms.jl:119-170``).

    ``reorth``: ``"full"`` (one full drift sweep per step) or ``"selective"``
    (Simon's ω-recurrence partial reorthogonalization: the sweep runs only
    when the estimated loss of orthogonality exceeds ``sqrt(eps)``; not with
    ``eager=True``)."""

    reorth: str = "full"


@dataclasses.dataclass(frozen=True)
class BlockLanczos(_KrylovAlgorithm):
    """Block Lanczos (reference ``src/algorithms.jl:172-229``)."""

    qr_tol: float = -1.0  # <0 → auto: eps(dtype)**(3/4)


@dataclasses.dataclass(frozen=True)
class GKL(_KrylovAlgorithm):
    """Golub-Kahan-Lanczos bidiagonalization (reference ``src/algorithms.jl:231-280``)."""


@dataclasses.dataclass(frozen=True)
class Arnoldi(_KrylovAlgorithm):
    """Arnoldi for general eigenproblems (reference ``src/algorithms.jl:282-335``)."""


@dataclasses.dataclass(frozen=True)
class BiArnoldi(_KrylovAlgorithm):
    """Two-sided Arnoldi (reference ``src/algorithms.jl:337-390``)."""


@dataclasses.dataclass(frozen=True)
class GolubYe(_KrylovAlgorithm):
    """Golub-Ye inverse-free Krylov (reference ``src/algorithms.jl:457-524``)."""


@dataclasses.dataclass(frozen=True)
class CG:
    """Conjugate Gradients (reference driver ``src/linsolve/cg.jl``)."""

    maxiter: int = dataclasses.field(default_factory=lambda: KrylovDefaults.maxiter)
    tol: float = dataclasses.field(default_factory=lambda: KrylovDefaults.tol)
    verbosity: int = dataclasses.field(
        default_factory=lambda: KrylovDefaults.verbosity
    )


@dataclasses.dataclass(frozen=True)
class MINRES:
    """MINRES for Hermitian indefinite systems."""

    maxiter: int = dataclasses.field(default_factory=lambda: KrylovDefaults.maxiter)
    tol: float = dataclasses.field(default_factory=lambda: KrylovDefaults.tol)
    verbosity: int = dataclasses.field(
        default_factory=lambda: KrylovDefaults.verbosity
    )


@dataclasses.dataclass(frozen=True)
class GMRES:
    """Restarted GMRES(m) (reference driver ``src/linsolve/gmres.jl``)."""

    orth: Orthogonalizer = dataclasses.field(default_factory=_orth_default)
    krylovdim: int = dataclasses.field(
        default_factory=lambda: KrylovDefaults.krylovdim
    )
    maxiter: int = dataclasses.field(default_factory=lambda: KrylovDefaults.maxiter)
    tol: float = dataclasses.field(default_factory=lambda: KrylovDefaults.tol)
    verbosity: int = dataclasses.field(
        default_factory=lambda: KrylovDefaults.verbosity
    )


@dataclasses.dataclass(frozen=True)
class BiCGStab:
    """BiCGStab (reference driver ``src/linsolve/bicgstab.jl``)."""

    maxiter: int = dataclasses.field(default_factory=lambda: KrylovDefaults.maxiter)
    tol: float = dataclasses.field(default_factory=lambda: KrylovDefaults.tol)
    verbosity: int = dataclasses.field(
        default_factory=lambda: KrylovDefaults.verbosity
    )


@dataclasses.dataclass(frozen=True)
class LSMR:
    """LSMR least-squares solver (reference ``src/lssolve/lsmr.jl``)."""

    orth: Orthogonalizer = dataclasses.field(default_factory=_orth_default)
    krylovdim: int = dataclasses.field(
        default_factory=lambda: KrylovDefaults.krylovdim
    )
    maxiter: int = dataclasses.field(default_factory=lambda: KrylovDefaults.maxiter)
    tol: float = dataclasses.field(default_factory=lambda: KrylovDefaults.tol)
    verbosity: int = dataclasses.field(
        default_factory=lambda: KrylovDefaults.verbosity
    )


@dataclasses.dataclass(frozen=True)
class EigSorter:
    """Custom eigenvalue sorting (reference ``src/eigsolve/eigsolve.jl:187-193``):
    ``by`` maps a tensor of eigenvalues to sort keys; ``rev=True`` sorts
    descending."""

    by: Callable
    rev: bool = False


Which = Union[str, EigSorter]
