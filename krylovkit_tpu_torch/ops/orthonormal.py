"""Gram-Schmidt orthogonalization strategies (counterpart of
``krylovkit_tpu/ops/orthonormal.py``).

Six strategies as in the reference (``src/algorithms.jl:17-80``, kernels in
``src/orthonormal.jl:370-489``): cgs, mgs, cgs2, mgs2, cgsir, mgsir, with the
DGKS criterion ``η = 1/sqrt(2)``.  The active length ``k`` is a host ``int``;
the CGS sweep reads the same bucketed row prefix of the basis as the JAX
package (``basis.buckets_for``), so both contract over the same rows.  With
``basis.use_pallas_projections`` on, the sweep is unbucketed: the live-row
kernels take the whole basis and the active length.  Vectors and bases may
be pytrees (``ops/vector.py``); the sweeps then run leaf by leaf.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from . import basis as bs
from .vector import STANDARD, VectorSpace, device_of, scalartype, tree_map

__all__ = [
    "Orthogonalizer",
    "ClassicalGramSchmidt",
    "ModifiedGramSchmidt",
    "ClassicalGramSchmidt2",
    "ModifiedGramSchmidt2",
    "ClassicalGramSchmidtIR",
    "ModifiedGramSchmidtIR",
    "cgs",
    "mgs",
    "cgs2",
    "mgs2",
    "cgsir",
    "mgsir",
    "orthogonalize",
    "orthonormalize",
]

_ETA_DGKS = 1 / math.sqrt(2.0)  # reference default η (src/algorithms.jl:76-80)


@dataclasses.dataclass(frozen=True)
class Orthogonalizer:
    """Base class of the orthogonalizer configs (``src/algorithms.jl:17-80``)."""


@dataclasses.dataclass(frozen=True)
class ClassicalGramSchmidt(Orthogonalizer):
    pass


@dataclasses.dataclass(frozen=True)
class ModifiedGramSchmidt(Orthogonalizer):
    pass


@dataclasses.dataclass(frozen=True)
class ClassicalGramSchmidt2(Orthogonalizer):
    pass


@dataclasses.dataclass(frozen=True)
class ModifiedGramSchmidt2(Orthogonalizer):
    pass


@dataclasses.dataclass(frozen=True)
class ClassicalGramSchmidtIR(Orthogonalizer):
    eta: float = _ETA_DGKS
    maxiter: int = 4


@dataclasses.dataclass(frozen=True)
class ModifiedGramSchmidtIR(Orthogonalizer):
    eta: float = _ETA_DGKS
    maxiter: int = 4


cgs = ClassicalGramSchmidt()
mgs = ModifiedGramSchmidt()
cgs2 = ClassicalGramSchmidt2()
mgs2 = ModifiedGramSchmidt2()
cgsir = ClassicalGramSchmidtIR()
mgsir = ModifiedGramSchmidtIR()


def _sub(w, u):
    return tree_map(lambda a, b: a - b, w, u)


def _coeff_dtype(V, w, space):
    dt = scalartype(V, w)
    if space.real_inner:
        dt = dt.to_real()
    return dt


def _cgs_sweep(w, V, k: int, space):
    kmax = bs.capacity(V)
    if bs.use_pallas_projections:
        c = bs.project(V, w, k, space)
        return _sub(w, bs.unproject(V, c, k)), c.to(_coeff_dtype(V, w, space))
    B = bs.bucket_for(k, kmax) if space.inner_fn is None else kmax
    Vb = bs.prefix(V, B)
    c = bs.project(Vb, w, k, space)
    w = _sub(w, bs.unproject(Vb, c))
    return w, torch.nn.functional.pad(c, (0, kmax - B)).to(_coeff_dtype(V, w, space))


def _mgs_sweep(w, V, k: int, space):
    c = torch.zeros(bs.capacity(V), dtype=_coeff_dtype(V, w, space), device=device_of(w))
    for j in range(k):
        vj = bs.get(V, j)
        cj = space.inner(vj, w)
        w = tree_map(lambda a, b: a - cj * b, w, vj)
        c[j] = cj
    return w, c


def orthogonalize(
    w,
    V,
    k: int,
    orth: Orthogonalizer = cgs2,
    space: VectorSpace = STANDARD,
) -> Tuple[object, torch.Tensor]:
    """Orthogonalize ``w`` against ``V[:k]``.  Returns ``(w_perp, c)`` with
    ``w = w_perp + V c`` (``c`` zero for ``j >= k``).  Reference:
    ``orthogonalize!!`` (``src/orthonormal.jl:370-489``)."""
    if isinstance(orth, ClassicalGramSchmidt):
        return _cgs_sweep(w, V, k, space)
    if isinstance(orth, ModifiedGramSchmidt):
        return _mgs_sweep(w, V, k, space)
    if isinstance(orth, (ClassicalGramSchmidt2, ModifiedGramSchmidt2)):
        sweep = _cgs_sweep if isinstance(orth, ClassicalGramSchmidt2) else _mgs_sweep
        w, c1 = sweep(w, V, k, space)
        w, c2 = sweep(w, V, k, space)
        return w, c1 + c2
    if isinstance(orth, (ClassicalGramSchmidtIR, ModifiedGramSchmidtIR)):
        sweep = _cgs_sweep if isinstance(orth, ClassicalGramSchmidtIR) else _mgs_sweep
        nrm_before = space.norm(w)
        w, c = sweep(w, V, k, space)
        nrm_after = space.norm(w)
        i = 0
        # DGKS drift criterion (reference src/orthonormal.jl:452-489): refine
        # while the sweep removed more than a factor η of the norm
        while i < orth.maxiter and bool(nrm_after < orth.eta * nrm_before):
            w, dc = sweep(w, V, k, space)
            c = c + dc
            nrm_before, nrm_after = nrm_after, space.norm(w)
            i += 1
        return w, c
    raise TypeError(f"unknown orthogonalizer {orth!r}")


def orthonormalize(
    w,
    V,
    k: int,
    orth: Orthogonalizer = cgs2,
    space: VectorSpace = STANDARD,
) -> Tuple[object, torch.Tensor, torch.Tensor]:
    """Orthogonalize then normalize: ``(v, beta, c)`` with ``w = V c + beta·v``
    and ``‖v‖ = 1``; on breakdown (``beta == 0``) ``v`` is zero.  Reference:
    ``orthonormalize!!`` (``src/orthonormal.jl:520-527``)."""
    w, c = orthogonalize(w, V, k, orth, space)
    beta = space.norm(w)
    safe = torch.where(beta > 0, beta, torch.ones_like(beta))
    v = tree_map(lambda l: torch.where(beta > 0, l / safe, 0 * l), w)
    return v, beta, c
