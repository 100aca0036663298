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

:func:`orthonormalize_batched` orthonormalizes one vector of each problem of
a batched solve against that problem's basis: each problem's result is
:func:`orthonormalize`'s, and a cgs or cgs2 sweep makes one
``basis.project_batched`` and one ``basis.unproject_batched`` call for all.
On a sharded space a sweep all-reduces the ``(P, kmax)`` coefficients of all
problems at once, and so do the norms of the new vectors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from . import basis as bs
from .vector import STANDARD, VectorSpace, device_of, norm_batched, psum, scalartype, tree_map

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
    "orthogonalize_batched",
    "orthonormalize_batched",
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


def _cgs_sweep_batched(ws, Vs, ks, space):
    """:func:`_cgs_sweep` of each problem, as a list of ``(w, c)``; the
    coefficients of all problems are finished at once (on a sharded space
    one all-reduce of the ``(P, kmax)`` stack).  With the projection flag on
    the two halves of every problem's sweep are one batched call each; off,
    each problem's local partials over its bucket prefix, zero-padded to
    ``kmax``."""
    if bs.use_pallas_projections:
        cs = bs.project_batched(Vs, ws, ks, space)
        ys = bs.unproject_batched(Vs, cs, ks)
        return [(_sub(w, y), c.to(_coeff_dtype(V, w, space)))
                for w, V, c, y in zip(ws, Vs, cs, ys)]
    kmax = bs.capacity(Vs[0])
    local = dataclasses.replace(space, psum_axis=None)
    Bs = [bs.bucket_for(k, kmax) if space.inner_fn is None else kmax for k in ks]
    parts = [torch.nn.functional.pad(bs.project(bs.prefix(V, B), w, k, local), (0, kmax - B))
             for w, V, k, B in zip(ws, Vs, ks, Bs)]
    C = psum(torch.stack(parts), space.psum_axis)
    out = []
    for w, V, B, c in zip(ws, Vs, Bs, C):
        # a fresh copy: a row of C need not start where the one-problem
        # operand does, and the card's product may round otherwise there
        w = _sub(w, bs.unproject(bs.prefix(V, B), c[:B].clone()))
        out.append((w, c.to(_coeff_dtype(V, w, space))))
    return out


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
    return _normalize(w, space) + (c,)


def _normalize(w, space, beta=None):
    """``(w/‖w‖, ‖w‖)``, a zero vector where the norm is zero; ``beta`` the
    norm where it is known."""
    beta = space.norm(w) if beta is None else beta
    safe = torch.where(beta > 0, beta, torch.ones_like(beta))
    return tree_map(lambda l: torch.where(beta > 0, l / safe, 0 * l), w), beta


def orthogonalize_batched(ws, Vs, ks, orth: Orthogonalizer = cgs2,
                          space: VectorSpace = STANDARD) -> list:
    """:func:`orthogonalize` of ``ws[i]`` against ``Vs[i][:ks[i]]`` for each
    problem ``i``, as a list of ``(w_perp, c)``.  cgs and cgs2 run their
    sweeps for all problems at once (:func:`_cgs_sweep_batched`); the other
    orthogonalizers run problem by problem."""
    if type(orth) is ClassicalGramSchmidt:
        return _cgs_sweep_batched(ws, Vs, ks, space)
    if type(orth) is ClassicalGramSchmidt2:
        first = _cgs_sweep_batched(ws, Vs, ks, space)
        second = _cgs_sweep_batched([w for w, _ in first], Vs, ks, space)
        return [(w, c1 + c2) for (_, c1), (w, c2) in zip(first, second)]
    return [orthogonalize(w, V, k, orth, space) for w, V, k in zip(ws, Vs, ks)]


def orthonormalize_batched(ws, Vs, ks, orth: Orthogonalizer = cgs2,
                           space: VectorSpace = STANDARD) -> list:
    """:func:`orthonormalize` of each problem, as a list of ``(v, beta,
    c)``, its sweeps through :func:`orthogonalize_batched` and the norms of
    all problems through ``norm_batched`` (on a sharded space one
    all-reduce)."""
    outs = orthogonalize_batched(ws, Vs, ks, orth, space)
    betas = norm_batched([w for w, _ in outs], space)
    return [_normalize(w, space, beta) + (c,) for (w, c), beta in zip(outs, betas)]
