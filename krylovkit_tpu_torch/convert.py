"""Build the port's inputs from plain numpy arrays and tuples.

A Krylov solve has no weights: what two runs share is the operator's data,
the start vector and the algorithm settings.  These helpers take plain
numbers (e.g. a stencil's ``offsets``/``coeffs``, or
``dataclasses.asdict`` of an algorithm struct with ``orth`` given by name)
and return the port's objects on ``device``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .algorithms import Lanczos
from .ops import orthonormal as on
from .ops.operator import GridStencilOperator, MatrixOperator, StencilOperator, resolve_device

__all__ = [
    "stencil_from_arrays",
    "grid_stencil_from_arrays",
    "matrix_from_numpy",
    "vector_from_numpy",
    "lanczos_from_dict",
]

_ORTH_BY_NAME = {
    **{name: getattr(on, name) for name in ("cgs", "mgs", "cgs2", "mgs2", "cgsir", "mgsir")},
    **{
        cls.__name__: cls()
        for cls in (
            on.ClassicalGramSchmidt, on.ModifiedGramSchmidt, on.ClassicalGramSchmidt2,
            on.ModifiedGramSchmidt2, on.ClassicalGramSchmidtIR, on.ModifiedGramSchmidtIR,
        )
    },
}


def stencil_from_arrays(offsets, coeffs, device="cuda") -> StencilOperator:
    """A :class:`StencilOperator` from its offsets and coefficients."""
    resolve_device(device)
    return StencilOperator(tuple(int(d) for d in offsets), tuple(coeffs))


def grid_stencil_from_arrays(grid, offsets2, coeffs, device="cuda") -> GridStencilOperator:
    """A :class:`GridStencilOperator` from its grid, ``(dy, dx)`` offsets and
    coefficients."""
    resolve_device(device)
    return GridStencilOperator(tuple(grid), tuple(tuple(o) for o in offsets2), tuple(coeffs))


def matrix_from_numpy(A, device="cuda") -> MatrixOperator:
    """A :class:`MatrixOperator` holding ``A`` on ``device``."""
    return MatrixOperator(torch.as_tensor(np.asarray(A), device=resolve_device(device)))


def vector_from_numpy(x, device="cuda") -> torch.Tensor:
    """``x`` as a tensor on ``device``, same shape and dtype."""
    return torch.as_tensor(np.asarray(x), device=resolve_device(device))


def lanczos_from_dict(fields: dict) -> Lanczos:
    """A :class:`Lanczos` from its fields.  ``orth`` is a name (``"cgs2"``,
    ``"ClassicalGramSchmidt2"``, ...; the IR variants with their default
    ``eta``/``maxiter``) or an orthogonalizer of this package."""
    fields = dict(fields)
    extra = set(fields) - {f.name for f in dataclasses.fields(Lanczos)}
    if extra:
        raise ValueError(f"unknown Lanczos fields: {sorted(extra)}")
    orth = fields.get("orth")
    if isinstance(orth, str):
        if orth not in _ORTH_BY_NAME:
            raise ValueError(f"unknown orthogonalizer {orth!r}")
        fields["orth"] = _ORTH_BY_NAME[orth]
    elif orth is not None and not isinstance(orth, on.Orthogonalizer):
        raise ValueError(
            "orth must be an orthogonalizer name such as 'cgs2' or an "
            f"Orthogonalizer, got {orth!r}"
        )
    return Lanczos(**fields)
