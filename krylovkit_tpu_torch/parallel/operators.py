"""Benchmark operators (counterpart of ``krylovkit_tpu/parallel/operators.py``).

Both return fusable stencil operators: with ``(n/128, 128)`` float32
vectors the Lanczos driver runs the fused expansion kernel.  An operator
holds no data, so unlike the JAX builders these take no ``dtype``.  ``device``
(default ``"cuda"``) is checked here, so asking for a card that is not
there fails at construction.
"""

from __future__ import annotations

import torch

from ..ops.operator import GridStencilOperator, LinearOperator, StencilOperator, resolve_device

__all__ = ["laplacian_1d", "poisson_2d"]


def laplacian_1d(n: int, dirichlet: bool = True, device="cuda") -> LinearOperator:
    """``tridiag(-1, 2, -1)`` on the row-major flattening of the vector
    (BASELINE.json config 1).  Dirichlet: a :class:`StencilOperator` with
    offsets ``(-1, 0, 1)``.  Periodic: a plain operator that wraps around."""
    resolve_device(device)
    if dirichlet:
        return StencilOperator((-1, 0, 1), (-1.0, 2.0, -1.0))

    def apply(x):
        xf = x.reshape(-1)
        return (2 * xf - torch.roll(xf, 1) - torch.roll(xf, -1)).reshape(x.shape)

    return LinearOperator(apply, apply)


def poisson_2d(nx: int, ny: int, device="cuda") -> LinearOperator:
    """5-point 2-D Poisson operator on an ``(nx, ny)`` grid with zero
    boundaries (BASELINE.json config 2), as a :class:`GridStencilOperator`."""
    resolve_device(device)
    return GridStencilOperator(
        (nx, ny),
        ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)),
        (4.0, -1.0, -1.0, -1.0, -1.0),
    )
