"""Benchmark operators and their sharded forms (counterpart of
``krylovkit_tpu/parallel/operators.py``).

``laplacian_1d`` and ``poisson_2d`` return fusable stencil operators: with
``(n/128, 128)`` float32 vectors the Lanczos driver runs the fused expansion
kernel.  An operator holds no data, so unlike the JAX builders these take no
``dtype``.  ``device`` (default ``"cuda"``) is checked here, so asking for a
card that is not there fails at construction.

The sharded forms apply to this rank's block of a vector split over a mesh
axis (``parallel/mesh.py``): they exchange edge rows with the neighbouring
ranks (zeros at the ends: the Dirichlet boundary), apply on the haloed
strip and keep its interior.  Each applies to a ``(p, ...)`` stack of
blocks, the vectors of the problems of a batched solve
(``LinearOperator.normal_stack``), with every row's edges in one
all-reduce; its one-vector apply is that of a stack of one.
"""

from __future__ import annotations

import torch

from ..ops.collectives import as_axis
from ..ops.operator import GridStencilOperator, LinearOperator, StencilOperator, resolve_device
from .mesh import VECTOR_AXIS

__all__ = ["laplacian_1d", "poisson_2d", "shard_local_stencil", "sharded_laplacian_1d"]


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


def sharded_laplacian_1d(n: int, mesh, axis: str = VECTOR_AXIS) -> LinearOperator:
    """``tridiag(-1, 2, -1)`` of length ``n`` on this rank's block of a
    vector split over ``mesh``'s axis ``axis`` (any layout: the row-major
    flattening of the block is its part of the chain).  Each apply brings
    one element from either neighbour in one all-reduce; a stack of ``p``
    blocks (``normal_stack``) brings every row's two in one.  A plain
    (non-fusable) operator, as the JAX package's."""
    ax = mesh.axis(axis)

    def rows(X, lead: int):
        """``X`` as ``(p, block)`` rows, its ``lead`` leading axes the stack."""
        Xf = X.reshape(X.shape[:lead].numel(), -1)
        if X.device.type != "meta" and Xf.shape[1] * ax.size != n:
            raise ValueError(f"a block of {Xf.shape[1]} entries over {ax.size} ranks is not "
                             f"a chain of {n}")
        left, right = ax.edges(Xf[:, :1], Xf[:, -1:])
        strip = torch.cat([left, Xf, right], dim=1)
        return (2 * Xf - strip[:, :-2] - strip[:, 2:]).reshape(X.shape)

    return LinearOperator(lambda x: rows(x, 0), lambda x: rows(x, 0),
                          lambda X: rows(X, 1), lambda X: rows(X, 1))


def shard_local_stencil(op, axis):
    """Shard-local form of a fusable stencil operator for a vector whose
    ``(R, 128)`` rows are split in blocks over the mesh axis ``axis`` (a
    :class:`~.mesh.MeshAxis` or a process group): the apply brings ``h``
    edge rows from either neighbour in one all-reduce (zeros at the global
    ends), applies the stencil on the haloed strip and keeps the interior.
    The static stencil metadata is kept, so the fused expansion stays
    eligible on a space with ``psum_axis=axis``; its kernel takes the
    neighbours' rows as external halos (``factorizations/krylov.py``).

    Chains (:class:`StencilOperator`) and grids (:class:`GridStencilOperator`,
    whose blocks must cut whole grid rows: the halo is rounded up to whole
    grid rows) are supported; the adjoint is the reversed stencil, sharded
    the same way.  A ``(p, R, 128)`` stack of blocks (``normal_stack``,
    ``adjoint_stack``) exchanges every row's ``h`` edge rows in one
    all-reduce and applies each row's haloed strip as one block's."""
    from ..ops import fused_lanczos as fl

    spec = fl.spec_for(op)
    if spec is None:
        raise ValueError("shard_local_stencil requires a fusable stencil op")
    ax = as_axis(axis)
    h = spec.h
    if spec.mrow:
        # whole grid rows, so the haloed strip keeps the grid-column phase
        h = -(-h // spec.mrow) * spec.mrow

    def _mk_stack(inner):
        def apply(X):
            above, below = ax.edges(X[:, :h], X[:, -h:])
            strips = torch.cat([above, X, below], dim=1)
            return torch.stack([inner(s)[h:-h] for s in strips])

        return apply

    def _mk(inner):
        stack = _mk_stack(inner)
        return lambda x: stack(x[None])[0]

    if isinstance(op, GridStencilOperator):
        gc = op.grid[1]
        adj_off = tuple((-dy, -dx) for dy, dx in reversed(op.offsets2))
        adj_cf = tuple(reversed(op.coeffs))

        def grid_inner(offsets2, coeffs):
            # the strip is a sub-grid of its own: dy reaches at most h rows
            # and the dx masks are row-local
            def inner(strip):
                rows = strip.shape[0] * strip.shape[1] // gc
                return GridStencilOperator((rows, gc), offsets2, coeffs).normal(strip)

            return inner

        normal, adjoint = grid_inner(op.offsets2, op.coeffs), grid_inner(adj_off, adj_cf)
        return GridStencilOperator(
            op.grid, op.offsets2, op.coeffs, normal=_mk(normal), adjoint=_mk(adjoint),
            normal_stack=_mk_stack(normal), adjoint_stack=_mk_stack(adjoint),
        )

    normal = StencilOperator(op.offsets, op.coeffs).normal
    adj_off = tuple(-d for d in reversed(op.offsets))
    adjoint = StencilOperator(adj_off, tuple(reversed(op.coeffs))).normal
    return StencilOperator(op.offsets, op.coeffs, normal=_mk(normal), adjoint=_mk(adjoint),
                           normal_stack=_mk_stack(normal), adjoint_stack=_mk_stack(adjoint))
