"""The distribution layer (counterpart of ``krylovkit_tpu/parallel``):
process-group meshes, sharded stencil and sparse operators, and the
benchmark operators.  A sharded solve runs the same front-end on every rank
of a ``torch.distributed`` group, each on its block of the vector, with
``VectorSpace(psum_axis=mesh.axis(VECTOR_AXIS))``."""

from .mesh import BATCH_AXIS, VECTOR_AXIS, make_mesh, replicate, shard_vector
from .operators import laplacian_1d, poisson_2d, shard_local_stencil, sharded_laplacian_1d
from .sparse import (
    ShardedELLOperator,
    banded_coo,
    coo_to_ell,
    powerlaw_rect_coo,
    rect_sparse_coo,
    sharded_ell_from_coo,
)

__all__ = [
    "make_mesh",
    "shard_vector",
    "replicate",
    "VECTOR_AXIS",
    "BATCH_AXIS",
    "laplacian_1d",
    "poisson_2d",
    "shard_local_stencil",
    "sharded_laplacian_1d",
    "ShardedELLOperator",
    "sharded_ell_from_coo",
    "banded_coo",
    "powerlaw_rect_coo",
    "rect_sparse_coo",
    "coo_to_ell",
]
