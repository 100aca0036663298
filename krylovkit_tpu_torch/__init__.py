"""krylovkit_tpu_torch — the PyTorch/CUDA port of ``krylovkit_tpu``.

This slice covers the Hermitian Lanczos eigsolve, with the fused one-stream
expansion and the in-place restart rotation as hand-written CUDA kernels
(``csrc/``).  Entry points run where their inputs live: ``eigsolve`` on the
device of ``x0``, the operator builders check ``device`` (default
``"cuda"``).  CPU tensors run the kernels' plain PyTorch versions.

Importing the package turns TF32 off for float32 matrix products and
convolutions: the JAX package pins full float32 precision, and iterated
orthogonalization drifts without it.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .algorithms import (  # noqa: E402
    Arnoldi,
    BlockLanczos,
    EigSorter,
    KrylovDefaults,
    Lanczos,
    cgs,
    cgs2,
    cgsir,
    mgs,
    mgs2,
    mgsir,
)
from .info import EACHITERATION, SILENT, STARTSTOP, WARN, ConvergenceInfo  # noqa: E402
from .ops.operator import (  # noqa: E402
    GridStencilOperator,
    LinearOperator,
    MatrixOperator,
    StencilOperator,
    as_operator,
)
from .ops.vector import REAL, STANDARD, VectorSpace  # noqa: E402
from .parallel.operators import laplacian_1d, poisson_2d  # noqa: E402
from .solvers.eigsolve import eigsolve  # noqa: E402
from .solvers.lanczos import eigsolve_lanczos  # noqa: E402

__all__ = [
    "Arnoldi",
    "BlockLanczos",
    "EigSorter",
    "KrylovDefaults",
    "Lanczos",
    "cgs",
    "cgs2",
    "cgsir",
    "mgs",
    "mgs2",
    "mgsir",
    "SILENT",
    "WARN",
    "STARTSTOP",
    "EACHITERATION",
    "ConvergenceInfo",
    "LinearOperator",
    "StencilOperator",
    "GridStencilOperator",
    "MatrixOperator",
    "as_operator",
    "VectorSpace",
    "STANDARD",
    "REAL",
    "laplacian_1d",
    "poisson_2d",
    "eigsolve",
    "eigsolve_lanczos",
]
