"""krylovkit_tpu_torch — the PyTorch/CUDA port of ``krylovkit_tpu``.

It covers the Hermitian Lanczos eigsolve (full or selective
reorthogonalization), Block Lanczos (``eigsolve`` with a :class:`Block`
start), the Krylov-Schur Arnoldi solvers (``schursolve``, non-Hermitian
``eigsolve``, ``realeigsolve``), the two-sided BiArnoldi eigensolver
(``bieigsolve``), the Golub-Ye generalized eigensolver (``geneigsolve``), the
iterator API (``LanczosIterator`` with its O(1)-memory 3-term mode,
``ArnoldiIterator``, ``GKLIterator``, ``BlockLanczosIterator``,
``BiArnoldiIterator`` and the accessors ``basis``, ``rayleighquotient``,
``residual``, ``normres``), the linear solvers (CG, GMRES, MINRES,
BiCGStab), the GKL singular-value solver (``svdsolve``, ``realsvdsolve``),
LSMR least squares (``lssolve``, ``reallssolve``) and the matrix functions
(``exponentiate``, ``expintegrator``), on dense, stencil, banded and ELL
(``sparse``) operators and :class:`ParametricOperator`, sharded over the
ranks of a ``torch.distributed`` group (``parallel``: process-group meshes,
sharded stencil and ELL operators, ``VectorSpace(psum_axis=...)``) in the
Lanczos, Arnoldi, CG, GMRES, LSMR and GKL solvers, with reverse-mode
differentiation of ``linsolve``, ``eigsolve`` and ``svdsolve`` (``ad``:
one ``torch.autograd.Function`` each) and pytree vectors (tuples, lists and
dicts of tensors) in the Krylov, Lanczos, Arnoldi and linear solvers,
batched Lanczos, Arnoldi, GMRES, CG, MINRES, BiCGStab, GKL, LSMR, Golub-Ye,
BiArnoldi and Block Lanczos solves and batched exponential integrators of many problems
in one host loop
(``eigsolve_lanczos_batched``, ``schursolve_batched``,
``eigsolve_arnoldi_batched``, ``realeigsolve_arnoldi_batched``,
``linsolve_gmres_batched``, ``linsolve_cg_batched``,
``linsolve_minres_batched``, ``linsolve_bicgstab_batched``,
``expintegrator_batched``, ``exponentiate_batched``,
``svdsolve_gkl_batched``, ``lssolve_lsmr_batched``,
``geneigsolve_golubye_batched``, ``bieigsolve_batched``,
``eigsolve_blocklanczos_batched``: ``jax.vmap`` of the JAX drivers, a
banded or 1-D Laplacian operator applied to every problem in one batched
launch; each takes what its one-problem driver takes, ``eager=True`` and
``Lanczos(reorth="selective")`` among it, pytree vectors and a sharded
space, trees on a sharded space too; the batched Lanczos, Arnoldi, GMRES,
CG, MINRES, BiCGStab and GKL drivers differentiate by their front-ends'
rules, ``alg_rrule`` included, on an unsharded space: ``ad/batched.py``,
``jax.grad`` over ``jax.vmap``), with
six hand-written CUDA kernels
(``csrc/``): the fused one-stream expansion, the in-place restart rotation,
the banded SpMV of :class:`BandedOperator`, the 1-D Laplacian of
``laplacian_1d_pallas`` and the two live-row basis projections
(``ops/projections.py``, off unless ``ops.basis.use_pallas_projections``).
Entry points run where their inputs live: ``eigsolve`` and ``svdsolve`` on
the device of ``x0``, ``linsolve`` and ``lssolve`` on the device of ``b``,
``exponentiate`` on the device of its vector; the operator constructors check
``device`` (default ``"cuda"``).  CPU tensors run the kernels' plain
PyTorch versions.

Importing the package turns TF32 off for float32 matrix products and
convolutions: the JAX package pins full float32 precision, and iterated
orthogonalization drifts without it.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .algorithms import (  # noqa: E402
    CG,
    GKL,
    GMRES,
    LSMR,
    MINRES,
    Arnoldi,
    BiArnoldi,
    BiCGStab,
    BlockLanczos,
    EigSorter,
    GolubYe,
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
from .factorizations.iterators import (  # noqa: E402
    ArnoldiIterator,
    BiArnoldiIterator,
    BlockLanczosIterator,
    GKLIterator,
    LanczosIterator,
    basis,
    normres,
    rayleighquotient,
    residual,
)
from .ops.operator import (  # noqa: E402
    GridStencilOperator,
    LinearOperator,
    MatrixOperator,
    ParametricOperator,
    StencilOperator,
    as_operator,
)
from .ops import sparse  # noqa: E402
from .ops.banded import BandedOperator, banded_from_coo, banded_from_dense, ell_to_banded  # noqa: E402
from .ops.block import Block  # noqa: E402
from .ops.stencil_1d import laplacian_1d_pallas  # noqa: E402
from .ops.vector import REAL, STANDARD, VectorSpace  # noqa: E402
from .parallel.operators import laplacian_1d, poisson_2d  # noqa: E402
from .solvers.arnoldi import eigsolve_arnoldi  # noqa: E402
from .solvers.batched import eigsolve_lanczos_batched, linsolve_gmres_batched  # noqa: E402
from .solvers.batched_arnoldi import (  # noqa: E402
    eigsolve_arnoldi_batched,
    realeigsolve_arnoldi_batched,
    schursolve_batched,
)
from .solvers.batched_biarnoldi import bieigsolve_batched  # noqa: E402
from .solvers.batched_blocklanczos import eigsolve_blocklanczos_batched  # noqa: E402
from .solvers.batched_expintegrator import expintegrator_batched, exponentiate_batched  # noqa: E402
from .solvers.batched_gkl import lssolve_lsmr_batched, svdsolve_gkl_batched  # noqa: E402
from .solvers.batched_golubye import geneigsolve_golubye_batched  # noqa: E402
from .solvers.batched_linsolve import (  # noqa: E402
    linsolve_bicgstab_batched,
    linsolve_cg_batched,
    linsolve_minres_batched,
)
from .solvers.biarnoldi import bieigsolve  # noqa: E402
from .solvers.eigsolve import eigsolve, realeigsolve, schursolve  # noqa: E402
from .solvers.expintegrator import expintegrator, exponentiate  # noqa: E402
from .solvers.golubye import geneigsolve  # noqa: E402
from .solvers.lanczos import eigsolve_lanczos  # noqa: E402
from .solvers.linsolve import linsolve, reallinsolve  # noqa: E402
from .solvers.lssolve import lssolve, reallssolve  # noqa: E402
from .solvers.svdsolve import realsvdsolve, svdsolve, svdsolve_gkl  # noqa: E402
from . import ad  # noqa: E402
from . import dense  # noqa: E402
from . import parallel  # noqa: E402

__all__ = [
    "Arnoldi",
    "BiArnoldi",
    "BiCGStab",
    "BlockLanczos",
    "CG",
    "GKL",
    "GMRES",
    "LSMR",
    "MINRES",
    "EigSorter",
    "GolubYe",
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
    "LanczosIterator",
    "ArnoldiIterator",
    "GKLIterator",
    "BlockLanczosIterator",
    "BiArnoldiIterator",
    "basis",
    "rayleighquotient",
    "residual",
    "normres",
    "LinearOperator",
    "StencilOperator",
    "GridStencilOperator",
    "MatrixOperator",
    "ParametricOperator",
    "BandedOperator",
    "banded_from_coo",
    "banded_from_dense",
    "ell_to_banded",
    "sparse",
    "Block",
    "laplacian_1d_pallas",
    "as_operator",
    "VectorSpace",
    "STANDARD",
    "REAL",
    "laplacian_1d",
    "poisson_2d",
    "eigsolve",
    "eigsolve_arnoldi",
    "eigsolve_lanczos",
    "eigsolve_lanczos_batched",
    "linsolve_gmres_batched",
    "linsolve_cg_batched",
    "linsolve_minres_batched",
    "linsolve_bicgstab_batched",
    "schursolve_batched",
    "eigsolve_arnoldi_batched",
    "realeigsolve_arnoldi_batched",
    "expintegrator_batched",
    "exponentiate_batched",
    "svdsolve_gkl_batched",
    "lssolve_lsmr_batched",
    "geneigsolve_golubye_batched",
    "bieigsolve_batched",
    "eigsolve_blocklanczos_batched",
    "schursolve",
    "realeigsolve",
    "geneigsolve",
    "bieigsolve",
    "linsolve",
    "reallinsolve",
    "svdsolve",
    "realsvdsolve",
    "svdsolve_gkl",
    "lssolve",
    "reallssolve",
    "exponentiate",
    "expintegrator",
    "ad",
    "dense",
    "parallel",
]
