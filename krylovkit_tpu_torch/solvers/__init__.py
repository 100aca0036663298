"""Solver drivers: the Hermitian Lanczos eigsolve and its front-end, the
batched Lanczos and GMRES drivers (``batched.py``), the batched CG, MINRES
and BiCGStab drivers (``batched_linsolve.py``), the batched Arnoldi and
exponential-integrator drivers (``batched_arnoldi.py``,
``batched_expintegrator.py``), the batched GKL ``svdsolve`` and LSMR
``lssolve`` (``batched_gkl.py``), the batched Golub-Ye ``geneigsolve``
(``batched_golubye.py``), the batched BiArnoldi ``bieigsolve``
(``batched_biarnoldi.py``) and the batched Block Lanczos ``eigsolve``
(``batched_blocklanczos.py``)."""

from .batched_biarnoldi import bieigsolve_batched  # noqa: F401
from .batched_blocklanczos import eigsolve_blocklanczos_batched  # noqa: F401
from .batched_gkl import lssolve_lsmr_batched, svdsolve_gkl_batched  # noqa: F401
from .batched_golubye import geneigsolve_golubye_batched  # noqa: F401
