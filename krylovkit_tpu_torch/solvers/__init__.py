"""Solver drivers: the Hermitian Lanczos eigsolve and its front-end, the
batched Lanczos and GMRES drivers (``batched.py``), the batched CG, MINRES
and BiCGStab drivers (``batched_linsolve.py``), the batched Arnoldi and
exponential-integrator drivers (``batched_arnoldi.py``,
``batched_expintegrator.py``) and the batched GKL ``svdsolve`` and LSMR
``lssolve`` (``batched_gkl.py``)."""

from .batched_gkl import lssolve_lsmr_batched, svdsolve_gkl_batched  # noqa: F401
