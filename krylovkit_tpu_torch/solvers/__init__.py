"""Solver drivers: the Hermitian Lanczos eigsolve and its front-end, the
batched Lanczos and GMRES drivers (``batched.py``) and the batched CG,
MINRES and BiCGStab drivers (``batched_linsolve.py``)."""
