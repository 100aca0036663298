"""Solver drivers: the Hermitian Lanczos eigsolve and its front-end, and
the batched Lanczos and GMRES drivers (``batched.py``)."""
