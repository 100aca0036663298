"""Solver drivers: the Hermitian Lanczos eigsolve and its front-end."""
