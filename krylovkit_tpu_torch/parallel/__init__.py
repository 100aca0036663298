"""Benchmark operators (the sharding layer is not ported yet)."""

from .operators import laplacian_1d, poisson_2d

__all__ = ["laplacian_1d", "poisson_2d"]
