"""Small dense projected-problem kernels."""

from .givens import givens
from .hermitian import eigh_active, geneigh_active
from .masking import (
    active_mask,
    active_support,
    embed_active,
    sort_perm,
    spectrum_sentinel,
    which_key,
)
from .triangular import solve_upper_active

__all__ = [
    "eigh_active",
    "geneigh_active",
    "givens",
    "active_mask",
    "active_support",
    "embed_active",
    "solve_upper_active",
    "sort_perm",
    "spectrum_sentinel",
    "which_key",
]
