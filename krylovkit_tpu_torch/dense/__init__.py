"""Small dense projected-problem kernels."""

from .hermitian import eigh_active, geneigh_active
from .masking import (
    active_mask,
    active_support,
    embed_active,
    sort_perm,
    spectrum_sentinel,
    which_key,
)

__all__ = [
    "eigh_active",
    "geneigh_active",
    "active_mask",
    "active_support",
    "embed_active",
    "sort_perm",
    "spectrum_sentinel",
    "which_key",
]
