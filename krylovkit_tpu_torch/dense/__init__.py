"""Small dense projected-problem kernels."""

from .givens import givens
from .hermitian import eigh_active, geneigh_active
from .hessenberg import hessenberg_reduce
from .masking import (
    active_mask,
    active_support,
    embed_active,
    sort_perm,
    spectrum_sentinel,
    which_key,
    which_key_ri,
)
from .realschur import block_starts, lanv2_rotation, real_schur_active, real_schur_eigvals
from .reorder import partition_schur, sort_schur
from .reorder_real import sort_schur_real
from .schur import schur_active, schur_eigvals
from .svd import svd_active
from .trevc import triangular_eigvecs
from .trevc_real import triangular_eigvecs_real
from .triangular import expm_active, solve_upper_active

__all__ = [
    "eigh_active",
    "geneigh_active",
    "givens",
    "hessenberg_reduce",
    "schur_active",
    "schur_eigvals",
    "real_schur_active",
    "real_schur_eigvals",
    "block_starts",
    "lanv2_rotation",
    "sort_schur",
    "sort_schur_real",
    "partition_schur",
    "triangular_eigvecs",
    "triangular_eigvecs_real",
    "active_mask",
    "active_support",
    "embed_active",
    "solve_upper_active",
    "expm_active",
    "svd_active",
    "sort_perm",
    "spectrum_sentinel",
    "which_key",
    "which_key_ri",
]
