"""Masked dense SVD of the projected bidiagonal (counterpart of
``krylovkit_tpu/dense/svd.py``; the reference's LAPACK ``bdsqr`` wrapper
``bidiagsvd!``, ``src/dense/linalg.jl:123-130``), via ``torch.linalg.svd`` on
the small ``(m, m)`` buffer.

After a thick restart the GKL projected matrix is bidiagonal plus a spike
row, so a dense SVD of the buffer is the general choice; the inactive block
carries a sentinel outside the active range, and genuine triplets are found
by the support of their vectors (``masking.py``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .masking import active_support, embed_active, spectrum_sentinel

__all__ = ["svd_active"]


def svd_active(B: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """SVD of the active ``k×k`` block of ``B``.

    Returns ``(s, U, Vh, valid)`` of size ``m`` with
    ``B[:k,:k] = (U diag(s) Vh)[:k,:k]``; singular values descending, with
    the inactive triplets at sentinel values and False in ``valid``."""
    Beff = embed_active(B, k, spectrum_sentinel(B, k))
    U, s, Vh = torch.linalg.svd(Beff, full_matrices=False)
    valid = active_support(U, k) > 0.5
    live = torch.arange(B.shape[0], device=B.device) < k
    zero = torch.zeros((), dtype=U.dtype, device=U.device)
    U = torch.where(live[:, None], U, zero)
    Vh = torch.where(live[None, :], Vh, zero)
    return s, U, Vh, valid
