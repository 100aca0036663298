"""Masked Hermitian eigendecomposition of the projected Rayleigh quotient
(counterpart of ``krylovkit_tpu/dense/hermitian.py``), via
``torch.linalg.eigh`` on the small ``(m, m)`` buffer.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .masking import active_support, embed_active, spectrum_sentinel

__all__ = ["eigh_active", "geneigh_active"]


def _zero_inactive_rows(U: torch.Tensor, k: int) -> torch.Tensor:
    rows = torch.arange(U.shape[0], device=U.device)[:, None]
    return torch.where(rows < k, U, torch.zeros((), dtype=U.dtype, device=U.device))


def eigh_active(T: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Eigendecomposition of the active ``k×k`` block of Hermitian ``T``.

    Returns ``(w, U, valid)`` of size ``m``: eigenvalues, eigenvectors
    (columns, supported on the active rows) and the mask of the ``k``
    genuine pairs.  Invalid entries carry a sentinel eigenvalue."""
    T = (T + T.conj().T) / 2
    Teff = embed_active(T, k, spectrum_sentinel(T, k))
    w, U = torch.linalg.eigh(Teff)
    valid = active_support(U, k) > 0.5
    return w, _zero_inactive_rows(U, k), valid


def geneigh_active(A: torch.Tensor, B: torch.Tensor, k: int):
    """Generalized Hermitian problem ``A x = λ B x`` on the active block with
    ``B`` positive definite (reference ``geneigh!``), as ``L⁻¹ A L⁻ᴴ`` with
    ``B = L Lᴴ``.  Eigenvectors come back B-orthonormal."""
    m = A.shape[0]
    A = (A + A.conj().T) / 2
    B = (B + B.conj().T) / 2
    d = torch.arange(m, device=A.device)
    ident_tail = torch.diag((d >= k).to(A.dtype))
    L = torch.linalg.cholesky(embed_active(B, k, 0) + ident_tail)
    eye = torch.eye(m, dtype=A.dtype, device=A.device)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    C = Linv @ embed_active(A, k, 0) @ Linv.conj().T
    w, Y, valid = eigh_active(C, k)
    X = _zero_inactive_rows(Linv.conj().T @ Y, k)
    return w, X, valid
