"""Householder reduction of the (masked) projected matrix to Hessenberg form
(counterpart of ``krylovkit_tpu/dense/hessenberg.py``).

The Krylov-Schur restart leaves the projected matrix as "triangular + spike
row + Hessenberg extension"; the Schur iterations want Hessenberg form.
Reflectors are masked to the rows below the current column, so the inactive
(sentinel-diagonal) block of an embedded matrix stays untouched.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["hessenberg_reduce"]


def hessenberg_reduce(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unitary ``Q`` and Hessenberg ``H`` with ``Qᴴ A Q = H``, real or
    complex.  Returns ``(H, Q)``; ``A`` is not modified.  Callers embed the
    active block first (inactive = diagonal, which the reduction leaves as
    it is)."""
    m = A.shape[0]
    dev = A.device
    ridx = torch.arange(m, device=dev)
    Q = torch.eye(m, dtype=A.dtype, device=dev)
    one = torch.ones((), dtype=A.dtype, device=dev)
    for j in range(max(m - 2, 0)):
        x = torch.where(ridx > j, A[:, j], 0)
        nx = torch.linalg.vector_norm(x)
        pivot = x[j + 1]
        apiv = torch.abs(pivot)
        phase = torch.where(apiv > 0, pivot / torch.where(apiv > 0, apiv, 1), one)
        alpha = -phase * nx
        v = x - alpha * (ridx == j + 1).to(A.dtype)
        nv = torch.linalg.vector_norm(v)
        ok = nv > 0
        v = torch.where(ok, v / torch.where(ok, nv, 1), 0)
        # A <- P A P, Q <- Q P with P = I - 2 v vᴴ (rank-1 updates)
        A = A - 2 * torch.outer(v, v.conj() @ A)
        A = A - 2 * torch.outer(A @ v, v.conj())
        Q = Q - 2 * torch.outer(Q @ v, v.conj())
    # clean numerical fill-in below the sub-diagonal
    return torch.triu(A, -1), Q
