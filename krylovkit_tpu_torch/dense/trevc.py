"""Eigenvectors from a complex Schur form (counterpart of
``krylovkit_tpu/dense/trevc.py``; the reference's LAPACK ``trevc``,
``src/dense/linalg.jl:197-304``).

For an upper-triangular ``T`` with eigenvalue ``λ_i = T[i,i]`` the
eigenvector is ``x = [y; 1; 0…]`` with ``(T[:i,:i] - λ_i I) y = -T[:i,i]``.
All solves run as one batch of guarded triangular systems (the LAPACK-style
``smin`` diagonal perturbation protects against near-degenerate eigenvalues).
"""

from __future__ import annotations

import torch

__all__ = ["triangular_eigvecs"]


def triangular_eigvecs(T: torch.Tensor, k: int) -> torch.Tensor:
    """Right eigenvectors of the active block of upper-triangular ``T``.

    Returns ``X`` (m, m): column ``i < k`` is the unit-norm eigenvector of
    ``T[:k,:k]`` for ``λ_i = T[i,i]`` (supported on rows ``<= i``); columns
    ``>= k`` are canonical unit vectors."""
    m = T.shape[0]
    cdt, dev = T.dtype, T.device
    eps = torch.finfo(cdt.to_real()).eps
    smin = eps * torch.clamp(torch.max(torch.abs(T)), min=1.0)

    ridx = torch.arange(m, device=dev)
    rows, cols = ridx[None, :, None], ridx[None, None, :]
    i = ridx[:, None, None]  # batch axis: one system per column i
    eye = torch.eye(m, dtype=cdt, device=dev)
    diag = torch.diagonal(T)

    # leading block system, identity elsewhere so the full solve is exact
    below = ridx[None, :] < ridx[:, None]  # (i, r): r < i
    M = torch.where((rows < i) & (cols < i), T[None], eye[None])
    d = torch.where(below, diag[None, :] - diag[:, None], 1)
    # guard small pivots: |d| >= smin, keeping the phase
    dmag = torch.abs(d)
    phase = torch.where(dmag > 0, d / torch.maximum(dmag, smin), 1)
    d = torch.where(dmag < smin, smin * phase, d)
    M = torch.where(rows == cols, 0, M) + torch.diag_embed(d)
    rhs = torch.where(below, -T.T, 0)  # rhs[i, r] = -T[r, i]
    y = torch.linalg.solve_triangular(M, rhs[:, :, None], upper=True)[:, :, 0]
    x = torch.where(below, y, 0) + eye
    X = (x / torch.linalg.vector_norm(x, dim=1, keepdim=True)).T
    # inactive columns: canonical basis
    return torch.where(ridx[None, :] >= k, eye, X)
