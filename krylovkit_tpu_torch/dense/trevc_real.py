"""Eigenvectors from a REAL quasi-triangular Schur form (counterpart of
``krylovkit_tpu/dense/trevc_real.py``; the reference's ``dtrevc`` surface,
``src/dense/linalg.jl:197-304``, where complex-pair columns are combined,
``:223-246``).  Vectors come back as an ``(X_re, X_im)`` pair of real
tensors, so the real path stays real until the caller combines them.

For a 1x1 block at ``i`` (real λ): ``x = [y; 1; 0…]`` with the leading
quasi-triangular system ``(T[:i,:i] − λI) y = −T[:i, i]``.  For a 2x2 block
at ``(i, i+1)`` (λ = a ± iμ): the in-block part is ``[b, (d−a)/2 + iμ]`` and
the leading extension solves the complex system ``(T[:i,:i] − λI) y =
−(b·T[:i,i] + v₂·T[:i,i+1])``, written as the real ``2m×2m`` block system
``[[R, μI], [−μI, R]]``.  Both cases are the same embedded real system
(μ = 0 gives two decoupled real solves), so all columns go through one batch
of LU solves.  Column ``i+1`` of a pair is the conjugate of column ``i``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .realschur import block_starts

__all__ = ["triangular_eigvecs_real"]


def triangular_eigvecs_real(T: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Right eigenvectors of the active block of real quasi-triangular ``T``.

    Returns ``(Xre, Xim)``, each (m, m): column ``i < k`` is the unit-norm
    eigenvector for the eigenvalue of the block containing position ``i``
    (conjugate pairs in adjacent columns, ``Xim[:, i+1] = -Xim[:, i]``);
    columns ``>= k`` are canonical unit vectors."""
    m = T.shape[0]
    rdt, dev = T.dtype, T.device
    eps = torch.finfo(rdt).eps
    smin = eps * torch.clamp(torch.max(torch.abs(T)), min=1.0)

    ridx = torch.arange(m, device=dev)
    rows, cols = ridx[None, :, None], ridx[None, None, :]
    ib = ridx[:, None, None]  # batch axis: one system per column i
    below = ridx[None, :] < ridx[:, None]  # (i, r): r < i
    eye = torch.eye(m, dtype=rdt, device=dev)
    zero1 = torch.zeros(1, dtype=rdt, device=dev)
    d = torch.diagonal(T)
    starts = block_starts(T, k)
    up = torch.cat([torch.diagonal(T, 1), zero1])
    lo = torch.cat([torch.diagonal(T, -1), zero1])
    nxt = torch.clamp(ridx + 1, max=m - 1)

    # per column i: the block (a, b; c, dd) that starts there.  General (not
    # exactly standardized) block: λ = (a+dd)/2 ± i·μ with μ² = −((a−dd)/2)² −
    # bc; eigenvector v = [b, (dd−a)/2 + i·μ]
    a, b, c, dd = d, up, lo, d[nxt]
    half = (a - dd) / 2
    mu = torch.where(starts, torch.sqrt(torch.clamp(-(half * half + b * c), min=0.0)), 0.0)
    lam_re = torch.where(starts, (a + dd) / 2, a)
    v2r = torch.where(starts, -half, 0.0)
    v1 = torch.where(starts, b, 1.0)

    # leading block R = T[:i,:i] − Re(λ)·I embedded: identity beyond row i
    lead = (rows < ib) & (cols < ib)
    ondiag = (rows == cols) & (rows < ib)
    R = torch.where(lead, T[None], 0.0) - torch.where(ondiag, lam_re[:, None, None], 0.0)
    # pivot guard: bump a near-singular diagonal (|T[j,j] − Re λ| and μ tiny)
    dv = torch.where(below, d[None, :] - lam_re[:, None], 1.0)
    piv_small = (torch.hypot(dv, mu[:, None].expand_as(dv)) < smin) & below
    bump = torch.where(piv_small, torch.where(dv >= 0, smin, -smin), 0.0)
    R = R + torch.diag_embed(torch.where(below, bump, 0.0))
    R = R + torch.diag_embed(torch.where(below, 0.0, 1.0).to(rdt))

    # rhs: −(T[:i,i]·v1 + T[:i,i+1]·v2), v2 = v2r + iμ
    coli, coli1 = T.T, T.T[nxt]  # [i, r] = T[r, i], T[r, i+1]
    rr = torch.where(below, -(v1[:, None] * coli + v2r[:, None] * coli1), 0.0)
    ri = torch.where(below, -mu[:, None] * coli1, 0.0)

    # real 2m system [[R, μI], [−μI, R]] [yr; yi] = [rr; ri]
    muI = mu[:, None, None] * ondiag.to(rdt)
    M = torch.cat([torch.cat([R, muI], dim=2), torch.cat([-muI, R], dim=2)], dim=1)
    y = torch.linalg.solve(M, torch.cat([rr, ri], dim=1)[:, :, None])[:, :, 0]
    yr, yi = y[:, :m], y[:, m:]

    # assemble: leading y, then the in-block part [v1, v2r] + i[0, μ]
    at_i = ridx[None, :] == ridx[:, None]
    at_i1 = ridx[None, :] == ridx[:, None] + 1
    xr = (torch.where(below, yr, 0.0) + torch.where(at_i, v1[:, None], 0.0)
          + torch.where(at_i1 & starts[:, None], v2r[:, None], 0.0))
    xi = torch.where(below, yi, 0.0) + torch.where(at_i1, mu[:, None], 0.0)
    xi = torch.where(starts[:, None], xi, 0.0)
    nrm = torch.sqrt(torch.sum(xr * xr, dim=1) + torch.sum(xi * xi, dim=1))
    nrm = torch.where(nrm > 0, nrm, 1.0)
    Xre, Xim = (xr / nrm[:, None]).T, (xi / nrm[:, None]).T

    # second column of each pair = conjugate of the first
    second = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev), starts[:-1]])
    Xre = torch.where(second[None, :], torch.roll(Xre, 1, dims=1), Xre)
    Xim = torch.where(second[None, :], -torch.roll(Xim, 1, dims=1), Xim)

    # inactive columns: canonical basis
    inactive = ridx[None, :] >= k
    return torch.where(inactive, eye, Xre), torch.where(inactive, 0.0, Xim)
