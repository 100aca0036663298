"""Real Schur decomposition (quasi-triangular, 2x2 blocks) (counterpart of
``krylovkit_tpu/dense/realschur.py``; the reference's real ``hschur!``,
``src/dense/linalg.jl:464-500``, with ``schur2eigvals`` ``:156-189`` and the
``dlanv2`` block standardization).

Real problems keep the basis real, so the projected problem needs the real
Schur form.  Householder Hessenberg reduction, then Francis double-shift QR
in explicit form: the shift pair ``(s, p) = (trace, det)`` of the trailing
2x2 is real, so ``M = A² − sA + pI`` is real and the orthogonal ``Q`` of one
implicit sweep is the ``Q`` of ``qr(M)``.  Deflation handles single
eigenvalues and 2x2 blocks, standardizing each deflated 2x2 with a
``dlanv2``-style rotation: blocks with real eigenvalues split into two 1x1s,
complex pairs are rotated to ``[[a, b], [c, a]]`` with ``b·c < 0``.

The arithmetic and the masks are the JAX package's; the loop runs on the
host over ``hi``, ``it``, ``stag`` as Python ints and reads the two
deflation flags in one transfer per iteration.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .hessenberg import hessenberg_reduce
from .masking import embed_active, spectrum_sentinel

__all__ = [
    "lanv2_rotation",
    "real_schur_active",
    "real_schur_eigvals",
    "block_starts",
]


def lanv2_rotation(a, b, c, d):
    """Rotation ``(cs, sn)`` standardizing the real 2x2 ``[[a, b], [c, d]]``
    (0-d tensors, or vectors of blocks).

    ``G = [[cs, -sn], [sn, cs]]``; ``Gᵀ M G`` is upper triangular when the
    block has real eigenvalues (the (0,0) entry gets the eigenvalue whose
    eigenvector defines the rotation), and has equal diagonal entries
    (standard form, complex pair) otherwise.  Branchless (``where``)."""
    half = (a - d) / 2
    disc = half * half + b * c  # discriminant/4 of the characteristic poly
    real_eigs = disc >= 0

    # real case: rotate the eigenvector [b, λ - a] (or its fallback) to e1
    sq = torch.sqrt(torch.abs(disc))
    lam = (a + d) / 2 + torch.where(half >= 0, sq, -sq)  # larger-|.| root bias
    v1a, v2a = b, lam - a
    v1b, v2b = lam - d, c
    use_a = torch.abs(v1a) + torch.abs(v2a) >= torch.abs(v1b) + torch.abs(v2b)
    v1 = torch.where(use_a, v1a, v1b)
    v2 = torch.where(use_a, v2a, v2b)
    nv = torch.sqrt(v1 * v1 + v2 * v2)
    ok = nv > 0
    safe = torch.where(ok, nv, 1)
    cs_r = torch.where(ok, v1 / safe, 1)
    sn_r = torch.where(ok, v2 / safe, 0)

    # complex case: equalize the diagonal.  (Gᵀ M G)₀₀ − (Gᵀ M G)₁₁ =
    # (a−d)·cos2θ + (b+c)·sin2θ, zero at tan(2θ) = −(a−d)/(b+c)
    denom = b + c
    theta = 0.5 * torch.atan2(d - a, torch.where(denom == 0, torch.finfo(a.dtype).tiny, denom))
    cs = torch.where(real_eigs, cs_r, torch.cos(theta))
    sn = torch.where(real_eigs, sn_r, torch.sin(theta))
    return cs, sn


def _apply_pair_rotation(A, Q, i: int, cs, sn):
    """Similarity by the identity-embedded rotation on rows/cols ``(i, i+1)``:
    ``A ← Gᵀ A G``, ``Q ← Q G`` with ``G[i:i+2, i:i+2] = [[cs, -sn], [sn, cs]]``."""
    G = torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    # G = I + (cs-1)(e1 e1ᵀ + e2 e2ᵀ) + sn (e2 e1ᵀ - e1 e2ᵀ)
    G[i, i] = G[i + 1, i + 1] = 1 + (cs - 1)
    G[i + 1, i] = sn
    G[i, i + 1] = -sn
    return G.T @ A @ G, Q @ G


def _standardize_block(A, Q, i: int):
    """Standardize the 2x2 block at ``(i, i+1)`` with a lanv2 rotation; zero
    the subdiagonal entry if the block's eigenvalues are real."""
    a, b = A[i, i].clone(), A[i, i + 1].clone()
    c, d = A[i + 1, i].clone(), A[i + 1, i + 1].clone()
    cs, sn = lanv2_rotation(a, b, c, d)
    A, Q = _apply_pair_rotation(A, Q, i, cs, sn)
    half = (a - d) / 2
    disc = half * half + b * c
    A[i + 1, i] = torch.where(disc >= 0, 0.0, A[i + 1, i])
    return A, Q


def real_schur_active(H: torch.Tensor, k: int, tol: Optional[float] = None,
                      max_sweeps: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, bool]:
    """Real Schur form of the active ``k×k`` block of real ``H``.

    Returns ``(T, Q, ok)``: ``Q[:k,:k]ᵀ H[:k,:k] Q[:k,:k] = T[:k,:k]``
    quasi-upper-triangular with standardized 2x2 blocks (complex pairs only),
    ``Q`` orthogonal (identity on the inactive part up to signs), ``ok`` true
    when everything deflated within the sweep budget."""
    m = H.shape[0]
    rdt = H.dtype
    if tol is None:
        tol = float(torch.finfo(rdt).eps)
    if max_sweeps is None:
        max_sweeps = 40 * m

    A_emb = embed_active(H, k, spectrum_sentinel(H, k))
    scale = torch.clamp(torch.max(torch.abs(A_emb)), min=1.0)
    A, Q = hessenberg_reduce(A_emb)
    eye = torch.eye(m, dtype=rdt, device=H.device)

    def negligible(i: int):
        """``|A[i, i-1]|`` small against its diagonal neighbourhood (i > 0)."""
        dmag = torch.abs(A[i, i]) + torch.abs(A[i - 1, i - 1])
        return torch.abs(A[i, i - 1]) <= tol * torch.maximum(dmag, scale * tol)

    hi, it, stag = max(int(k) - 1, 0), 0, 0
    while hi > 0 and it < max_sweeps:
        # a 2x2 block (hi-1, hi) deflates when the subdiagonal ABOVE it dies;
        # at hi == 1 the block reaches the top, so it deflates unconditionally
        if hi <= 1:
            small1, small2 = bool(negligible(hi)), True
        else:
            small1, small2 = torch.stack([negligible(hi), negligible(hi - 1)]).tolist()
        if small1:
            A[hi, hi - 1] = 0.0
            hi, stag = hi - 1, 0
        elif small2:
            if hi >= 2:
                A[hi - 1, hi - 2] = 0.0
            A, Q = _standardize_block(A, Q, hi - 1)
            hi, stag = hi - 2, 0
        else:
            a, b = A[hi - 1, hi - 1], A[hi - 1, hi]
            c, d = A[hi, hi - 1], A[hi, hi]
            if stag > 0 and stag % 8 == 0:
                # exceptional shifts on stall (LAPACK dhseqr style)
                x = torch.abs(c) + torch.abs(A[max(hi - 1, 1), max(hi - 2, 0)])
                xs = 0.75 * x + d
                s, p = 2 * xs, xs * xs
            else:
                s, p = a + d, a * d - b * c
            # identity outside the leading hi+1 block, so the QR cannot mix
            # active and inactive subspaces
            Ablk = eye.clone()
            Ablk[: hi + 1, : hi + 1] = A[: hi + 1, : hi + 1]
            M = Ablk @ Ablk - s * Ablk + p * eye
            Mblk = eye.clone()
            Mblk[: hi + 1, : hi + 1] = M[: hi + 1, : hi + 1]
            Qi, _ = torch.linalg.qr(Mblk)
            A = torch.triu(Qi.T @ A @ Qi, -1)  # implicit-Q: clean the fill-in
            Q = Q @ Qi
            stag += 1
        it += 1
    return torch.triu(A, -1), Q, hi <= 0


def block_starts(T: torch.Tensor, k: int) -> torch.Tensor:
    """Boolean ``(m,)`` mask: position ``i < k`` starts a 2x2 block
    (``T[i+1, i]`` nonzero).  Positions ``>= k`` and block interiors are
    False."""
    m = T.shape[0]
    false1 = torch.zeros(1, dtype=torch.bool, device=T.device)
    nz = torch.cat([torch.diagonal(T, -1) != 0, false1])
    nz = nz & (torch.arange(m, device=T.device) < k - 1)
    # a nonzero subdiagonal at i marks a block start only if i-1 is not one
    prev = torch.cat([false1, nz[:-1]])
    return nz & ~prev


def real_schur_eigvals(T: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigenvalues ``(re, im)`` from a real quasi-triangular ``T`` (reference
    ``schur2eigvals`` with 2x2 blocks, ``src/dense/linalg.jl:156-189``), as a
    pair of real tensors."""
    zero1 = torch.zeros(1, dtype=T.dtype, device=T.device)
    d = torch.diagonal(T)
    up = torch.cat([torch.diagonal(T, 1), zero1])
    lo = torch.cat([torch.diagonal(T, -1), zero1])
    starts = block_starts(T, k)
    second = torch.cat([torch.zeros(1, dtype=torch.bool, device=T.device), starts[:-1]])
    d_next = torch.roll(d, -1)
    d_prev = torch.roll(d, 1)
    # block (i, i+1): re = (d_i + d_{i+1})/2, im² = -((d_i-d_{i+1})/2)² - b·c
    half = (d - d_next) / 2
    disc = half * half + up * lo  # at a start position
    im_start = torch.sqrt(torch.clamp(-disc, min=0.0))
    re_start = (d + d_next) / 2
    half_p = (d_prev - d) / 2
    disc_p = half_p * half_p + torch.roll(up, 1) * torch.roll(lo, 1)
    im_second = torch.sqrt(torch.clamp(-disc_p, min=0.0))
    re_second = (d_prev + d) / 2
    re = torch.where(starts, re_start, torch.where(second, re_second, d))
    im = torch.where(starts, im_start, torch.where(second, -im_second, 0.0))
    return re, im
