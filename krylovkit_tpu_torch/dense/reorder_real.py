"""Reordering of a REAL Schur form with 2x2 blocks (counterpart of
``krylovkit_tpu/dense/reorder_real.py``; the reference's ``permuteschur!`` /
``trexc`` on real matrices, ``src/dense/linalg.jl:335-386``).

Adjacent block swaps follow LAPACK ``dlaexc``: to move the trailing block
``T22`` (q×q) of the window ``[[T11, T12], [0, T22]]`` (p, q ∈ {1, 2}) to the
front, solve the Sylvester equation ``T11·X − X·T22 = T12`` and take the
orthogonal factor of ``[[−X], [I_q]]``; the similarity by that factor swaps
the blocks.  Ill-conditioned swaps (nearly confluent blocks) are skipped,
as LAPACK's ``info = 1`` does.

The schedule is the JAX package's: each pass is an odd-even transposition
over blocks.  All adjacent block pairs of one parity are disjoint, so their
4×4 swap rotations are computed together (here: one batch axis over the
window positions) and applied as ONE accumulated orthogonal similarity
``T ← Gᵀ T G``.  A last vectorized phase re-standardizes every 2×2 block with
one accumulated lanv2 rotation.  The pass pair (even parity, odd parity)
repeats until swap-free, which costs one scalar read per round.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .masking import which_key_ri
from .realschur import lanv2_rotation

__all__ = ["sort_schur_real"]


def _solve4(K: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Batched 4x4 linear solves ``K[b] x[b] = rhs[b]``: unrolled Gaussian
    elimination with partial pivoting, pure vector operations."""
    tiny = torch.finfo(K.dtype).tiny
    nb = K.shape[0]
    A = torch.cat([K, rhs[:, :, None]], dim=2)  # (b, 4, 5) augmented
    ridx = torch.arange(4, device=K.device)
    bidx = torch.arange(nb, device=K.device)
    for j in range(4):
        # pivot: swap row j with the max-|A[:, j]| row among rows >= j
        col = torch.where(ridx >= j, torch.abs(A[:, :, j]), -1.0)
        piv = torch.argmax(col, dim=1)
        rj, rp = A[:, j].clone(), A[bidx, piv]
        A = A.clone()
        A[:, j] = rp
        A[bidx, piv] = rj  # piv == j: rj is the row just written back
        # eliminate below
        d = A[:, j, j]
        d = torch.where(torch.abs(d) > 0, d, tiny)
        f = torch.where(ridx > j, A[:, :, j] / d[:, None], 0.0)
        A = A - f[:, :, None] * A[:, j][:, None, :]
    # back substitution, unrolled
    x = torch.zeros((nb, 4), dtype=K.dtype, device=K.device)
    for j in range(3, -1, -1):
        d = A[:, j, j]
        d = torch.where(torch.abs(d) > 0, d, tiny)
        x[:, j] = (A[:, j, 4] - torch.sum(A[:, j, :4] * x, dim=1)) / d
    return x


def _householder_q(Z: torch.Tensor) -> torch.Tensor:
    """Batched orthogonal 4x4 ``Qf`` from two unrolled Householder reflectors
    of the 4x2 ``Z[b]`` (a zero column gives tau = 0, the identity
    reflector).  Rows where ``Z`` is exactly zero give reflector-vector
    zeros, so ``Qf`` is exactly the identity on those coordinates, which the
    accumulated-similarity schedule needs.  The first ``rank(Z)`` columns of
    ``Qf`` span ``col(Z)``."""
    ridx = torch.arange(4, device=Z.device)
    i4 = torch.eye(4, dtype=Z.dtype, device=Z.device)

    def reflect(x, off):
        # dlarfg on x[off:]: H x = beta e_off; returns (v, tau), v[<off] = 0
        act = ridx >= off
        xa = torch.where(act, x, 0.0)
        alpha = x[:, off]
        nrm = torch.sqrt(torch.sum(xa * xa, dim=1))
        tail = torch.sqrt(torch.clamp(nrm * nrm - alpha * alpha, min=0.0))
        degenerate = tail == 0.0  # already ±e_off (or zero): identity works
        beta = -torch.sign(torch.where(alpha == 0, 1.0, alpha)) * nrm
        denom = alpha - beta
        denom = torch.where(torch.abs(denom) > 0, denom, 1.0)
        v = torch.where(act, xa / denom[:, None], 0.0)
        v[:, off] = 1.0
        tau = torch.where(degenerate, 0.0, (beta - alpha) / torch.where(beta == 0, 1.0, beta))
        return v, tau

    v0, t0 = reflect(Z[:, :, 0], 0)
    z1 = Z[:, :, 1] - (t0 * torch.sum(v0 * Z[:, :, 1], dim=1))[:, None] * v0  # H0 on column 1
    v1, t1 = reflect(z1, 1)
    # Qf = H0 H1 = (I − t0 v0 v0ᵀ)(I − t1 v1 v1ᵀ)
    H1 = i4 - t1[:, None, None] * v1[:, :, None] * v1[:, None, :]
    v0H1 = torch.einsum("bi,bij->bj", v0, H1)
    return H1 - t0[:, None, None] * v0[:, :, None] * v0H1[:, None, :]


def _swap_window(W: torch.Tensor, p: torch.Tensor, q: torch.Tensor):
    """Batched orthogonal ``G[b]`` (4x4) swapping the leading ``p×p`` and the
    following ``q×q`` diagonal blocks of the padded windows ``W[b]`` (4x4;
    unused part = identity).  Returns ``(G, ok)``; ``ok`` is false where the
    Sylvester solve is too ill-conditioned."""
    rdt, dev = W.dtype, W.device
    nb = W.shape[0]
    eps = torch.finfo(rdt).eps
    two = torch.arange(2, device=dev)
    bidx = torch.arange(nb, device=dev)[:, None, None]
    pq = p[:, None] + two[None, :]  # rows/cols p, p+1 of each window
    T11 = W[:, :2, :2]
    T22 = W[bidx, pq[:, :, None], pq[:, None, :]]
    T12 = W[bidx, two[None, :, None], pq[:, None, :]]
    # pad unused dims: for p == 1 row/col 1 of T11 is irrelevant; set its
    # diagonal far away so the 4x4 Kronecker system is well-posed, and zero
    # the matching rhs so the padded X entries come out 0
    pr, pc = two[None, :, None], two[None, None, :]
    pb, qb = p[:, None, None], q[:, None, None]
    far = 2.0 + torch.amax(torch.abs(W), dim=(1, 2))[:, None, None]
    T11 = torch.where((pr < pb) & (pc < pb), T11, 0.0) + torch.where(
        (pr == pc) & (pr >= pb), far, 0.0)
    T22 = torch.where((pr < qb) & (pc < qb), T22, 0.0) + torch.where(
        (pr == pc) & (pr >= qb), -far, 0.0)
    T12 = torch.where((pr < pb) & (pc < qb), T12, 0.0)

    # Sylvester T11 X - X T22 = T12 as the 4x4 Kronecker system
    # kron(I2, T11) - kron(T22ᵀ, I2) on the column-major vec of X
    i2 = torch.eye(2, dtype=rdt, device=dev)
    K = (torch.einsum("ab,nij->naibj", i2, T11)
         - torch.einsum("nba,ij->naibj", T22, i2)).reshape(nb, 4, 4)
    rhs = T12.transpose(1, 2).reshape(nb, 4)
    scale = torch.clamp(torch.amax(torch.abs(K), dim=(1, 2)), min=eps)
    X4 = _solve4(K / scale[:, None, None], rhs / scale[:, None])
    X = X4.reshape(nb, 2, 2).transpose(1, 2)
    ok = torch.all(torch.isfinite(X), dim=(1, 2)) & (
        torch.amax(torch.abs(X), dim=(1, 2)) < 1 / (16 * eps))

    # Z (4×2): [[-X], [I_q]] laid out in the (p+q) window rows; unused
    # columns (cc >= q) zero
    rr = torch.arange(4, device=dev)[None, :, None]
    cc = two[None, None, :]
    Xfull = torch.cat([-X, torch.zeros((nb, 2, 2), dtype=rdt, device=dev)], dim=1)
    Xpad = torch.where((rr < pb) & (cc < qb), Xfull, 0.0)
    Ipad = torch.where((rr == cc + pb) & (cc < qb), 1.0, 0.0).to(rdt)
    # completing Z to an orthogonal 4x4 leaves rows/cols >= p+q EXACTLY the
    # identity (Z's padding rows are exact zeros), which sort_schur_real
    # needs: it sums embedded G4 − I terms whose windows may overlap there
    return _householder_q(Xpad + Ipad), ok


def sort_schur_real(T: torch.Tensor, Q: torch.Tensor, which, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reorder a real Schur pair ``(T, Q)`` so that the diagonal blocks
    ascend by the ``which`` key, never splitting a 2x2 block.  Positions
    ``>= k`` (sentinel) keep ``+inf`` keys and stay trailing.  Returns
    ``(T, Q)``."""
    m = T.shape[0]
    rdt, dev = T.dtype, T.device
    mp = m + 4
    kk = int(k)

    # pad to (m+4, m+4) with an identity tail, so 4-windows never clamp
    Tp = torch.eye(mp, dtype=rdt, device=dev)
    Tp[:m, :m] = T
    Qp = torch.eye(mp, dtype=rdt, device=dev)
    Qp[:m, :m] = Q

    rows = torch.arange(mp, device=dev)[:, None]
    cols = torch.arange(mp, device=dev)[None, :]
    pidx = torch.arange(mp, device=dev)
    jidx = torch.arange(m, device=dev)
    eyemp = torch.eye(mp, dtype=rdt, device=dev)
    eye4 = torch.eye(4, dtype=rdt, device=dev)
    four = torch.arange(4, device=dev)
    # Esel[j]: (4, mp) selector of rows j..j+3, Esel[j][a, r] = (r == j + a)
    Esel = (pidx[None, None, :] == (jidx[:, None, None] + four[None, :, None])).to(rdt)
    widx = jidx[:, None] + four[None, :]  # (m, 4) window indices
    wr, wc = four[None, :, None], four[None, None, :]
    zero1 = torch.zeros(1, dtype=rdt, device=dev)
    false1 = torch.zeros(1, dtype=torch.bool, device=dev)

    def e_of(v):
        return (pidx[None, :] == v[:, None]).to(rdt)

    def block_meta(Tp):
        """Per-position vectors: ``two[j]`` (j starts a 2x2), ``second[j]``
        (j is the trailing member) and the block sort key replicated onto
        both members (+inf beyond the active block)."""
        d = torch.diagonal(Tp)
        up = torch.cat([torch.diagonal(Tp, 1), zero1])
        lo = torch.cat([torch.diagonal(Tp, -1), zero1])
        nz = (lo != 0) & (pidx < kk - 1)
        prev = torch.cat([false1, nz[:-1]])
        two = nz & ~prev
        second = torch.cat([false1, two[:-1]])
        d_next = torch.roll(d, -1)
        half = (d - d_next) / 2
        disc = half * half + up * lo
        im = torch.where(two, torch.sqrt(torch.clamp(-disc, min=0.0)), 0.0)
        re = torch.where(two, (d + d_next) / 2, d)
        key = which_key_ri(re, im, which)
        key = torch.where(second, torch.roll(key, 1), key)  # share with partner
        key = torch.where(pidx < kk, key, float("inf"))
        return two, second, key

    def sub_pass(Tp, Qp, parity: int):
        """One parity sub-pass: swap all adjacent block pairs (lead block
        index ≡ parity mod 2) whose keys are out of order, as ONE accumulated
        orthogonal similarity.  Standardization waits for a single pass after
        the sort: swaps keep each block's eigenvalue pair, and block detection
        and keys need only the subdiagonal and the 2x2 trace/determinant."""
        two, second, key = block_meta(Tp)
        start = ~second & (pidx < kk)
        bidx = torch.cumsum(start.to(torch.int64), 0) - 1  # block index per position

        p = 1 + two[:m].to(torch.int64)  # lead block size at j
        n0 = jidx + p  # next block start
        q = 1 + two[n0].to(torch.int64)
        fits = n0 + q <= kk
        cand = start[:m] & ((bidx[:m] % 2) == parity) & fits & (key[:m] > key[n0])

        # 4x4 window rotations for every position (masked below)
        W = Tp[widx[:, :, None], widx[:, None, :]]
        pqb = (p + q)[:, None, None]
        W = torch.where((wr < pqb) & (wc < pqb), W, 0.0) + torch.where(
            (wr == wc) & (wr >= pqb), 1.0, 0.0).to(rdt)
        G4, ok = _swap_window(W, p, q)
        do = cand & ok
        D = torch.where(do[:, None, None], G4 - eye4, 0.0)
        # disjoint windows (parity schedule) ⇒ I + Σ_j E_jᵀ (G4_j − I) E_j is
        # exactly the product of the embedded rotations
        G = eyemp + torch.einsum("jar,jab,jbs->rs", Esel, D, Esel)
        Tn = G.T @ Tp @ G
        Qn = Qp @ G

        # clean: zero the strictly-lower in-window entries except the new
        # standard 2x2 subdiagonals at (j+1, j) [q == 2] and (j+q+1, j+q)
        # [p == 2]
        wmask = ((pidx[None, :] >= jidx[:, None])
                 & (pidx[None, :] < (jidx + p + q)[:, None])
                 & do[:, None]).to(rdt)  # (m, mp)
        inwin = (wmask.T @ wmask) > 0
        K1 = (e_of(jidx + 1) * (do & (q == 2))[:, None].to(rdt)).T @ e_of(jidx)
        K2 = (e_of(jidx + q + 1) * (do & (p == 2))[:, None].to(rdt)).T @ e_of(jidx + q)
        lower = inwin & (rows > cols) & (K1 + K2 == 0)
        Tn = torch.where(lower, 0.0, Tn)
        return Tn, Qn, torch.any(do)

    def standardize_all(Tn, Qn):
        """Re-standardize ALL 2x2 blocks with one accumulated lanv2 rotation
        (the identity for blocks already in standard form; the blocks are
        disjoint, so the sum of embedded rotations is their product)."""
        t2 = block_meta(Tn)[0][:m]
        d = torch.diagonal(Tn)
        up = torch.cat([torch.diagonal(Tn, 1), zero1])
        lo = torch.cat([torch.diagonal(Tn, -1), zero1])
        a, b = d[:m], up[:m]
        c, dd = lo[:m], torch.roll(d, -1)[:m]
        cs, sn = lanv2_rotation(a, b, c, dd)
        cs = torch.where(t2, cs, 1.0)
        sn = torch.where(t2, sn, 0.0)
        # the rotation acts on rows (j, j+1): embed [[cs, −sn], [sn, cs]] − I2
        R2 = torch.stack([torch.stack([cs - 1.0, -sn], dim=-1),
                          torch.stack([sn, cs - 1.0], dim=-1)], dim=-2)  # (m, 2, 2)
        E2 = Esel[:, :2, :]
        R = eyemp + torch.einsum("jar,jab,jbs->rs", E2, R2, E2)
        Tn = R.T @ Tn @ R
        Qn = Qn @ R
        # lanv2 triangularizes a 2x2 with real eigenvalues: clean its
        # subdiagonal entry
        disc = ((a - dd) / 2) ** 2 + b * c
        split = t2 & (disc >= 0)
        hit = ((e_of(jidx + 1) * split[:, None].to(rdt)).T @ e_of(jidx)) > 0
        return torch.where(hit, 0.0, Tn), Qn

    # a round (even + odd sub-pass) with no swaps ⇒ sorted; the nearly sorted
    # matrices of a Krylov-Schur restart leave after about one round
    nround, swapped = 0, True
    while swapped and nround < (m + 2) // 2 + 1:
        Tp, Qp, s0 = sub_pass(Tp, Qp, 0)
        Tp, Qp, s1 = sub_pass(Tp, Qp, 1)
        swapped = bool(s0 | s1)
        nround += 1
    Tp, Qp = standardize_all(Tp, Qp)
    return Tp[:m, :m].clone(), Qp[:m, :m].clone()
