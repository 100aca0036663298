"""Complex Schur decomposition of the (masked) projected matrix (counterpart
of ``krylovkit_tpu/dense/schur.py``; the reference's ``hschur!``,
``src/dense/linalg.jl:464-500``).

Householder reduction to Hessenberg form, then explicit Wilkinson-shifted QR
iteration with bottom-up deflation; each sweep is one ``m×m`` QR and two
products on the whole static buffer:

    while hi > 0:  # hi = index of the trailing un-deflated eigenvalue
        if A[hi, hi-1] is negligible: deflate, hi -= 1
        else:
            mu  = Wilkinson shift of the trailing 2x2 (exceptional on stall)
            M   = [[A[:hi+1,:hi+1] - mu I, 0], [0, I]]
            Qi R = qr(M);  A <- Qiᴴ A Qi;  Q <- Q Qi

The arithmetic and the masks are the JAX package's; the loop runs on the
host over ``hi``, ``it``, ``stag`` as Python ints and reads one scalar per
iteration (deflate or sweep).  The active block of size ``k`` is embedded
with an out-of-spectrum sentinel diagonal (``masking.py``), which works on
general active blocks, not only Hessenberg ones.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .hessenberg import hessenberg_reduce
from .masking import embed_active, spectrum_sentinel

__all__ = ["schur_active", "schur_eigvals"]


def _complex_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.complex64)


def _sub(A: torch.Tensor, i: int) -> torch.Tensor:
    """``|A[i, i-1]|`` (0 when ``i <= 0``)."""
    if i <= 0:
        return torch.zeros((), dtype=A.dtype.to_real(), device=A.device)
    return torch.abs(A[i, i - 1])


def schur_active(H: torch.Tensor, k: int, tol: Optional[float] = None,
                 max_sweeps: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, bool]:
    """Complex Schur form of the active ``k×k`` block of ``H``.

    Returns ``(T, Q, ok)`` with ``Q[:k,:k]ᴴ H[:k,:k] Q[:k,:k] = T[:k,:k]``
    upper triangular, ``Q`` unitary (identity-phase on the inactive part) and
    ``ok`` true when every eigenvalue deflated within the sweep budget."""
    m = H.shape[0]
    cdt = _complex_dtype(H.dtype)
    rdt = cdt.to_real()
    if tol is None:
        tol = float(torch.finfo(rdt).eps)
    if max_sweeps is None:
        max_sweeps = 30 * m

    Hc = H.to(cdt)
    A_embedded = embed_active(Hc, k, spectrum_sentinel(Hc, k))
    scale = torch.clamp(torch.max(torch.abs(A_embedded)), min=1.0)
    A, Q = hessenberg_reduce(A_embedded)
    eye = torch.eye(m, dtype=cdt, device=H.device)

    hi, it, stag = max(int(k) - 1, 0), 0, 0
    while hi > 0 and it < max_sweeps:
        off = _sub(A, hi)
        dmag = torch.abs(A[hi, hi]) + torch.abs(A[hi - 1, hi - 1])
        small = off <= tol * torch.maximum(dmag, scale * tol)
        if bool(small):
            A[hi, hi - 1] = 0
            hi, stag = hi - 1, 0
        else:
            a, b = A[hi - 1, hi - 1], A[hi - 1, hi]
            c, d = A[hi, hi - 1], A[hi, hi]
            if stag > 0 and stag % 10 == 0:
                # exceptional shift on stall (LAPACK zlahqr)
                mu = (0.75 * (_sub(A, hi) + _sub(A, hi - 1))).to(cdt) + d
            else:
                tr2 = (a + d) / 2
                disc = torch.sqrt(((a - d) / 2) ** 2 + b * c)
                mu1, mu2 = tr2 + disc, tr2 - disc
                mu = torch.where(torch.abs(mu1 - d) < torch.abs(mu2 - d), mu1, mu2)
            # identity outside the leading hi+1 block: the factorization stays
            # block-diagonal, so the similarity is exact for the full buffer
            M = eye.clone()
            M[: hi + 1, : hi + 1] = A[: hi + 1, : hi + 1] - mu * eye[: hi + 1, : hi + 1]
            Qi, _ = torch.linalg.qr(M)
            # QR of a shifted Hessenberg keeps Hessenberg form; clean the
            # eps-level fill-in so deflation tests stay single-entry
            A = torch.triu(Qi.conj().T @ A @ Qi, -1)
            Q = Q @ Qi
            stag += 1
        it += 1
    return torch.triu(A), Q, hi == 0


def schur_eigvals(T: torch.Tensor) -> torch.Tensor:
    """Eigenvalues from the complex Schur factor (reference
    ``schur2eigvals``, ``src/dense/linalg.jl:156-189``): its diagonal."""
    return torch.diagonal(T)
