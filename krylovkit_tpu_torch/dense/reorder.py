"""Reordering of a complex Schur form (counterpart of
``krylovkit_tpu/dense/reorder.py``; the reference's ``permuteschur!`` /
``trexc`` / ``trsen``, ``src/dense/linalg.jl:335-393, 538-585``).

The Krylov-Schur restart keeps the leading columns, so the Schur form is
sorted by the ``which`` criterion: a bubble sort of the diagonal in which an
adjacent swap of ``(d1, d2)`` applies the 2×2 unitary whose first column is
the normalized eigenvector ``[t12, d2 - d1]`` of the trailing eigenvalue, a
Givens similarity confined to rows/cols ``(j, j+1)``.

Which pairs swap depends on the keys alone, and a swap only exchanges two
keys; so the keys are read to the host once and the sort's control flow runs
there, applying on the device exactly the rotations the JAX package's masked
passes apply (its identity rotations are skipped).
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["sort_schur", "partition_schur"]


def _swap_rotation(d1, t12, d2) -> torch.Tensor:
    """2×2 unitary ``G`` with first column ∝ ``[t12, d2-d1]`` (eigenvector of
    ``d2``): ``Gᴴ [[d1,t12],[0,d2]] G = [[d2,*],[0,d1]]``.  The identity if
    the vector vanishes."""
    v1, v2 = t12, d2 - d1
    n = torch.sqrt(torch.abs(v1) ** 2 + torch.abs(v2) ** 2)
    safe = n > 0
    nn = torch.where(safe, n, 1)
    a = torch.where(safe, v1 / nn, 1)
    b = torch.where(safe, v2 / nn, 0)
    # columns: [a, b] and its orthogonal complement [-conj(b), conj(a)]
    return torch.stack([torch.stack([a, -torch.conj(b)]), torch.stack([b, torch.conj(a)])])


def sort_schur(T: torch.Tensor, Q: torch.Tensor, key: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reorder a complex Schur form so that the diagonal keys ascend.

    ``key`` is a real ``(m,)`` tensor (smaller = moves toward the top-left;
    entries that must stay last, e.g. the inactive sentinel block, carry
    ``+inf``).  Returns ``(T, Q, key_sorted)``; the inputs are not modified."""
    m = T.shape[0]
    T, Q = T.clone(), Q.clone()
    keys = key.tolist()
    perm = list(range(m))
    npass, swapped = 0, True
    # early exit on the first swap-free pass; bounded by m + 1 passes
    while swapped and npass < m + 1:
        swapped = False
        for j in range(m - 1):
            if not keys[j] > keys[j + 1]:
                continue
            G = _swap_rotation(T[j, j], T[j, j + 1], T[j + 1, j + 1])
            T[j:j + 2, :] = G.conj().T @ T[j:j + 2, :]
            T[:, j:j + 2] = T[:, j:j + 2] @ G
            Q[:, j:j + 2] = Q[:, j:j + 2] @ G
            T[j + 1, j] = 0  # exact zero below the swapped diagonal
            keys[j], keys[j + 1] = keys[j + 1], keys[j]
            perm[j], perm[j + 1] = perm[j + 1], perm[j]
            swapped = True
        npass += 1
    return T, Q, key[torch.tensor(perm, device=key.device)]


def partition_schur(T: torch.Tensor, Q: torch.Tensor, select: torch.Tensor):
    """Move the selected eigenvalues to the leading block (reference
    ``trsen!``/``partitionschur!``, ``src/dense/linalg.jl:388-393, 538-585``).

    ``select`` is a boolean ``(m,)`` mask; returns ``(T, Q, nselected)``.
    Stable: selected eigenvalues keep their relative order, as do the rest."""
    m = T.shape[0]
    pos = torch.arange(m, device=T.device).to(T.dtype.to_real())
    key = torch.where(select, pos, pos + m)  # stable two-group key
    T, Q, _ = sort_schur(T, Q, key)
    return T, Q, int(torch.sum(select))
