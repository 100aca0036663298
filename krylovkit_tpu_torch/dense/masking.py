"""Static-shape masking for the small dense projected problems (counterpart
of ``krylovkit_tpu/dense/masking.py``).

The projected matrix lives in a fixed ``(m, m)`` buffer with the active
``k×k`` block embedded block-diagonally; the inactive diagonal carries a
sentinel outside the active spectrum, so spurious solutions are found by the
support of their vectors.
"""

from __future__ import annotations

from typing import Union

import torch

from ..algorithms import EigSorter

__all__ = [
    "active_mask",
    "embed_active",
    "spectrum_sentinel",
    "active_support",
    "which_key",
    "sort_perm",
]


def active_mask(m: int, k: int, device=None) -> torch.Tensor:
    """Boolean ``(m, m)`` mask of the active leading ``k×k`` block."""
    i = torch.arange(m, device=device)
    return (i[:, None] < k) & (i[None, :] < k)


def spectrum_sentinel(M: torch.Tensor, k: int) -> torch.Tensor:
    """A real value strictly outside the spectrum of the active block
    (Gershgorin: every active eigenvalue has ``|λ| <=`` max abs row sum)."""
    m = M.shape[0]
    Ma = torch.where(active_mask(m, k, M.device), M, torch.zeros((), dtype=M.dtype, device=M.device))
    bound = torch.max(torch.sum(torch.abs(Ma), dim=1))
    return (2 * bound + 1).to(M.dtype.to_real())


def embed_active(M: torch.Tensor, k: int, sentinel: Union[torch.Tensor, float]) -> torch.Tensor:
    """Zero the inactive rows/cols of ``M`` and put ``sentinel`` on the
    inactive diagonal."""
    m = M.shape[0]
    zero = torch.zeros((), dtype=M.dtype, device=M.device)
    out = torch.where(active_mask(m, k, M.device), M, zero)
    d = torch.arange(m, device=M.device)
    sent = torch.as_tensor(sentinel, dtype=M.dtype.to_real(), device=M.device).to(M.dtype)
    return out + torch.diag(torch.where(d >= k, sent, zero))


def active_support(U: torch.Tensor, k: int) -> torch.Tensor:
    """Fraction of each column's mass inside the active rows (0 or 1 for an
    exactly block-diagonal problem; ``> 0.5`` flags genuine solutions)."""
    rows = torch.arange(U.shape[0], device=U.device)[:, None]
    a2 = torch.abs(U) ** 2
    num = torch.sum(torch.where(rows < k, a2, torch.zeros((), dtype=a2.dtype, device=a2.device)), dim=0)
    den = torch.clamp(torch.sum(a2, dim=0), min=torch.finfo(num.dtype).tiny)
    return num / den


def which_key(vals: torch.Tensor, which) -> torch.Tensor:
    """Ascending sort keys for a ``which`` spec (reference ``eigsort``,
    ``src/eigsolve/eigsolve.jl:334-355``); smallest key = most wanted."""
    if isinstance(which, EigSorter):
        key = torch.real(which.by(vals))
        return -key if which.rev else key
    table = {
        "LM": lambda v: -torch.abs(v),
        "SM": lambda v: torch.abs(v),
        "LR": lambda v: -torch.real(v),
        "SR": lambda v: torch.real(v),
        "LI": lambda v: -torch.imag(v),
        "SI": lambda v: torch.imag(v),
    }
    w = which.upper() if isinstance(which, str) else which
    if w not in table:
        raise ValueError(f"unknown which={which!r}; expected one of {list(table)} or EigSorter")
    return table[w](vals)


def sort_perm(vals: torch.Tensor, valid: torch.Tensor, which) -> torch.Tensor:
    """Permutation sorting ``vals`` by ``which`` with invalid entries last.
    The sort is stable, as ``jnp.argsort`` is: ties (the sentinel
    eigenvalues) keep their order."""
    key = which_key(vals, which)
    big = torch.tensor(torch.finfo(key.dtype).max, dtype=key.dtype, device=key.device)
    key = torch.where(valid, key, big)
    return torch.argsort(key, stable=True)
