"""Masked triangular solve and matrix exponential of the projected problem
(counterpart of ``krylovkit_tpu/dense/triangular.py``).

* ``solve_upper_active``: the GMRES back-substitution (reference ``ldiv!`` on
  ``UpperTriangular``, ``src/dense/linalg.jl:96-106``).
* ``expm_active``: dense ``exp`` of the augmented projected matrix of
  ``expintegrator`` (reference ``src/matrixfun/expintegrator.jl:202``).
"""

from __future__ import annotations

import torch

from .masking import embed_active

__all__ = ["solve_upper_active", "expm_active"]


def solve_upper_active(R: torch.Tensor, b: torch.Tensor, k: int) -> torch.Tensor:
    """Solve ``R[:k,:k] y = b[:k]`` on the static buffer; ``y[j>=k] = 0``."""
    m = R.shape[0]
    Meff = embed_active(R, k, 1.0)
    live = torch.arange(m, device=R.device) < k
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    beff = torch.where(live, b, zero)
    y = torch.linalg.solve_triangular(Meff, beff[:, None], upper=True)[:, 0]
    return torch.where(live, y, zero)


def expm_active(M: torch.Tensor, k: int) -> torch.Tensor:
    """``exp`` of the active block (the inactive part becomes the identity,
    which the caller never reads)."""
    return torch.linalg.matrix_exp(embed_active(M, k, 0.0))
