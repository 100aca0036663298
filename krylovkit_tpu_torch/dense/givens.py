"""Complex Givens rotations (counterpart of ``krylovkit_tpu/dense/givens.py``;
reference ``src/dense/givens.jl``), used by the GMRES incremental QR of the
shifted Hessenberg (``src/linsolve/gmres.jl:72-94``)."""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["givens"]


def givens(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Compute ``(c, s, r)`` with ``c`` real ≥ 0, ``|c|² + |s|² = 1`` and

        [ c         conj(s) ] [a]   [r]
        [-s         c       ] [b] = [0]

    Guarded for ``a = b = 0`` (returns the identity rotation)."""
    absa = torch.abs(a)
    n = torch.sqrt(absa ** 2 + torch.abs(b) ** 2)
    safe = n > 0
    one = torch.ones((), dtype=n.dtype, device=n.device)
    nn = torch.where(safe, n, one)
    # phase of a (1 if a == 0)
    pha = torch.where(absa > 0, a / torch.where(absa > 0, absa, one), torch.ones_like(a))
    c = torch.where(safe, absa / nn, one)
    s = torch.where(safe, torch.conj(pha) * b / nn, torch.zeros_like(b))
    r = torch.where(safe, pha * nn, torch.zeros_like(a))
    return c, s, r
