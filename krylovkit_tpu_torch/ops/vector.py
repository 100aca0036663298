"""Vector space of single tensors — the PyTorch counterpart of
``krylovkit_tpu/ops/vector.py``.

A vector is one tensor of any shape (real or complex).  The main path uses
``(n/128, 128)`` float32 vectors, the layout the fused Lanczos kernel reads.
Custom inner products (the reference's ``InnerProductVec``) and the "real
inner product" of ``realeigsolve`` are carried by a frozen
:class:`VectorSpace`, as in the JAX package.  Sharded spaces (``psum_axis``)
and pytree vectors are not part of this port yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

__all__ = [
    "VectorSpace",
    "STANDARD",
    "REAL",
    "inner",
    "norm",
    "scale",
    "add",
    "zerovector",
]


@dataclasses.dataclass(frozen=True)
class VectorSpace:
    """Inner-product space the solver works in.

    Attributes:
      inner_fn: optional custom inner product ``(x, y) -> scalar tensor``,
        conjugate-linear in ``x``.  ``None`` is the Euclidean inner product.
      real_inner: use ``real(inner(x, y))`` (complex space treated as real).
    """

    inner_fn: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None
    real_inner: bool = False

    def inner(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        ip = self.inner_fn(x, y) if self.inner_fn is not None else _inner(x, y)
        if self.real_inner:
            ip = torch.real(ip)
        return ip

    def norm(self, x: torch.Tensor) -> torch.Tensor:
        nrm2 = torch.real(self.inner(x, x))
        return torch.sqrt(torch.clamp(nrm2, min=0))


STANDARD = VectorSpace()
REAL = VectorSpace(real_inner=True)


def _inner(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Euclidean inner product ``Σ conj(x)·y`` as a 0-d tensor."""
    dt = torch.promote_types(x.dtype, y.dtype)
    return torch.vdot(x.reshape(-1).to(dt), y.reshape(-1).to(dt))


def inner(x, y, space: VectorSpace = STANDARD) -> torch.Tensor:
    return space.inner(x, y)


def norm(x, space: VectorSpace = STANDARD) -> torch.Tensor:
    return space.norm(x)


def scale(x: torch.Tensor, a) -> torch.Tensor:
    """``a * x`` (reference VectorInterface ``scale``)."""
    return a * x


def add(y: torch.Tensor, x: torch.Tensor, a=1, b=1) -> torch.Tensor:
    """``b*y + a*x`` — the reference's ``add!!(y, x, a, b)`` convention."""
    return b * y + a * x


def zerovector(x: torch.Tensor, dtype=None) -> torch.Tensor:
    return torch.zeros_like(x, dtype=dtype or x.dtype)
