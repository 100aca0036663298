"""Block of vectors for block Krylov methods (counterpart of
``krylovkit_tpu/ops/block.py``; reference ``Block``,
``src/factorizations/blocklanczos.jl:10-17``).

The port's vectors are single tensors, so a block is one tensor of shape
``(b,) + x.shape``: block inner products are single matrix products, and
the Block Lanczos expansion applies the operator to its rows one by one.
"""

from __future__ import annotations

import functools
from typing import Sequence, Union

import torch

__all__ = ["Block"]


class Block:
    """``Block([v1, v2, ...])`` stacks same-shaped vectors along a new
    leading axis (in their promoted dtype); ``Block(t, stacked=True)``
    adopts an already-stacked tensor ``t``."""

    def __init__(self, vectors: Union[Sequence[torch.Tensor], torch.Tensor], stacked: bool = False):
        if stacked:
            self.stacked = vectors
        else:
            vecs = list(vectors)
            if len(vecs) == 0:
                raise ValueError("Block requires at least one vector")
            dt = functools.reduce(torch.promote_types, (v.dtype for v in vecs))
            self.stacked = torch.stack([v.to(dt) for v in vecs])

    @property
    def size(self) -> int:
        return self.stacked.shape[0]

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, i: int) -> torch.Tensor:
        return self.stacked[i]
