"""Block of vectors for block Krylov methods (counterpart of
``krylovkit_tpu/ops/block.py``; reference ``Block``,
``src/factorizations/blocklanczos.jl:10-17``).

A block is a stacked vector: every leaf of the vectors' pytree (one tensor
for a tensor vector) gains a leading axis of the block size, so block inner
products are one matrix product per leaf, and the Block Lanczos expansion
applies the operator to its rows one by one.
"""

from __future__ import annotations

import functools
from typing import Any, Sequence, Union

import torch

from .vector import tree_leaves, tree_map

PyTree = Any

__all__ = ["Block"]


class Block:
    """``Block([v1, v2, ...])`` stacks same-structured vectors along a new
    leading axis, leaf by leaf (each leaf in the promoted dtype of its
    counterparts); ``Block(t, stacked=True)`` adopts an already-stacked
    pytree ``t``."""

    def __init__(self, vectors: Union[Sequence[PyTree], PyTree], stacked: bool = False):
        if stacked:
            self.stacked = vectors
        else:
            vecs = list(vectors)
            if len(vecs) == 0:
                raise ValueError("Block requires at least one vector")

            def stack(*ls):
                dt = functools.reduce(torch.promote_types, (l.dtype for l in ls))
                return torch.stack([l.to(dt) for l in ls])

            self.stacked = tree_map(stack, *vecs)

    @property
    def size(self) -> int:
        return tree_leaves(self.stacked)[0].shape[0]

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, i: int) -> PyTree:
        return tree_map(lambda l: l[i], self.stacked)
