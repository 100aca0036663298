"""The collectives of a sharded solve: one mesh axis as this rank sees it
(:class:`MeshAxis`) and the all-reduce that finishes its psums and carries
its ``ppermute`` rounds.

A sharded space (``VectorSpace(psum_axis=...)``) holds a :class:`MeshAxis`;
the meshes that make them are built in ``parallel/mesh.py``.  Every
collective is one ``dist.all_reduce``, started asynchronously
(:meth:`MeshAxis.psum_start`); a psum waits at once, a halo exchange does
its interior work first.

:data:`stats` counts the collectives of this process (calls, bytes) and,
with :data:`time_collectives` on, the seconds spent in them: from the start
of each all-reduce (after a device synchronization, so work queued before
it is not charged) to the end of its ``wait()``, less the time between the
two (the work it overlaps).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Tuple

import torch
import torch.distributed as dist

__all__ = [
    "MeshAxis",
    "Pending",
    "as_axis",
    "stats",
    "reset_stats",
    "time_collectives",
]

# collectives of this process: all-reduces, bytes reduced, seconds (timed
# only with time_collectives on)
stats = {"collectives": 0, "bytes": 0, "seconds": 0.0}
time_collectives = False


def reset_stats() -> None:
    stats.update(collectives=0, bytes=0, seconds=0.0)


class Pending:
    """An all-reduce in flight on ``t`` (summed in place); :meth:`wait`
    finishes it and returns ``t``.  ``work`` is ``None`` for a sum over one
    rank, which is already done."""

    __slots__ = ("t", "work", "start_s")

    def __init__(self, t: torch.Tensor, work=None, start_s: float = 0.0):
        self.t, self.work, self.start_s = t, work, start_s

    def wait(self) -> torch.Tensor:
        if self.work is not None:
            t0 = time.perf_counter()
            self.work.wait()
            if time_collectives:
                stats["seconds"] += self.start_s + time.perf_counter() - t0
            self.work = None
        return self.t


def _all_reduce_start(t: torch.Tensor, group) -> Pending:
    """Start summing ``t`` in place over ``group``, counted in :data:`stats`."""
    timed = time_collectives
    if timed:
        if t.device.type == "cuda":
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
    work = dist.all_reduce(t, group=group, async_op=True)
    stats["collectives"] += 1
    stats["bytes"] += t.numel() * t.element_size()
    return Pending(t, work, time.perf_counter() - t0 if timed else 0.0)


@dataclasses.dataclass(frozen=True, eq=False)
class MeshAxis:
    """One axis of a mesh as this rank sees it: the process group of the
    ranks that share its other coordinate, their number ``size`` and this
    rank's ``index`` along the axis.  ``VectorSpace(psum_axis=...)`` holds
    one; it compares by identity."""

    name: str
    group: Any
    size: int
    index: int

    def psum_start(self, t: torch.Tensor) -> Pending:
        """Start summing ``t`` in place over the axis.  A sum over one rank,
        or of a ``meta`` tensor (a dtype probe), is done at once, with no
        collective.  A ``ppermute`` round is such a sum of a zero-filled
        ``(size, ...)`` buffer in which each rank writes its payload into
        the slot of the rank that receives it; each rank reads its own
        slot after the wait."""
        if self.size == 1 or t.device.type == "meta":
            return Pending(t)
        return _all_reduce_start(t, self.group)

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the axis, as a new tensor (``t`` itself
        when no collective runs)."""
        if self.size == 1 or t.device.type == "meta":
            return t
        return self.psum_start(t.detach().clone().contiguous()).wait()

    def edges(self, first: torch.Tensor, last: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The neighbours' edge rows: ``(from_left, from_right)`` are the
        ``last`` rows of the rank before and the ``first`` rows of the rank
        after, zero at the ends of the axis (a Dirichlet boundary), in one
        all-reduce (JAX: two ``ppermute``s with the chain permutations)."""
        slots = torch.zeros((self.size, 2) + tuple(first.shape), dtype=first.dtype,
                            device=first.device)
        if self.index + 1 < self.size:
            slots[self.index + 1, 0] = last
        if self.index > 0:
            slots[self.index - 1, 1] = first
        got = self.psum_start(slots).wait()[self.index]
        return got[0], got[1]


def as_axis(axis) -> MeshAxis:
    """A :class:`MeshAxis` from what ``psum_axis`` is given: an axis, or a
    process group (its size and this rank's index read from it)."""
    if isinstance(axis, MeshAxis):
        return axis
    return MeshAxis(str(axis), axis, dist.get_world_size(axis), dist.get_rank(axis))
