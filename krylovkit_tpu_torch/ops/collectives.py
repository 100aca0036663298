"""The collectives of a sharded solve: one mesh axis as this rank sees it
(:class:`MeshAxis`) and the all-reduce that finishes its psums and carries
its ``ppermute`` rounds.

A sharded space (``VectorSpace(psum_axis=...)``) holds a :class:`MeshAxis`;
the meshes that make them are built in ``parallel/mesh.py``.  Every
collective is one ``dist.all_reduce``, started asynchronously
(:meth:`MeshAxis.psum_start`); a psum waits at once, a halo exchange does
its interior work first.

The psum and the edge exchange are differentiable (each a
``torch.autograd.Function``, which ``torch.func`` transforms too): the
transpose of a psum is a psum of the cotangent, and that of the edge
exchange sends each neighbour's cotangent back to it, in one all-reduce of
the same layout (the transposes of the JAX package's ``psum`` and
``ppermute`` inside ``shard_map``).  A derivative through any other
collective, such as a direct ``torch.distributed`` call, is an error
(:func:`strict_collectives`).

:data:`stats` counts the collectives of this process (calls, bytes) and,
with :data:`time_collectives` on, the seconds spent in them: from the start
of each all-reduce (after a device synchronization, so work queued before
it is not charged) to the end of its ``wait()``, less the time between the
two (the work it overlaps).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
import warnings
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
    "strict_collectives",
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
        when no collective runs).  Differentiable: the backward sums the
        ranks' cotangents of the output, as the JAX package's ``psum``
        transposes inside ``shard_map`` with ``check_vma=False``.  Each
        rank's cotangent of the output is thus a partial: a replicated loss
        reduced through the axis and differentiated on every rank (say
        ``space.inner(c, x).backward()``) gives ``D`` times its gradient, so
        divide such a loss by ``D`` or build it from the ranks' local
        partials."""
        if self.size == 1 or t.device.type == "meta":
            return t
        if _untracked(t):
            return self._sum(t)
        return _Psum.apply(t, self)

    def _sum(self, t: torch.Tensor) -> torch.Tensor:
        return self.psum_start(t.detach().clone().contiguous()).wait()

    def edges(self, first: torch.Tensor, last: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The neighbours' edge rows: ``(from_left, from_right)`` are the
        ``last`` rows of the rank before and the ``first`` rows of the rank
        after, zero at the ends of the axis (a Dirichlet boundary), in one
        all-reduce (JAX: two ``ppermute``s with the chain permutations).
        The payload may have any shape: a ``(P, h, ...)`` stack of the edge
        rows of ``P`` problems goes in the same one all-reduce.
        Differentiable: the backward is the transposed exchange."""
        if _untracked(first, last):
            return self._swap(first, last)
        return _Edges.apply(first, last, self)

    def _swap(self, to_left: torch.Tensor, to_right: torch.Tensor):
        """One all-reduce of a zero-filled ``(size, 2) + to_left.shape``
        buffer, whatever that shape (a stack of problems' rows too): this
        rank's ``to_right`` goes to slot 0 of the rank after, its ``to_left``
        to slot 1 of the rank before; returns this rank's two slots."""
        slots = torch.zeros((self.size, 2) + tuple(to_left.shape), dtype=to_left.dtype,
                            device=to_left.device)
        if self.index + 1 < self.size:
            slots[self.index + 1, 0] = to_right
        if self.index > 0:
            slots[self.index - 1, 1] = to_left
        got = self.psum_start(slots).wait()[self.index]
        return got[0], got[1]


def _untracked(*ts) -> bool:
    """Whether no derivative can be taken through a collective of ``ts``
    (none requires grad where gradients are on, no ``torch.func`` transform
    is active): it then runs without its ``torch.autograd.Function``, whose
    every ``apply`` binds its arguments by ``inspect.signature``."""
    return (not (torch.is_grad_enabled() and any(t.requires_grad for t in ts))
            and not torch._C._are_functorch_transforms_active())


class _Psum(torch.autograd.Function):
    """``t`` summed over a mesh axis; its transpose sums the cotangent."""

    @staticmethod
    def forward(t, axis):
        return axis._sum(t)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.axis = inputs[1]

    @staticmethod
    def backward(ctx, g):
        # a psum again, itself differentiable (a derived adjoint's graph)
        return _Psum.apply(g, ctx.axis), None


class _Edges(torch.autograd.Function):
    """The edge exchange of :meth:`MeshAxis.edges`.  Its transpose sends the
    cotangent of ``from_left`` back to the rank before, as that of its
    ``last`` rows, and the cotangent of ``from_right`` to the rank after, as
    that of its ``first`` rows: the same exchange with the directions
    swapped, so every rank makes one all-reduce in the forward and one in
    the backward."""

    @staticmethod
    def forward(first, last, axis):
        # from the left neighbour: its last rows; from the right: its first
        return axis._swap(first, last)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.axis = inputs[2]

    @staticmethod
    def backward(ctx, g_left, g_right):
        # the same exchange, itself differentiable (a derived adjoint's graph)
        return (*_Edges.apply(g_left, g_right, ctx.axis), None)


@contextlib.contextmanager
def strict_collectives():
    """Inside, a derivative taken through a collective that has no
    derivative (a direct ``torch.distributed`` call on a tensor that
    requires grad, which torch would skip with a warning and a wrong
    gradient) raises ``RuntimeError`` instead.  It turns into an error the
    warning of torch's autograd fallback for an operator with no autograd
    kernel (torch 2.1 and later, in its default ``warn`` mode); the
    autograd engine replays a warning of its device threads on the calling
    thread, so the guard holds for CUDA tensors too.  ``warnings`` filters
    are process-wide: a backward in another thread at the same time is
    guarded too."""
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=r".*an autograd kernel was not registered")
        try:
            yield
        except UserWarning as w:
            raise RuntimeError(
                f"a derivative through a collective that has none ({w}): a sharded map "
                "differentiates only through its space's psum and the edge and halo "
                "exchanges of shard_local_stencil and ShardedELLOperator; give the "
                "operator an explicit adjoint (adjoint_fn, or an (f, fadjoint) pair)"
            ) from None


def as_axis(axis) -> MeshAxis:
    """A :class:`MeshAxis` from what ``psum_axis`` is given: an axis, or a
    process group (its size and this rank's index read from it)."""
    if isinstance(axis, MeshAxis):
        return axis
    return MeshAxis(str(axis), axis, dist.get_world_size(axis), dist.get_rank(axis))
