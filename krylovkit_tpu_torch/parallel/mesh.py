"""Process-group meshes — the distribution layer (counterpart of
``krylovkit_tpu/parallel/mesh.py``).

The JAX package runs a sharded solve inside ``shard_map``: every device
holds a contiguous block of the vector's rows, inner products finish with
one ``psum`` over the mesh axis (``VectorSpace(psum_axis=...)``) and
operators exchange halos with ``ppermute``.  Here every process (rank) of
a ``torch.distributed`` default group runs the same solver on its own rows
(SPMD), and both collectives are one ``dist.all_reduce``:

* a psum is an all-reduce of the local partials;
* a ``ppermute`` round is a zero-filled ``(D, L)`` buffer in which each rank
  writes its payload into the slot of the rank that receives it; after one
  all-reduce each rank reads its own slot.  It moves ``D`` times the halo
  bytes, and it runs on every backend on CPU and CUDA tensors alike (gloo
  runs no ``send``/``recv`` on CUDA tensors, and NCCL refuses two ranks on
  one card).

Initializing the default group is the caller's job (``torchrun``, or
``dist.init_process_group`` with an address, the world size and the rank);
:func:`make_mesh` splits it into a ``(batch, vec)`` grid of ranks and makes
one group per row and per column.  A second axis, ``BATCH_AXIS``, holds
independent problems (several right-hand sides), the data-parallel
analogue: ``shard_vector(X, mesh, batched=True)`` gives each rank its batch
row's problems, a ``(P_b, ...)`` stack of its block of their rows, which the
batched drivers (``solvers/batched.py``, ``batched_linsolve.py``,
``batched_arnoldi.py``, ``batched_expintegrator.py``) solve with
``VectorSpace(psum_axis=mesh.axis(VECTOR_AXIS))``: every collective of a
solve runs over its ``vec`` group, so batch rows never talk; a caller
gathers the results over the ``batch`` axis at the end.

:class:`MeshAxis` (an axis as one rank sees it) and the collective
counters (``stats``, and ``time_collectives`` that times them) live in
``ops/collectives.py``, below the spaces that hold the axes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..ops.collectives import MeshAxis
from ..ops.vector import tree_map

PyTree = Any

VECTOR_AXIS = "vec"  # shards the vector dimension (tensor-parallel analogue)
BATCH_AXIS = "batch"  # shards independent problems (data-parallel analogue)

__all__ = [
    "VECTOR_AXIS",
    "BATCH_AXIS",
    "Mesh",
    "MeshAxis",
    "make_mesh",
    "shard_vector",
    "replicate",
]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A ``(batch, vec)`` grid of the ranks of the default group.  ``shape``
    maps an axis name to its size (as ``jax.sharding.Mesh.shape``);
    ``axes`` holds this rank's :class:`MeshAxis` of each name; ``device``
    is where this rank's tensors live."""

    shape: dict
    axes: dict
    ranks: Tuple[int, ...]
    device: torch.device

    def axis(self, name: str = VECTOR_AXIS) -> MeshAxis:
        return self.axes[name]

    @property
    def root(self) -> int:
        """The global rank at coordinate ``(0, 0)``."""
        return self.ranks[0]


def _mesh_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: device 'cuda' needs a card on every rank and none is "
                "available here; pass device='cpu' to run the ranks on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(
    n_devices: Optional[int] = None,
    batch: int = 1,
    devices: Optional[Sequence[int]] = None,
    device="cuda",
) -> Mesh:
    """A ``(batch, vec)`` mesh over the ranks of the default process group.

    ``devices`` lists the global ranks of the mesh in row-major order (all
    of them by default); ``n_devices`` keeps the first so many.  With
    ``batch=1`` (default) every rank shards the vector dimension.  Every
    rank of the default group must call this, in the same order as its
    other group constructors (``dist.new_group`` is collective), and each
    gets the mesh seen from its own coordinates.  ``device`` (default
    ``"cuda"``, the current card) is where this rank's vectors live; there
    is no fall-back to the CPU."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs an initialized default process group: call "
            "torch.distributed.init_process_group(...) (or run under torchrun) first"
        )
    dev = _mesh_device(device)
    ranks = list(devices if devices is not None else range(dist.get_world_size()))
    if n_devices is not None:
        ranks = ranks[:n_devices]
    n = len(ranks)
    if n == 0 or n % batch != 0:
        raise ValueError(f"{n} ranks not divisible by batch={batch}")
    nvec = n // batch
    grid = [ranks[b * nvec:(b + 1) * nvec] for b in range(batch)]
    me = dist.get_rank()
    # an axis of one rank never communicates and needs no group, so a
    # one-rank mesh (devices=[rank]) needs no collective call to make
    vec_groups = [dist.new_group(row) if nvec > 1 else None for row in grid]
    batch_groups = [dist.new_group([grid[b][v] for b in range(batch)]) if batch > 1 else None
                    for v in range(nvec)]
    if me not in ranks:
        raise ValueError(f"rank {me} is not in the mesh's ranks {ranks}")
    pos = ranks.index(me)
    b, v = divmod(pos, nvec)
    axes = {
        VECTOR_AXIS: MeshAxis(VECTOR_AXIS, vec_groups[b], nvec, v),
        BATCH_AXIS: MeshAxis(BATCH_AXIS, batch_groups[v], batch, b),
    }
    return Mesh({BATCH_AXIS: batch, VECTOR_AXIS: nvec}, axes, tuple(ranks), dev)


def _block(l: torch.Tensor, dim: int, ax: MeshAxis) -> torch.Tensor:
    size = l.shape[dim]
    if size % ax.size:
        raise ValueError(f"axis {dim} of length {size} does not split into {ax.size} blocks")
    per = size // ax.size
    return l.narrow(dim, ax.index * per, per)


def shard_vector(x: PyTree, mesh: Mesh, batched: bool = False) -> PyTree:
    """This rank's block of each leaf of ``x`` (tensors or numpy arrays,
    the same global data on every rank), on ``mesh.device``.

    The leading (row) axis is split into contiguous blocks over
    ``VECTOR_AXIS``; a tile-aligned ``(n/128, 128)`` vector so keeps whole
    rows.  With ``batched=True`` the leading axis indexes independent
    problems and is split over ``BATCH_AXIS`` first (this rank keeps its
    block of problems), then axis 1 over ``VECTOR_AXIS``."""
    vec, bat = mesh.axes[VECTOR_AXIS], mesh.axes[BATCH_AXIS]

    def leaf(l):
        l = torch.as_tensor(l)
        if batched and l.ndim >= 2:
            out = _block(_block(l, 0, bat), 1, vec)
        else:
            out = _block(l, 0, vec)
        return out.to(mesh.device).contiguous()

    return tree_map(leaf, x)


def replicate(x: PyTree, mesh: Mesh) -> PyTree:
    """Every leaf of ``x`` as the mesh root holds it, on every rank of the
    mesh (one broadcast per leaf), on ``mesh.device``: small dense data all
    ranks must agree on bit for bit."""
    n = len(mesh.ranks)
    group = dist.new_group(list(mesh.ranks)) if 1 < n < dist.get_world_size() else None

    def leaf(l):
        t = torch.as_tensor(l).to(mesh.device).contiguous().clone()
        if n > 1:
            dist.broadcast(t, src=mesh.root, group=group)
        return t

    return tree_map(leaf, x)
