"""Row-partitioned sparse operators (BASELINE.json config 5; counterpart of
``krylovkit_tpu/parallel/sparse.py``).

The matrix rows, and the vectors of its domain and codomain, are split into
``D`` contiguous blocks over a mesh axis (``parallel/mesh.py``), one per
rank.  All communication is planned once, on the host, at construction:

* for every pair (rank ``d``, source rank ``s = (d + δ) mod D``) the exact
  set of remote vector entries rank ``d`` needs is precomputed; round ``δ``
  moves one packed payload of static length.  A banded matrix needs only
  ``δ ∈ {1, D − 1}``; a general graph gets exactly the rounds its sparsity
  requires;
* column indices are remapped per rank into a local buffer ``[own block |
  halo δ₁ | halo δ₂ | …]``: rows whose columns are all local form the
  interior plane, rows that touch a remote column a compressed boundary
  plane that addresses the halo buffer.

An apply packs every round into one all-reduce (the ``ppermute`` rounds of
the JAX package), started before the interior gather, which does not wait
on it; only the boundary rows read the payloads.  The exchange is
differentiable: its transpose sends the cotangents back in one all-reduce,
so a derived adjoint (``torch.autograd`` or ``torch.func.vjp``) of a map
around the operator keeps the halo term.  The gathers are plain PyTorch,
as the JAX package's are plain ``jnp.take`` (no kernel on either side).  The adjoint is planned
independently from the transposed COO, so rectangular maps work and LSMR
and GKL run sharded.

Planning is the JAX package's host numpy, copied, and gives its arrays
exactly; every rank plans the whole COO and keeps its block, as each host
of a multi-host JAX run would.  Unlike the JAX package, :func:`coo_to_ell`
keeps 64-bit indices where a 32-bit flat index could overflow.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.operator import TypedOperator
from .mesh import VECTOR_AXIS, Mesh

__all__ = [
    "ShardedELLOperator",
    "sharded_ell_from_coo",
    "coo_to_ell",
    "banded_coo",
    "rect_sparse_coo",
    "powerlaw_rect_coo",
]

INT32_LIMIT = 2 ** 31


# ---------------------------------------------------------------------------
# host-side planning (numpy, vectorized: runs once at construction)
# ---------------------------------------------------------------------------


def _stable_order(keys):
    """Stable grouping permutation of an integer key array (torch's CPU
    stable sort, a multithreaded radix sort)."""
    t = torch.from_numpy(np.ascontiguousarray(keys))
    return torch.argsort(t, stable=True).numpy()


def index_dtype(nnz: int, n_rows: int, width: int, n_cols: int = 0):
    """``np.int32`` where every row id, column id, entry count and flat ELL
    index ``< n_rows·width`` fits in 31 bits, else ``np.int64``."""
    if max(nnz, n_rows * width, n_rows, n_cols) >= INT32_LIMIT:
        return np.int64
    return np.int32


def coo_to_ell(rows, cols, vals, n_rows: int):
    """Vectorized COO→ELLPACK packing.  Returns ``(ell_cols, ell_vals,
    valid)`` of shape ``(n_rows, width)``; padding slots have
    ``valid=False``.  Entries keep their input order within a row (one
    stable sort by row; row-sorted input skips it).  Indices are int32, or
    int64 where :func:`index_dtype` says they would overflow."""
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    vals = np.asarray(vals)
    counts = np.bincount(rows, minlength=n_rows)
    width = max(int(counts.max()) if counts.size else 0, 1)
    n_cols = int(cols.max()) + 1 if cols.size else 0
    it = index_dtype(rows.size, n_rows, width, n_cols)
    rows_i = rows if rows.dtype == it else rows.astype(it)
    cols_i = cols if cols.dtype == it else cols.astype(it)
    if rows.size and np.all(rows_i[1:] >= rows_i[:-1]):
        r, c, v = rows_i, cols_i, vals
    else:
        order = _stable_order(rows_i)
        r, c, v = rows_i[order], cols_i[order], vals[order]
    starts = np.zeros(n_rows + 1, it)
    starts[1:] = np.cumsum(counts)
    # flat ELL index in place: slot = arange − starts[r], then += r·width;
    # slots fill left to right, so valid[i, j] ⇔ j < counts[i]
    flat = np.arange(len(r), dtype=it)
    flat -= starts[r]
    flat += r * it(width)
    ell_cols = np.zeros(n_rows * width, it)
    ell_vals = np.zeros(n_rows * width, vals.dtype)
    ell_cols[flat] = c
    ell_vals[flat] = v
    valid = np.arange(width, dtype=counts.dtype)[None, :] < counts[:, None]
    return ell_cols.reshape(n_rows, width), ell_vals.reshape(n_rows, width), valid


@dataclasses.dataclass(frozen=True)
class _HaloPlan:
    """Static communication schedule for one direction of a sharded SpMV."""

    deltas: Tuple[int, ...]  # rounds: rank d receives from (d+δ)%D
    lengths: Tuple[int, ...]  # padded payload length per round
    col_block: int  # local domain-vector block (elements)
    row_block: int  # local codomain block (elements)
    width: int  # ELL width
    boundary_max: int = 0  # padded boundary-row count per rank
    boundary_total: int = 0  # true boundary rows summed over ranks

    @property
    def halo_elems(self) -> int:
        return int(sum(self.lengths))


def _plan_shard(ell_cols, ell_vals, valid, m, n, D):
    """Split the ELL planes into a **local** part (all columns on the rank:
    the interior compute) and a compressed **boundary** part (only rows
    with off-rank columns, addressing the packed halo buffer), and build the
    per-round send lists, with one global group-by over ``(rank, δ,
    column)``.

    Returns ``(local_cols (m,w) int32, local_vals (m,w), brows (D·B,) int32,
    bcols (D·B,w) int32, bvals (D·B,w), send_idx {δ: (D, L_δ) int32},
    plan)`` where ``B = plan.boundary_max``."""
    row_block = m // D
    col_block = n // D
    width = ell_cols.shape[1]

    d_all = np.broadcast_to(
        (np.arange(m, dtype=np.int64) // row_block)[:, None], ell_cols.shape
    )
    cols64 = ell_cols.astype(np.int64)
    src = cols64 // col_block
    remote = valid & (src != d_all)

    # ---- local plane: remote/padding slots → index 0, value 0 --------------
    local_mask = valid & ~remote
    local_cols = np.where(local_mask, cols64 - d_all * col_block, 0).astype(np.int32)
    local_vals = np.where(local_mask, ell_vals, 0)

    if not remote.any():
        plan = _HaloPlan((), (), col_block, row_block, width)
        empty_r = np.zeros((0,), np.int32)
        empty_c = np.zeros((0, width), np.int32)
        empty_v = np.zeros((0, width), ell_vals.dtype)
        return local_cols, local_vals, empty_r, empty_c, empty_v, {}, plan

    # ---- one global group-by over (dest rank d, ring distance δ, col) ------
    rd = d_all[remote]
    rc = cols64[remote]
    rdelta = (src[remote] - rd) % D
    key = (rd * D + rdelta) * np.int64(n) + rc
    ukey, inv = np.unique(key, return_inverse=True)
    u_d = ukey // (np.int64(n) * D)
    u_delta = (ukey // n) % D
    u_col = ukey % n

    gkey = u_d * D + u_delta  # contiguous groups within ukey
    gids, gstart = np.unique(gkey, return_index=True)
    gcount = np.diff(np.append(gstart, len(ukey)))
    g_delta = (gids % D).astype(np.int64)

    deltas = sorted({int(x) for x in g_delta})
    lengths = [int(gcount[g_delta == delta].max()) for delta in deltas]

    # halo-buffer offsets per δ (relative to the start of the halo buffer)
    off_by_delta = np.zeros(D, np.int64)
    off = 0
    for delta, L in zip(deltas, lengths):
        off_by_delta[delta] = off
        off += L

    # rank of each unique (d, δ, col) inside its group = its slot in round δ
    u_rank = np.arange(len(ukey), dtype=np.int64) - gstart[np.searchsorted(gids, gkey)]
    u_slot = off_by_delta[u_delta] + u_rank  # halo-buffer index

    # ---- boundary rows: compress rows that touch any remote column ---------
    halo_cols = np.zeros((m, width), np.int64)
    halo_cols[remote] = u_slot[inv]
    brow_mask = remote.any(axis=1)
    b_shard = (np.flatnonzero(brow_mask) // row_block).astype(np.int64)
    b_per_shard = np.bincount(b_shard, minlength=D)
    B = int(b_per_shard.max())
    brows = np.zeros((D, B), np.int32)
    bcols = np.zeros((D, B, width), np.int32)
    bvals = np.zeros((D, B, width), ell_vals.dtype)
    rows_g = np.flatnonzero(brow_mask)
    pos = np.concatenate([np.arange(c) for c in b_per_shard]) if len(rows_g) else []
    brows[b_shard, pos] = (rows_g - b_shard * row_block).astype(np.int32)
    bcols[b_shard, pos] = np.where(remote[rows_g], halo_cols[rows_g], 0).astype(np.int32)
    bvals[b_shard, pos] = np.where(remote[rows_g], ell_vals[rows_g], 0)

    # ---- send lists: in round δ, rank s=(d+δ)%D serves dest d's group ------
    send_idx = {}
    for delta, L in zip(deltas, lengths):
        tbl = np.zeros((D, L), np.int32)
        sel = u_delta == delta
        s_of = (u_d[sel] + delta) % D
        tbl[s_of, u_rank[sel]] = (u_col[sel] - s_of * col_block).astype(np.int32)
        send_idx[delta] = tbl

    plan = _HaloPlan(
        tuple(deltas), tuple(lengths), col_block, row_block, width,
        boundary_max=B, boundary_total=int(brow_mask.sum()),
    )
    return (
        local_cols,
        local_vals,
        brows.reshape(D * B),
        bcols.reshape(D * B, width),
        bvals.reshape(D * B, width),
        send_idx,
        plan,
    )


# ---------------------------------------------------------------------------
# device-side apply
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _ShardData:
    """This rank's planes of one direction, on its device."""

    cols: torch.Tensor  # (row_block, width) int32, local columns
    vals: torch.Tensor  # (row_block, width)
    brows: torch.Tensor  # (B,) int64 boundary rows
    bcols: torch.Tensor  # (B, width) int32, halo-buffer columns
    bvals: torch.Tensor  # (B, width)
    sends: Tuple[torch.Tensor, ...]  # per round: (L_δ,) local indices to send


def _shard_data(planned, index: int, D: int, device) -> Tuple[_ShardData, _HaloPlan]:
    lcols, lvals, brows, bcols, bvals, send_idx, plan = planned
    rb, B = plan.row_block, plan.boundary_max
    blk = slice(index * rb, (index + 1) * rb)
    bblk = slice(index * B, (index + 1) * B)

    def dev(a, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(device=device, dtype=dtype or t.dtype)

    data = _ShardData(
        dev(lcols[blk]), dev(lvals[blk]), dev(brows[bblk], torch.int64), dev(bcols[bblk]),
        dev(bvals[bblk]), tuple(dev(send_idx[d][index]) for d in plan.deltas),
    )
    return data, plan


def _pack(ax, plan: _HaloPlan, sends, v: torch.Tensor, transpose: bool) -> torch.Tensor:
    """The zero-filled ``(D, ..., halo_elems)`` buffer of one halo exchange
    of ``v``, a ``(..., n)`` stack of vectors (the leading axes those of a
    batched solve's problems): in round ``δ`` this rank's entries
    ``v[..., send]`` go to the slot of the rank ``δ`` before it.
    Transposed, ``v`` is a halo buffer's cotangent and round ``δ``'s part
    of it goes back to the rank ``δ`` after, which sent those entries."""
    D, i = ax.size, ax.index
    slots = torch.zeros((D,) + tuple(v.shape[:-1]) + (plan.halo_elems,), dtype=v.dtype,
                        device=v.device)
    off = 0
    for delta, L, send in zip(plan.deltas, plan.lengths, sends):
        if transpose:
            slots[(i + delta) % D, ..., off:off + L] = v[..., off:off + L]
        else:
            slots[(i - delta) % D, ..., off:off + L] = v[..., send]
        off += L
    return slots


def _exchange_start(ax, plan: _HaloPlan, sends, v: torch.Tensor, transpose: bool = False):
    """Start one halo exchange of ``v`` (:func:`_pack`) in one all-reduce."""
    return ax.psum_start(_pack(ax, plan, sends, v.detach(), transpose))


def _exchange_finish(ax, plan: _HaloPlan, sends, v: torch.Tensor, pending,
                     transpose: bool = False, n: int = 0) -> torch.Tensor:
    """Wait for the exchange of ``v`` and return what this rank receives,
    with its derivative attached (:class:`_Exchanged`): the halo buffer of
    each vector of the stack, or transposed, the cotangent of the ``(...,
    n)`` stack whose entries were sent (each round's part added at its sent
    indices)."""
    got = pending.wait()[ax.index]
    if transpose:
        xbar = torch.zeros(got.shape[:-1] + (n,), dtype=got.dtype, device=got.device)
        off = 0
        for L, send in zip(plan.lengths, sends):
            xbar.index_add_(-1, send, got[..., off:off + L])
            off += L
        got = xbar
    return _Exchanged.apply(v, got, ax, plan, sends, transpose)


class _Exchanged(torch.autograd.Function):
    """The received buffer ``got`` of a halo exchange of ``v``, passed
    through, with the exchange's derivative: its backward is the
    transposed exchange of the cotangent (each round's part sent back to
    the rank that sent the entries, in one all-reduce of the same layout;
    the transpose of the JAX package's ``ppermute`` rounds), itself
    differentiable, for a derived adjoint's graph."""

    @staticmethod
    def forward(v, got, ax, plan, sends, transpose):
        return got

    @staticmethod
    def setup_context(ctx, inputs, output):
        v, _, ctx.ax, ctx.plan, ctx.sends, ctx.transpose = inputs
        ctx.n = v.shape[-1]

    @staticmethod
    def backward(ctx, g):
        t = not ctx.transpose
        pending = _exchange_start(ctx.ax, ctx.plan, ctx.sends, g, t)
        return (_exchange_finish(ctx.ax, ctx.plan, ctx.sends, g, pending, t, ctx.n),
                None, None, None, None, None)


def _gather(x: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``y_i = Σ_j vals[i, j] x[cols[i, j]]``, the ELL product of one vector."""
    g = torch.index_select(x, 0, cols.reshape(-1)).reshape(cols.shape)
    return torch.sum(vals.to(g.dtype) * g, dim=1)


def _spmv(ax, plan: _HaloPlan, data: _ShardData, X: torch.Tensor, out_shape) -> torch.Tensor:
    """One direction's apply on each row of ``X``, a ``(p, ...)`` stack of
    this rank's blocks (the vectors of a batched solve's problems; ``p = 1``
    for one vector).  Every row's halo rounds are packed into one
    all-reduce, started first; the interior gathers do not wait on it, only
    the boundary rows do.  The gathers run row by row, so each row has the
    bits of its own apply."""
    Xf = X.reshape(X.shape[0], -1)
    if plan.deltas:
        pending = _exchange_start(ax, plan, data.sends, Xf)
    # interior pass: independent of every payload
    ys = [_gather(xf, data.cols, data.vals) for xf in Xf]
    if plan.deltas:
        halos = _exchange_finish(ax, plan, data.sends, Xf, pending)
        ys = [y.index_add(0, data.brows, _gather(halo, data.bcols, data.bvals))
              for y, halo in zip(ys, halos)]
    return torch.stack(ys).reshape((X.shape[0],) + tuple(out_shape))


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedELLOperator(TypedOperator):
    """Row-partitioned ELL sparse operator over a mesh axis: this rank's
    block of rows, applied to this rank's block of a vector (flat ``(n/D,)``
    or tile-aligned ``(n/(D·C), C)``; the partition is by contiguous element
    blocks either way).  It carries its scalar type (``dtype``) and its
    global ``shape``, so the solvers ask no probe apply.  ``plan_seconds``
    holds the host planning time of each direction.  A ``(p, ...)`` stack of
    blocks applies in one halo all-reduce (``normal_stack``,
    ``adjoint_stack``); a vector is a stack of one (:func:`_spmv`)."""

    mesh: Mesh = None
    axis: str = VECTOR_AXIS
    shape: Tuple[int, int] = ()
    tile: Optional[int] = None
    fwd_plan: _HaloPlan = None
    adj_plan: Optional[_HaloPlan] = None
    fwd: _ShardData = None
    adj: Optional[_ShardData] = None
    plan_seconds: dict = None

    def __init__(self, mesh, axis, shape, fwd, adj=None, tile: Optional[int] = None,
                 plan_seconds=None):
        (fdata, fplan) = fwd
        ax = mesh.axis(axis)
        m, n = shape
        D = ax.size
        cod = (m // D,) if tile is None else (m // D // tile, tile)
        dom = (n // D,) if tile is None else (n // D // tile, tile)
        for name, value in (("mesh", mesh), ("axis", axis), ("shape", tuple(shape)),
                            ("domain", dom),
                            ("tile", tile), ("fwd_plan", fplan), ("fwd", fdata),
                            ("adj_plan", adj[1] if adj is not None else None),
                            ("adj", adj[0] if adj is not None else None),
                            ("plan_seconds", dict(plan_seconds or {})),
                            ("dtype", fdata.vals.dtype)):
            object.__setattr__(self, name, value)
        object.__setattr__(self, "normal", lambda x: _spmv(ax, fplan, fdata, x[None], cod)[0])
        object.__setattr__(self, "normal_stack", lambda X: _spmv(ax, fplan, fdata, X, cod))
        if adj is not None:
            adata, aplan = adj
            object.__setattr__(self, "adjoint",
                               lambda y: _spmv(ax, aplan, adata, y[None], dom)[0])
            object.__setattr__(self, "adjoint_stack", lambda Y: _spmv(ax, aplan, adata, Y, dom))
        else:
            object.__setattr__(self, "adjoint", None)

    def comm_summary(self) -> str:
        """Static per-apply communication: halo rounds, payload sizes (one
        all-reduce moves ``D`` times them), and the interior/boundary row
        split (interior rows compute while the halos are in flight)."""
        D = self.mesh.shape[self.axis]

        def one(p: _HaloPlan) -> str:
            m_rows = p.row_block * D
            return (
                f"{len(p.deltas)} halo round(s) (δ={list(p.deltas)}) in "
                f"{1 if p.deltas else 0} all-reduce, {p.halo_elems} halo elems/apply; rows "
                f"{m_rows - p.boundary_total} interior / {p.boundary_total} "
                f"boundary (≤{p.boundary_max}/shard)"
            )

        s = "normal: " + one(self.fwd_plan)
        if self.adj_plan is not None:
            s += "; adjoint: " + one(self.adj_plan)
        return s


def sharded_ell_from_coo(
    rows,
    cols,
    vals,
    shape: Tuple[int, int],
    mesh: Mesh,
    *,
    axis: str = VECTOR_AXIS,
    tile: Optional[int] = None,
    with_adjoint: bool = True,
) -> ShardedELLOperator:
    """Plan and build a row-partitioned sparse operator from COO triplets
    (the whole matrix, the same on every rank).

    ``shape = (m, n)`` may be rectangular; ``m`` and ``n`` must be divisible
    by the mesh-axis size.  With ``tile=C`` vectors are ``(len/C, C)``
    blocks; ``C`` must divide the block sizes.  The planes go to
    ``mesh.device``."""
    m, n = shape
    ax = mesh.axis(axis)
    D = ax.size
    if m % D or n % D:
        raise ValueError(f"shape {shape} not divisible by mesh axis size {D}")
    if tile is not None and ((m // D) % tile or (n // D) % tile):
        raise ValueError(f"tile={tile} must divide the local blocks of {shape}")
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    vals = np.asarray(vals)
    seconds = {}

    def direction(r, c, v, mm, nn, name):
        t0 = time.perf_counter()
        ec, ev, valid = coo_to_ell(r, c, v, mm)
        ev = np.where(valid, ev, 0)
        planned = _plan_shard(ec, ev, valid, mm, nn, D)
        seconds[name] = time.perf_counter() - t0
        return _shard_data(planned, ax.index, D, mesh.device)

    fwd = direction(rows, cols, vals, m, n, "normal")
    adj = direction(cols, rows, np.conj(vals), n, m, "adjoint") if with_adjoint else None
    return ShardedELLOperator(mesh, axis, shape, fwd, adj, tile=tile, plan_seconds=seconds)


# ---------------------------------------------------------------------------
# synthetic matrix generators (the config-5 benchmark/test operators)
# ---------------------------------------------------------------------------


def banded_coo(n: int, halfband: int, dtype=np.float64, seed: int = 0, spd: bool = True):
    """Symmetric banded matrix as COO: random band entries, diagonally
    dominant when ``spd``.  nnz = n·(2·halfband+1) − O(halfband²)."""
    rng = np.random.default_rng(seed)
    rows_l, cols_l, vals_l = [], [], []
    for k in range(1, halfband + 1):
        v = rng.standard_normal(n - k).astype(dtype) * (0.5 / k)
        i = np.arange(n - k)
        rows_l += [i, i + k]
        cols_l += [i + k, i]
        vals_l += [v, v]
    off = np.concatenate(vals_l) if vals_l else np.zeros(0, dtype)
    rows = np.concatenate(rows_l) if rows_l else np.zeros(0, np.int64)
    cols = np.concatenate(cols_l) if cols_l else np.zeros(0, np.int64)
    diag = rng.standard_normal(n).astype(dtype)
    if spd:
        abssum = np.zeros(n, dtype)
        np.add.at(abssum, rows, np.abs(off))
        diag = abssum + 1.0 + 0.1 * np.abs(diag)
    rows = np.concatenate([rows, np.arange(n)])
    cols = np.concatenate([cols, np.arange(n)])
    vals = np.concatenate([off, diag])
    return rows, cols, vals


def rect_sparse_coo(m: int, n: int, nnz_per_row: int, dtype=np.float64, seed: int = 0):
    """Rectangular sparse matrix (term-document-like, BASELINE config 3/5
    LSMR operand): ``nnz_per_row`` random columns per row, random positive
    values, plus a band so every column is touched."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(m), nnz_per_row)
    cols = rng.integers(0, n, size=m * nnz_per_row)
    vals = rng.random(m * nnz_per_row).astype(dtype) + 0.1
    # deduplicate (r, c) pairs: keep first occurrence
    key = rows.astype(np.int64) * n + cols
    _, idx = np.unique(key, return_index=True)
    rows, cols, vals = rows[idx], cols[idx], vals[idx]
    # guarantee full column rank support: a diagonal-ish band
    i = np.arange(min(m, n))
    rows = np.concatenate([rows, i])
    cols = np.concatenate([cols, i])
    vals = np.concatenate([vals, np.full(len(i), 2.0, dtype)])
    key = rows.astype(np.int64) * n + cols
    _, idx = np.unique(key, return_index=True)
    return rows[idx], cols[idx], vals[idx]


def powerlaw_rect_coo(m: int, n: int, dtype=np.float64, seed: int = 0,
                      max_degree: int = 64):
    """Rectangular sparse matrix with power-law row degrees: row ``i`` has
    ``deg_i ~ Zipf``-distributed nnz at uniformly random columns, so ranks
    see skewed, scattered halo traffic (multi-round plans)."""
    rng = np.random.default_rng(seed)
    deg = np.minimum(rng.zipf(1.8, size=m), max_degree)
    rows = np.repeat(np.arange(m), deg)
    cols = rng.integers(0, n, size=int(deg.sum()))
    vals = rng.random(len(rows)).astype(dtype) + 0.1
    # dedup + full column support via a diagonal band
    i = np.arange(min(m, n))
    rows = np.concatenate([rows, i])
    cols = np.concatenate([cols, i])
    vals = np.concatenate([vals, np.full(len(i), 2.0, dtype)])
    key = rows.astype(np.int64) * n + cols
    _, idx = np.unique(key, return_index=True)
    return rows[idx], cols[idx], vals[idx]
