"""Block Lanczos factorization (counterpart of
``krylovkit_tpu/factorizations/blocklanczos.py``; reference
``src/factorizations/blocklanczos.jl``).

The block-tridiagonal factorization ``A V = V H + R B'``: each step applies
the operator to a block of ``b`` vectors and splits the result by a
rank-revealing block QR, so degenerate eigenvalues are resolved.  As in the
JAX package, the block size stays ``b``: a rank drop to ``r < b`` moves the
surviving directions to the front of the block (zero rows trail) and the
committed count ``k`` advances by ``r``, so ``V[:k]`` stays orthonormal and
the zero tail is overwritten by the next commit.

The basis ``V`` (capacity ``mcap + b``) holds committed vectors in
``[0, k)``; the current block ``X`` is a separate stacked vector (every
leaf ``(b,) + leaf.shape``); ``H`` is a dense ``(mcap + b)²`` buffer,
written in place.  ``k`` and ``r`` are host ints.  The block products are
plain matrix products per leaf (the JAX package leaves them to XLA), and
every reduction goes through the space (all-reduced on a sharded one); the
operator is applied to the block's rows one at a time, which runs a
kernel-backed operator's kernel once per row.

The batched counterparts (:func:`initialize_batched`,
:func:`block_qr_batched`, :func:`expand_batched`; what ``jax.vmap`` makes
of these functions) step ``P`` problems at once (tensor blocks), each at
its own ``k`` and ``r`` on its own basis: the current blocks of the
problems that step are applied as one stack of rows (one batched K3
launch on a kernel-backed banded operator), each orthogonalization pass is
one ``bs.gram_batched`` for every problem, and each column of the block
QRs is one ``bs.project_batched`` call per pass (one batched K5 launch with
the projection flag on) and one ``norm_batched``.  Each problem's local
products, block updates and compaction are those of the one-problem
functions, so each problem keeps its one-problem bits; on a sharded space
every reduction kind above is one all-reduce for all the problems.  The
ranks stay on the device for the caller to read with the ``β``s.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

import torch

from ..info import EACHITERATION, log_if
from ..ops import basis as bs
from ..ops.vector import (STANDARD, VectorSpace, device_of, norm_batched, scalartype, tree_leaves,
                          tree_map)

PyTree = Any

__all__ = ["BlockLanczosState", "block_qr", "initialize", "expand", "block_qr_batched",
           "initialize_batched", "expand_batched"]


@dataclass
class BlockLanczosState:
    V: PyTree  # committed basis, capacity mcap + b
    H: torch.Tensor  # (mcap + b, mcap + b) projected-matrix buffer
    X: PyTree  # current orthonormal block (b rows), compacted
    r: int  # current block rank (<= b)
    k: int  # committed count
    beta: torch.Tensor  # Frobenius norm of the last coupling block (0-d, real)


def _block_axpy(W: PyTree, V: PyTree, M: torch.Tensor) -> PyTree:
    """``W[i] − Σ_j M[j, i] V[j]`` for stacked blocks, one matrix product
    per leaf."""

    def leaf(lW, lV):
        n = lW[0].numel()
        dt = torch.promote_types(M.dtype, lV.dtype)
        upd = M.T.to(dt) @ lV.reshape(lV.shape[0], n).to(dt)
        return (lW.reshape(lW.shape[0], n) - upd).reshape(lW.shape)

    return tree_map(leaf, W, V)


class _QR:
    """The state of one block's rank-revealing QR: the rank tolerance, ``Q``
    (zeroed like the block), ``C`` and the accepted flags."""

    def __init__(self, X: PyTree, qr_tol, inner: torch.Tensor):
        """``inner``: the rows' squared norms, ``bs.batch_inner(X, X, space)``."""
        b = bs.capacity(X)
        cdt = scalartype(X)
        dev = device_of(X)
        norms0 = torch.sqrt(torch.clamp(torch.real(inner), min=0))
        self.tol = qr_tol * torch.clamp(torch.max(norms0), min=1e-30)
        self.Q = tree_map(torch.zeros_like, X)
        self.C = torch.zeros((b, b), dtype=cdt, device=dev)
        self.valid = torch.zeros(b, dtype=torch.bool, device=dev)

    def subtract(self, xi: PyTree, i: int, c: torch.Tensor) -> PyTree:
        """One Gram-Schmidt pass of column ``i`` given its projections ``c``
        on ``Q``: ``C[:, i] += c`` over the accepted rows, ``xi − Σ_j c_j Q[j]``."""
        c = c * self.valid.to(self.C.dtype.to_real())
        self.C[:, i] += c.to(self.C.dtype)
        return tree_map(lambda lx, lq: lx - torch.tensordot(c.to(lq.dtype), lq, dims=([0], [0])),
                        xi, self.Q)

    def accept(self, xi: PyTree, i: int, nrm: torch.Tensor):
        """Column ``i`` (of norm ``nrm``) normalised into ``Q[i]`` where its
        norm exceeds the tolerance, else zero."""
        ok = nrm > self.tol
        safe = torch.where(ok, nrm, torch.ones_like(nrm))
        bs.set(self.Q, i, tree_map(lambda l: torch.where(ok, l / safe.to(l.dtype), 0 * l), xi))
        self.C[i, i] = torch.where(ok, nrm.to(self.C.dtype),
                                   torch.zeros((), dtype=self.C.dtype, device=self.C.device))
        self.valid[i] = ok

    def compacted(self):
        """``(Q, C)`` with the accepted rows first, in their order."""
        order = torch.argsort((~self.valid).to(torch.int8), stable=True)
        return tree_map(lambda l: l[order], self.Q), self.C[order, :]


def block_qr(X: PyTree, qr_tol, space: VectorSpace = STANDARD
             ) -> Tuple[PyTree, torch.Tensor, int]:
    """Rank-revealing QR of a stacked block by two classical Gram-Schmidt
    passes per column with compaction (reference ``block_qr!``,
    ``src/factorizations/blocklanczos.jl:312-353``).

    Returns ``(Q, C, rank)`` with ``X[i] = Σ_j C[j, i] Q[j]``: the accepted
    rows of ``Q`` first in their order (zero rows trail), ``C``'s rows
    permuted alike.  A column is accepted where its remaining norm exceeds
    ``qr_tol`` times the largest input norm."""
    b = bs.capacity(X)
    qr = _QR(X, qr_tol, bs.batch_inner(X, X, space))
    for i in range(b):
        xi = bs.get(X, i)
        for _ in range(2):
            xi = qr.subtract(xi, i, bs.project(qr.Q, xi, b, space))
        qr.accept(xi, i, space.norm(xi))
    return (*qr.compacted(), int(qr.valid.sum()))


def block_qr_batched(Xs, qr_tol, space: VectorSpace = STANDARD):
    """:func:`block_qr` of each stacked block of ``Xs`` (``P`` tensors or
    trees of one structure and shape), column by column for all of them: the input norms are one
    ``bs.batch_inner_batched``, each of a column's two passes projects every
    block's column in one ``bs.project_batched`` call and its norms are one
    ``norm_batched``; the rest runs per block as :func:`block_qr` runs it.
    Returns ``(Qs, Cs, ranks)``, lists of ``P``; each rank a 0-d int64
    device tensor (not read here)."""
    b = bs.capacity(Xs[0])
    qrs = [_QR(X, qr_tol, ip) for X, ip in zip(Xs, bs.batch_inner_batched(Xs, Xs, space))]
    for i in range(b):
        xs = [bs.get(X, i) for X in Xs]
        for _ in range(2):
            cs = bs.project_batched([qr.Q for qr in qrs], xs, [b] * len(Xs), space)
            xs = [qr.subtract(x, i, c) for qr, x, c in zip(qrs, xs, cs)]
        for qr, x, nrm in zip(qrs, xs, norm_batched(xs, space)):
            qr.accept(x, i, nrm)
    out = [qr.compacted() for qr in qrs]
    return [q for q, _ in out], [c for _, c in out], [qr.valid.sum() for qr in qrs]


def initialize(X0: PyTree, mcap: int, coeff_dtype, qr_tol,
               space: VectorSpace = STANDARD) -> BlockLanczosState:
    """Orthonormalize the starting block (reference ``initialize``,
    ``src/factorizations/blocklanczos.jl:159-198``)."""
    b = bs.capacity(X0)
    dev = device_of(X0)
    Q, _, r = block_qr(X0, qr_tol, space)
    V = bs.alloc(bs.get(Q, 0), mcap + b)
    H = torch.zeros((mcap + b, mcap + b), dtype=coeff_dtype, device=dev)
    beta = torch.ones((), dtype=coeff_dtype.to_real(), device=dev)
    return BlockLanczosState(V=V, H=H, X=Q, r=r, k=0, beta=beta)


def initialize_batched(X0s, mcap: int, coeff_dtype, qr_tol, space: VectorSpace = STANDARD):
    """:func:`initialize` of each start block of ``X0s`` (``P`` tensors or
    trees of one structure and shape), the block QRs through :func:`block_qr_batched`.  Returns
    the list of states, each with its own zeroed basis and its rank as a
    0-d device tensor."""
    b = bs.capacity(X0s[0])
    dev = device_of(X0s[0])
    Qs, _, ranks = block_qr_batched(X0s, qr_tol, space)
    return [BlockLanczosState(
        V=bs.alloc(bs.get(Q, 0), mcap + b),
        H=torch.zeros((mcap + b, mcap + b), dtype=coeff_dtype, device=dev), X=Q, r=r,
        k=0, beta=torch.ones((), dtype=coeff_dtype.to_real(), device=dev))
        for Q, r in zip(Qs, ranks)]


def _commit(state: BlockLanczosState, b: int):
    """Write the current block at rows ``[k, k + b)`` of the basis (the
    drivers keep ``k + r <= mcap``; the JAX package's dynamic slices would
    clamp an out-of-range start, so none is taken)."""
    k, mcapb = state.k, state.H.shape[0]
    if not (0 <= k and k + state.r + b <= mcapb):
        raise ValueError(f"block step at k={k}, r={state.r} overruns the {mcapb}-row buffer")
    for lV, lX in zip(tree_leaves(state.V), tree_leaves(state.X)):
        lV[k:k + b] = lX.to(lV.dtype)


def _orthogonalize(state: BlockLanczosState, W: PyTree, b: int, space: VectorSpace) -> PyTree:
    """The images ``W`` orthogonalized against the committed basis ``V[:k +
    r]`` in two passes; their coefficients fill columns ``[k, k + b)`` of
    ``H`` and its Hermitian mirror rows."""
    V, H, k, kr = state.V, state.H, state.k, state.k + state.r
    M = torch.zeros((H.shape[0], b), dtype=H.dtype, device=H.device)
    rows = torch.arange(H.shape[0], device=H.device)[:, None]
    for _ in range(2):
        Mi = bs.gram(V, W, space)
        Mi = torch.where(rows < kr, Mi, torch.zeros((), dtype=Mi.dtype, device=Mi.device))
        W = _block_axpy(W, V, Mi)
        M = M + Mi.to(H.dtype)
    H[:, k:k + b] = M
    H[k:k + b, :] = M.conj().T
    return W


def _orthogonalize_batched(states, Ws, b: int, space: VectorSpace) -> list:
    """:func:`_orthogonalize` of each problem's images ``Ws[i]`` against its
    basis, each pass one ``bs.gram_batched`` for all of them, each
    problem's slab ``bs.gram``'s local product."""
    Ms = [torch.zeros((st.H.shape[0], b), dtype=st.H.dtype, device=st.H.device) for st in states]
    rows = torch.arange(states[0].H.shape[0], device=states[0].H.device)[:, None]
    for _ in range(2):
        Mis = bs.gram_batched([st.V for st in states], Ws, space)
        for i, (st, Mi) in enumerate(zip(states, Mis)):
            Mi = torch.where(rows < st.k + st.r, Mi,
                             torch.zeros((), dtype=Mi.dtype, device=Mi.device))
            Ws[i] = _block_axpy(Ws[i], st.V, Mi)
            Ms[i] = Ms[i] + Mi.to(st.H.dtype)
    for st, M in zip(states, Ms):
        st.H[:, st.k:st.k + b] = M
        st.H[st.k:st.k + b, :] = M.conj().T
    return Ws


def _advanced(state: BlockLanczosState, Q: PyTree, C: torch.Tensor, rnew, b: int,
              verbosity: int) -> BlockLanczosState:
    """The state after a block step: the coupling ``C`` at rows ``[k + r,
    k + r + b)`` of ``H`` and its mirror, ``Q`` the next block, ``β = ‖C‖``."""
    H, k, kr = state.H, state.k, state.k + state.r
    H[kr:kr + b, k:k + b] = C.to(H.dtype)
    H[k:k + b, kr:kr + b] = C.conj().T.to(H.dtype)
    beta = torch.sqrt(torch.clamp(torch.sum(torch.abs(C) ** 2), min=0)).to(state.beta.dtype)
    log_if(
        verbosity, EACHITERATION + 1,
        "BlockLanczos expansion to dimension {k}: subspace normres = {b}",
        k=kr, b=beta,
    )
    return BlockLanczosState(V=state.V, H=H, X=Q, r=rnew, k=kr, beta=beta)


def expand(op_apply, state: BlockLanczosState, qr_tol, space: VectorSpace = STANDARD,
           verbosity: int = 0) -> BlockLanczosState:
    """One block step, in place on ``state.V`` and ``state.H``: commit ``X``
    at rows ``[k, k + b)``, apply the operator to each row of ``X``,
    orthogonalize the images against the committed basis (two passes), and
    split them by :func:`block_qr` into the next block and its coupling.
    Reference ``block_lanczosrecurrence``
    (``src/factorizations/blocklanczos.jl:242-263``)."""
    b = bs.capacity(state.X)
    _commit(state, b)
    images = [op_apply(bs.get(state.X, j)) for j in range(b)]
    W = _orthogonalize(state, tree_map(lambda *ls: torch.stack(ls), *images), b, space)
    Q, C, rnew = block_qr(W, qr_tol, space)
    return _advanced(state, Q, C, rnew, b, verbosity)


def expand_batched(apply_stack, states: dict, qr_tol, space: VectorSpace = STANDARD,
                   verbosity: int = 0) -> dict:
    """:func:`expand` for each problem of ``states`` (``{p: state}``, host
    ``k`` and ``r``), in place on their bases and ``H``: the current blocks
    go through ``apply_stack(X, rows)`` as one ``(P_s·b, ...)`` stack, row
    ``i·b + j`` row ``j`` of the ``i``-th problem's block and ``rows`` each
    problem's index ``b`` times; each projection pass is one batched Gram
    (:func:`_orthogonalize_batched`) and the block QRs run through
    :func:`block_qr_batched`.  Returns ``{p: state}`` with each new rank a
    0-d device tensor (the caller reads it with ``β``)."""
    ps = list(states)
    b = bs.capacity(states[ps[0]].X)
    for p in ps:
        _commit(states[p], b)
    Y = apply_stack(tree_map(lambda *ls: torch.cat(ls), *[states[p].X for p in ps]),
                    [p for p in ps for _ in range(b)])
    Ws = _orthogonalize_batched([states[p] for p in ps],
                                [tree_map(lambda l: l[i * b:(i + 1) * b], Y)
                                 for i in range(len(ps))], b, space)
    Qs, Cs, ranks = block_qr_batched(Ws, qr_tol, space)
    return {p: _advanced(states[p], Q, C, r, b, verbosity)
            for p, Q, C, r in zip(ps, Qs, Cs, ranks)}
