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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

import torch

from ..info import EACHITERATION, log_if
from ..ops import basis as bs
from ..ops.vector import STANDARD, VectorSpace, device_of, scalartype, tree_leaves, tree_map

PyTree = Any

__all__ = ["BlockLanczosState", "block_qr", "initialize", "expand"]


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
    cdt = scalartype(X)
    rdt = cdt.to_real()
    dev = device_of(X)
    norms0 = torch.sqrt(torch.clamp(torch.real(bs.batch_inner(X, X, space)), min=0))
    tol = qr_tol * torch.clamp(torch.max(norms0), min=1e-30)

    Q = tree_map(torch.zeros_like, X)
    C = torch.zeros((b, b), dtype=cdt, device=dev)
    valid = torch.zeros(b, dtype=torch.bool, device=dev)
    for i in range(b):
        xi = bs.get(X, i)
        for _ in range(2):
            c = bs.project(Q, xi, b, space) * valid.to(rdt)
            C[:, i] += c.to(cdt)
            xi = tree_map(lambda lx, lq: lx - torch.tensordot(c.to(lq.dtype), lq, dims=([0], [0])),
                          xi, Q)
        nrm = space.norm(xi)
        ok = nrm > tol
        safe = torch.where(ok, nrm, torch.ones_like(nrm))
        xi = tree_map(lambda l: torch.where(ok, l / safe.to(l.dtype), 0 * l), xi)
        bs.set(Q, i, xi)
        C[i, i] = torch.where(ok, nrm.to(cdt), torch.zeros((), dtype=cdt, device=dev))
        valid[i] = ok
    # accepted rows first, in their order
    order = torch.argsort((~valid).to(torch.int8), stable=True)
    return tree_map(lambda l: l[order], Q), C[order, :], int(valid.sum())


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


def expand(op_apply, state: BlockLanczosState, qr_tol, space: VectorSpace = STANDARD,
           verbosity: int = 0) -> BlockLanczosState:
    """One block step, in place on ``state.V`` and ``state.H``: commit ``X``
    at rows ``[k, k + b)``, apply the operator to each row of ``X``,
    orthogonalize the images against the committed basis (two passes), and
    split them by :func:`block_qr` into the next block and its coupling.
    Reference ``block_lanczosrecurrence``
    (``src/factorizations/blocklanczos.jl:242-263``)."""
    V, H, X, r, k = state.V, state.H, state.X, state.r, state.k
    b = bs.capacity(X)
    mcapb = H.shape[0]
    kr = k + r
    # the JAX package's dynamic slices clamp an out-of-range start; the
    # drivers keep k + r <= mcap, so no slice here ever needs it
    if not (0 <= k and kr + b <= mcapb):
        raise ValueError(f"block step at k={k}, r={r} overruns the {mcapb}-row buffer")
    for lV, lX in zip(tree_leaves(V), tree_leaves(X)):
        lV[k:k + b] = lX.to(lV.dtype)
    images = [op_apply(bs.get(X, j)) for j in range(b)]
    W = tree_map(lambda *ls: torch.stack(ls), *images)

    M = torch.zeros((mcapb, b), dtype=H.dtype, device=H.device)
    rows = torch.arange(mcapb, device=H.device)[:, None]
    for _ in range(2):
        Mi = bs.gram(V, W, space)
        Mi = torch.where(rows < kr, Mi, torch.zeros((), dtype=Mi.dtype, device=Mi.device))
        W = _block_axpy(W, V, Mi)
        M = M + Mi.to(H.dtype)
    # coefficient columns [k, k + b) and their Hermitian mirror rows
    H[:, k:k + b] = M
    H[k:k + b, :] = M.conj().T

    Q, C, rnew = block_qr(W, qr_tol, space)
    # coupling rows H[kr + j, k + i] = C[j, i] and their mirror
    H[kr:kr + b, k:k + b] = C.to(H.dtype)
    H[k:k + b, kr:kr + b] = C.conj().T.to(H.dtype)
    beta = torch.sqrt(torch.clamp(torch.sum(torch.abs(C) ** 2), min=0)).to(state.beta.dtype)
    log_if(
        verbosity, EACHITERATION + 1,
        "BlockLanczos expansion to dimension {k}: subspace normres = {b}",
        k=kr, b=beta,
    )
    return BlockLanczosState(V=V, H=H, X=Q, r=rnew, k=kr, beta=beta)
