"""Block Lanczos eigsolve driver for Hermitian problems with degenerate
eigenvalues (counterpart of ``krylovkit_tpu/solvers/blocklanczos.py``;
reference ``src/eigsolve/blocklanczos.jl``).

Block expansion to ``krylovdim`` (one apply per row of the block each
step), the dense eigendecomposition of the projected buffer
(``dense.eigh_active``), residual norms from the coupling rows of the
residual block (``:50-53``), and a thick restart that rotates the basis and
the coupling rows into the arrowhead form of the Lanczos driver (``:71-104``),
as host loops over device tensors.  The control flow reads the block rank
and ``β`` per step and ``nconv`` per round.  The block may be a stacked
pytree (``ops/block.py``), and on a sharded space (``psum_axis``) every
reduction is all-reduced, so the projected matrix is the same on every rank.
The dense round, the restart and the extraction are module functions
(``_round``, ``_restart``, ``_extract``) that the batched driver
(``batched_blocklanczos.py``) calls too.
"""

from __future__ import annotations

import torch

from .. import dense
from ..algorithms import BlockLanczos
from ..factorizations import blocklanczos as bf
from ..info import STARTSTOP, ConvergenceInfo, log_if, warn_if
from ..ops import basis as bs
from ..ops.operator import LinearOperator, probe_dtype
from ..ops.vector import STANDARD, VectorSpace, astype, rounded, tree_map

__all__ = ["eigsolve_blocklanczos"]


def _spike(H: torch.Tensor, k: int, b: int) -> torch.Tensor:
    """Coupling rows ``S = H[k:k+b, :]`` (block residual couplings)."""
    if k + b > H.shape[0]:
        raise ValueError(f"coupling rows [{k}, {k + b}) overrun the {H.shape[0]}-row buffer")
    return H[k:k + b, :]


def _eps_pow(rdt: torch.dtype) -> float:
    """``eps(rdt)^(3/4)`` computed in ``rdt``."""
    return float(torch.tensor(torch.finfo(rdt).eps, dtype=rdt) ** 0.75)


def _round(fact: bf.BlockLanczosState, b: int, which, tol):
    """The dense work of a round: the eigendecomposition of the projected
    buffer over ``[0, k)``, sorted by ``which``, the coupling rows ``S U``,
    the residual norms and ``nconv``.  Returns ``(w, U, SU, res, nconv)``."""
    K = fact.k
    w, U, valid = dense.eigh_active((fact.H + fact.H.conj().T) / 2, K)
    perm = dense.sort_perm(w, valid, which)
    w, U, valid = w[perm], U[:, perm], valid[perm]
    SU = _spike(fact.H, K, b) @ U
    res = torch.sqrt(torch.sum(torch.abs(SU) ** 2, dim=0))
    res = torch.where(valid, res, torch.full_like(res, float("inf")))
    nconv = int(torch.sum(torch.cumprod((res <= tol).to(torch.int64), 0)))
    return w, U, SU, res, nconv


def _restart(fact: bf.BlockLanczosState, w, U, SU, nconv: int, m: int,
             b: int) -> bf.BlockLanczosState:
    """Thick restart: keep the leading Ritz vectors, arrowhead ``H`` with
    the rotated coupling rows at ``[keep, keep + b)``.  The basis is
    rotated into a new tensor (``bs.transform``)."""
    H = fact.H
    idx = torch.arange(H.shape[0], device=H.device)
    zero = torch.zeros((), dtype=H.dtype, device=H.device)
    keep = min(max((3 * m + 2 * nconv) // 5, 1), max(fact.k - 1, 1))
    Ukeep = torch.where((idx[:, None] < fact.k) & (idx[None, :] < keep), U, zero)
    Vnew = bs.transform(fact.V, Ukeep)
    Hnew = torch.diag(torch.where(idx < keep, w.to(H.dtype), zero))
    Snew = torch.where(idx[None, :] < keep, SU.to(H.dtype), zero)
    Hnew[keep:keep + b, :] = Snew
    Hnew[:, keep:keep + b] = Snew.conj().T
    return bf.BlockLanczosState(V=Vnew, H=Hnew, X=fact.X, r=fact.r, k=keep, beta=fact.beta)


def _extract(fact: bf.BlockLanczosState, w, U, res, nconv_out: int, numiter_out: int,
             numops: int, howmany: int, b: int):
    """``(vals, vecs, info)`` of a finished solve: the Ritz vectors and the
    residual vectors ``r_i = Σ_j X[j]·(S U)[j, i]``."""
    idx = torch.arange(fact.H.shape[0], device=fact.H.device)
    zero = torch.zeros((), dtype=fact.H.dtype, device=fact.H.device)
    k = fact.k
    Umask = torch.where((idx[:, None] < k) & (idx[None, :] < howmany), U, zero)
    vecs = bs.prefix(bs.transform(fact.V, Umask), howmany)
    SU = (_spike(fact.H, k, b) @ U)[:, :howmany]
    residuals = tree_map(lambda lX: torch.tensordot(SU.T.to(lX.dtype), lX, dims=([1], [0])),
                         fact.X)
    info = ConvergenceInfo(
        converged=nconv_out,
        residual=residuals,
        normres=res[:howmany],
        numiter=numiter_out,
        numops=numops,
    )
    return w[:howmany], vecs, info


def eigsolve_blocklanczos(op: LinearOperator, X0, howmany: int, which,
                          alg: BlockLanczos, space: VectorSpace = STANDARD):
    """Hermitian eigsolve from the stacked start block ``X0`` (every leaf's
    leading axis the block size), on ``X0``'s device.  Returns ``(vals,
    vecs, info)`` as the Lanczos driver does."""
    b = bs.capacity(X0)
    m = alg.krylovdim
    if howmany > m:
        raise ValueError(f"howmany={howmany} exceeds krylovdim={m}")
    cdt = probe_dtype(op, bs.get(X0, 0))
    rdt = cdt.to_real()
    tol = rounded(alg.tol, rdt)
    qr_tol = rounded(alg.qr_tol, rdt) if alg.qr_tol >= 0 else _eps_pow(rdt)
    btol = _eps_pow(rdt)

    fact = bf.initialize(astype(X0, cdt), m, cdt, qr_tol, space)
    numiter = numops = 0

    def expand_one(fact, numops):
        # one block step applies the operator to every row of the block
        return bf.expand(op.normal, fact, qr_tol, space, alg.verbosity), numops + b

    done = False
    while not done:
        if fact.k + fact.r <= m and fact.r > 0:
            fact, numops = expand_one(fact, numops)
        # ¬(β > btol): a NaN β counts as breakdown
        while (fact.k + fact.r <= m and fact.r > 0 and float(fact.beta) > btol
               and not (alg.eager and fact.k >= max(howmany, 1))):
            fact, numops = expand_one(fact, numops)

        w, U, SU, res, nconv = _round(fact, b, which, tol)
        full = fact.k + fact.r > m
        numiter += int(full)
        exhausted = fact.r <= 0 or not (float(fact.beta) > btol)
        done = nconv >= howmany or (full and numiter >= alg.maxiter) or exhausted
        if not done and full:
            fact = _restart(fact, w, U, SU, nconv, m, b)

    nconv_out = min(nconv, howmany)
    log_if(
        alg.verbosity, STARTSTOP,
        "BlockLanczos eigsolve finished after {it} iterations: {nc} values "
        "converged, normres = {nr}",
        it=numiter, nc=nconv_out, nr=res[:howmany],
    )
    warn_if(
        alg.verbosity, nconv_out < howmany,
        "BlockLanczos eigsolve stopped without convergence: {nc} of "
        f"{howmany}" + " values converged after {it} iterations",
        nc=nconv_out, it=numiter,
    )
    return _extract(fact, w, U, res, nconv_out, max(numiter, 1), numops, howmany, b)
