"""Two-sided eigensolver: BiArnoldi with a dual Krylov-Schur restart
(counterpart of ``krylovkit_tpu/solvers/biarnoldi.py``).

The reference ``bieigsolve``/``_bischursolve`` (``src/eigsolve/biarnoldi.jl``):
a pair of Arnoldi factorizations for ``A`` (right) and ``Aᴴ`` (left)
expanded in lock-step, with

* the oblique-projection correction of the Rayleigh quotients and residuals
  through ``M = WᴴV`` (two dense solves, reference ``:282-302``);
* dual Schur decompositions, the left side sorted by ``conj ∘ which``
  (``:305-315``);
* convergence on the max of the two Schur residuals (``:326-340``);
* a dual thick restart with the ``M ← ZᴴMQ`` update (``:361-445``), kept in
  Krylov-Schur form (triangular block + spike row) as in the JAX package;
* left eigenvectors from right ones through the ``ZᴴMQ`` relation
  (``:156-170``), which makes the returned pairs biorthogonal.

Real inputs keep both bases and both projected problems real (real Schur
forms with 2×2 blocks, never split by the convergence count or the restart
size); complex eigenvalues and eigenvectors appear only in the extraction.
Complex inputs use complex Schur forms.  The loops run on the host over
device tensors, like the Arnoldi driver (``solvers/arnoldi.py``): ``k``,
``keep``, ``nconv`` and the counters are host ``int``s, and each test of
the expansion loop reads both residual norms in one scalar read.  The
restart's basis rotation is the full ``bs.transform`` (a plain product), as
in the JAX package.  Returns ``(values, (vecsV, vecsW), (infoV, infoW))``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import dense
from ..ad._common import refuse_grad
from ..algorithms import BiArnoldi
from ..factorizations import krylov as kf
from ..info import STARTSTOP, ConvergenceInfo, log_if, warn_if
from ..ops import basis as bs
from ..ops.operator import as_operator, probe_dtype, resolve_device
from ..ops.vector import STANDARD, VectorSpace, add, device_of, rounded, scale, tree_map
from .arnoldi import _leading_rows

__all__ = ["bieigsolve"]


def _update_M(M, V, W, j: int, space: VectorSpace):
    """Fill row and column ``j`` of ``M = WᴴV`` for the newly added basis
    vectors (two projections on ``j + 1`` rows)."""
    colj = bs.project(W, bs.get(V, j), j + 1, space)  # ⟨W_i, v_j⟩, i <= j
    rowj = torch.conj(bs.project(V, bs.get(W, j), j + 1, space))  # ⟨w_j, v_i⟩
    M[:, j] = colj.to(M.dtype)
    M[j, :] = rowj.to(M.dtype)
    return M


def _zero_outside(A, mask):
    return torch.where(mask, A, torch.zeros((), dtype=A.dtype, device=A.device))


@dataclasses.dataclass
class _LoopState:
    """One problem's loop state: its two factorizations, ``M = WᴴV``, the
    counts and, after a round, the round's Schur data for the extraction."""

    fV: kf.KrylovState
    fW: kf.KrylovState
    M: torch.Tensor
    numiter: int = 0
    numops: int = 0
    nconv: int = 0
    rnd: tuple = ()


def _round(st: _LoopState, Whv, Vhw, howmany: int, which, alg: BiArnoldi, space: VectorSpace,
           cdt, real: bool, tol: float, btol: float):
    """One processing round after the expansion, given the oblique
    correction's two projections ``Whv = Wᴴv`` and ``Vhw = Vᴴw``: sets
    ``st.rnd``, ``st.nconv`` and ``st.numiter``.  Returns ``(done,
    restart)``: ``restart`` is ``None``, or ``(keep, Vn, Wn, Hn, Kn, Mn)``
    with ``M``'s residual slot still to fill."""
    fV, fW, M = st.fV, st.fW, st.M
    m = alg.krylovdim
    m1 = m + 1
    rdt = cdt.to_real()
    dev = M.device
    idx = torch.arange(m1, device=dev)
    rows, cols = idx[:, None], idx[None, :]
    L = fV.k
    bv, bw = fV.beta.to(cdt), fW.beta.to(cdt)
    rV0, rW0 = bs.get(fV.V, L), bs.get(fW.V, L)  # normalized residual directions

    # oblique correction through M = WᴴV (reference :282-302)
    Meff = dense.embed_active(M, L, 1.0)
    x = torch.linalg.solve(Meff, Whv.to(cdt))  # M⁻¹ Wᴴv
    y = torch.linalg.solve(Meff.conj().T, Vhw.to(cdt))  # M⁻ᴴ Vᴴw
    eL = (idx == max(L - 1, 0)).to(cdt)
    Ht = fV.H + bv * x[:, None] * eL[None, :]
    Kt = fW.H + bw * y[:, None] * eL[None, :]
    rV = add(rV0, bs.unproject(fV.V, x), a=-1)
    rW = add(rW0, bs.unproject(fW.V, y), a=-1)
    brV, brW = space.norm(rV), space.norm(rW)

    # dual Schur + sort (left side by conj ∘ which; for real string
    # targets conj ∘ which == which, the spectrum being conj-symmetric)
    valid = idx < L
    if real:
        S, Q, _ = dense.real_schur_active(Ht, L)
        T, Z, _ = dense.real_schur_active(Kt, L)
        S, Q = dense.sort_schur_real(S, Q, which, L)
        T, Z = dense.sort_schur_real(T, Z, which, L)
    else:
        S, Q, _ = dense.schur_active(Ht, L)
        T, Z, _ = dense.schur_active(Kt, L)
        inf = torch.tensor(float("inf"), dtype=rdt, device=dev)
        keyS = torch.where(valid, dense.which_key(torch.diagonal(S), which), inf)
        keyT = torch.where(valid, dense.which_key(torch.conj(torch.diagonal(T)), which), inf)
        S, Q, _ = dense.sort_schur(S, Q, keyS)
        T, Z, _ = dense.sort_schur(T, Z, keyT)

    h = torch.conj(Q[max(L - 1, 0)]) * bv
    kv = torch.conj(Z[max(L - 1, 0)]) * bw
    res = torch.maximum(brV * torch.abs(h), brW * torch.abs(kv))
    res = torch.where(valid, res, torch.full_like(res, float("inf")))
    nconv = int(torch.sum(torch.cumprod((res <= tol).to(torch.int64), 0)))
    if real:
        # never count or keep half a 2×2 block (either side)
        startsS = dense.block_starts(S, L).tolist()
        startsT = dense.block_starts(T, L).tolist()
        second = [False] + [a or b for a, b in zip(startsS[:-1], startsT[:-1])]
        if 0 < nconv < L and second[min(nconv, m1 - 1)]:
            nconv -= 1

    full = L >= m
    st.numiter += int(full)
    st.nconv = nconv
    st.rnd = (S, T, Q, Z, h, kv, rV, rW, brV, brW)
    # ¬(β > btol): a NaN β must count as breakdown
    stalled = not bool((fV.beta > btol) & (fW.beta > btol)) and L < m
    done = nconv >= howmany or (full and st.numiter >= alg.maxiter) or stalled

    keep = min(max((3 * m + 2 * nconv) // 5, 1), max(L - 1, 1))
    if real:
        # decrement-only block-boundary adjustment, alternating sides
        def dec(keep, starts):
            return keep - int(starts[min(max(keep - 1, 0), m1 - 1)] and 1 < keep < L)

        for _ in range(3):
            keep = dec(dec(keep, startsS), startsT)
        keep = max(keep, 1)

    if done or not full:
        return done, None
    # dual Krylov-Schur restart (reference :361-445)
    kmask = (rows < L) & (cols < keep)
    Qk, Zk = _zero_outside(Q, kmask), _zero_outside(Z, kmask)
    # Ĥ = S_kk + VQᴴv·h̃ᴴ with VQᴴv = −Qₖᴴ x (reference :399-404)
    vqv = -(Qk.conj().T @ x)
    wzw = -(Zk.conj().T @ y)
    keepblk = (rows < keep) & (cols < keep)
    hk = _zero_outside(h, idx < keep)
    kk = _zero_outside(kv, idx < keep)
    Hn = _zero_outside(S + vqv[:, None] * torch.conj(hk)[None, :], keepblk)
    Kn = _zero_outside(T + wzw[:, None] * torch.conj(kk)[None, :], keepblk)
    # corrected residuals (reference :406-418)
    rV2 = add(rV, bs.unproject(fV.V, Qk @ vqv), a=-1)
    rW2 = add(rW, bs.unproject(fW.V, Zk @ wzw), a=-1)
    b2v, b2w = space.norm(rV2), space.norm(rW2)
    sv = torch.where(b2v > 0, b2v, torch.ones_like(b2v))
    sw = torch.where(b2w > 0, b2w, torch.ones_like(b2w))
    # spike rows: coupling of the normalized residual, row h̃ᴴ
    Hn[keep, :] += torch.conj(hk) * b2v.to(cdt)
    Kn[keep, :] += torch.conj(kk) * b2w.to(cdt)
    Vn = bs.set(bs.transform(fV.V, Qk), keep, scale(rV2, (1 / sv).to(cdt)))
    Wn = bs.set(bs.transform(fW.V, Zk), keep, scale(rW2, (1 / sw).to(cdt)))
    # M ← ZᴴMQ on the keep block; the residual slot's entries follow
    Mn = _zero_outside(Zk.conj().T @ (M @ Qk), keepblk)
    return done, (keep, Vn, Wn, Hn, Kn, Mn)


def _extract(st: _LoopState, howmany: int, cdt, real: bool):
    """``(vals, vecsV, vecsW, infoV, infoW)`` from the final loop state
    (reference bieigsolve body, :151-200); in real mode the only place
    complex values appear."""
    S, T, Q, Z, h, kv, rV, rW, brV, brW = st.rnd
    fV, fW, M = st.fV, st.fW, st.M
    hm = howmany
    L = fV.k
    m1 = M.shape[0]
    rdt = cdt.to_real()
    dev = M.device
    idx = torch.arange(m1, device=dev)
    rows, cols = idx[:, None], idx[None, :]
    ccdt = torch.promote_types(cdt, torch.complex64)
    if real:
        re_, im_ = dense.real_schur_eigvals(S, L)
        vals = torch.complex(re_, im_).to(ccdt)[:hm]
        Xre, Xim = dense.triangular_eigvecs_real(S, L)
        XS = torch.complex(Xre, Xim).to(ccdt)[:, :hm]
    else:
        vals = torch.diagonal(S)[:hm]
        XS = dense.triangular_eigvecs(S, L)[:, :hm]  # eigenvectors of S, (m1, hm)
    Qc, Zc, Mc = Q.to(ccdt), Z.to(ccdt), M.to(ccdt)
    live = rows[:, :hm] < L
    if real:
        # per-column left eigenvectors: T's eigenvector for conj(λ_j),
        # biorthonormalized column by column through ZᴴMQ.  (The reference's
        # inv((ZᴴMQ·XS)ᴴ) assumes the leading hm Schur columns span an
        # invariant subspace, which fails for a quasi-triangular T when a 2×2
        # block straddles hm; the per-column form needs each column only.)
        TXre, TXim = dense.triangular_eigvecs_real(T, L)
        Yt = torch.complex(TXre, -TXim).to(ccdt)  # conj: pair-member flip
        amask = (rows < L) & (cols < L)
        ZMQf = _zero_outside(Zc, amask).conj().T @ (Mc @ _zero_outside(Qc, amask))
        XSf = torch.zeros((m1, m1), dtype=ccdt, device=dev)
        XSf[:, :hm] = XS
        g = torch.einsum("ij,ij->j", Yt.conj(), ZMQf @ XSf)[:hm]
        tiny = torch.finfo(rdt).tiny
        sc = torch.conj(g) / torch.clamp(torch.abs(g) ** 2, min=tiny)  # y_j ← y_j·conj(1/g_j)ᴴ
        XTcols = Yt[:, :hm] * torch.conj(sc)[None, :]
    else:
        lmask = (rows < L) & (cols < hm)
        ZMQ = (_zero_outside(Zc, lmask).conj().T @ (Mc @ _zero_outside(Qc, lmask)))[:hm, :hm]
        XT = torch.linalg.inv((ZMQ @ XS[:hm, :hm]).conj().T)  # (hm, hm)
        XTcols = torch.zeros((m1, hm), dtype=ccdt, device=dev)
        XTcols[:hm, :hm] = XT

    def transform_cplx(V, C):
        """The leading ``hm`` rows of ``V`` (real in real mode) × the complex
        coefficients ``C``."""
        if real:
            Vr = _leading_rows(V, torch.real(C), hm)
            Vi = _leading_rows(V, torch.imag(C), hm)
            return tree_map(lambda a, b: torch.complex(a, b).to(ccdt), Vr, Vi)
        return _leading_rows(V, C, hm)

    # right eigenvectors: V · (Q · XS); left: W · (Z · XT)
    outmask = (rows < L) & (cols < hm)
    QXS = torch.zeros((m1, m1), dtype=ccdt, device=dev)
    QXS[:, :hm] = Qc @ _zero_outside(XS, live)
    vecsV = transform_cplx(fV.V, _zero_outside(QXS, outmask))
    XTcols = _zero_outside(XTcols, live)
    XTfull = torch.zeros((m1, m1), dtype=ccdt, device=dev)
    XTfull[:, :hm] = XTcols
    vecsW = transform_cplx(fW.V, _zero_outside(Zc @ XTfull, outmask))
    # residuals and their norms
    hS = torch.conj(h[:hm].to(ccdt)) @ XS[:hm, :hm]  # hᴴ·xs per column
    kT = torch.conj(kv.to(ccdt)) @ XTcols
    resnV, resnW = brV * torch.abs(hS), brW * torch.abs(kT)

    def residuals(coef, r):
        return tree_map(
            lambda l: coef.reshape((hm,) + (1,) * l.ndim).to(ccdt) * l.to(ccdt)[None], r)

    conv = min(st.nconv, hm)
    it = max(st.numiter, 1)  # reference numiter starts at 1 (src/eigsolve/biarnoldi.jl)
    infoV = ConvergenceInfo(conv, residuals(hS, rV), resnV, it, st.numops)
    infoW = ConvergenceInfo(conv, residuals(kT, rW), resnW, it, st.numops)
    return vals, vecsV, vecsW, infoV, infoW


def bieigsolve_driver(op, v0, w0, howmany: int, which, alg: BiArnoldi,
                      space: VectorSpace = STANDARD):
    m = alg.krylovdim
    if howmany > m:
        raise ValueError(f"howmany={howmany} exceeds krylovdim={m}")
    pdt = probe_dtype(op, v0)
    real = not pdt.is_complex and isinstance(which, str)
    cdt = pdt if real else torch.promote_types(pdt, torch.complex64)
    rdt = cdt.to_real()
    tol = rounded(alg.tol, rdt)
    btol = float(torch.tensor(torch.finfo(rdt).eps, dtype=rdt) ** 0.75)
    m1 = m + 1
    dev = device_of(v0)

    fV = kf.initialize(v0, m, cdt, space, vec_dtype=None if real else cdt)
    fW = kf.initialize(w0, m, cdt, space, vec_dtype=None if real else cdt)
    M = torch.zeros((m1, m1), dtype=cdt, device=dev)
    M[0, 0] = space.inner(bs.get(fV.V, 0), bs.get(fW.V, 0)).conj().to(cdt)
    st = _LoopState(fV, fW, M)

    def betas_ok():
        return bool((st.fV.beta > btol) & (st.fW.beta > btol))

    done = False
    while not done:
        # lock-step expansion (do-while: at least one step if possible)
        j = 0
        while st.fV.k < m and betas_ok():
            if alg.eager and j > 0 and not st.fV.k < max(howmany, 1):
                break
            st.fV = kf.expand(op.normal, st.fV, alg.orth, space, alg.verbosity)
            st.fW = kf.expand(op.apply_adjoint, st.fW, alg.orth, space, alg.verbosity)
            st.M = _update_M(st.M, st.fV.V, st.fW.V, st.fV.k, space)
            st.numops += 2
            j += 1

        L = st.fV.k
        Whv = bs.project(st.fW.V, bs.get(st.fV.V, L), L, space)
        Vhw = bs.project(st.fV.V, bs.get(st.fW.V, L), L, space)
        done, restart = _round(st, Whv, Vhw, howmany, which, alg, space, cdt, real, tol, btol)
        if restart is not None:
            keep, Vn, Wn, Hn, Kn, Mn = restart
            st.M = _update_M(Mn, Vn, Wn, keep, space)
            st.fV = kf.KrylovState(Vn, Hn, keep, st.fV.beta)
            st.fW = kf.KrylovState(Wn, Kn, keep, st.fW.beta)

    log_if(
        alg.verbosity, STARTSTOP,
        "BiArnoldi bieigsolve finished after {it} iterations: {nc} values "
        "converged", it=st.numiter, nc=min(st.nconv, howmany),
    )
    warn_if(
        alg.verbosity, st.nconv < howmany,
        "BiArnoldi bieigsolve stopped without convergence: {nc} of "
        f"{howmany}" + " values converged after {it} iterations",
        nc=st.nconv, it=st.numiter,
    )
    vals, vecsV, vecsW, infoV, infoW = _extract(st, howmany, cdt, real)
    return vals, (vecsV, vecsW), (infoV, infoW)


def _default_starts(A, v0, w0):
    """The JAX package's start vectors for a concrete matrix: ``v0`` then
    ``w0`` (whichever is missing) from one ``default_rng(42)``, normals in
    ``A``'s real type cast to ``A``'s type, on the given start's device,
    else on ``A``'s (a numpy matrix: the card)."""
    given = v0 if v0 is not None else w0
    if isinstance(A, torch.Tensor):
        dt, dev = A.dtype, A.device
    else:
        dt, dev = torch.from_numpy(np.asarray(A)).dtype, None
    if given is not None:
        dev = device_of(given)
    elif dev is None:
        dev = resolve_device("cuda")
    rng = np.random.default_rng(42)

    def draw(n):
        return torch.as_tensor(rng.standard_normal(n), device=dev).to(dt.to_real()).to(dt)

    if v0 is None:
        v0 = draw(A.shape[1])
    if w0 is None:
        w0 = draw(A.shape[0])
    return v0, w0


def bieigsolve(
    A,
    v0=None,
    w0=None,
    howmany: int = 1,
    which="LM",
    *,
    alg: Optional[BiArnoldi] = None,
    space: VectorSpace = STANDARD,
    tol: Optional[float] = None,
    krylovdim: Optional[int] = None,
    maxiter: Optional[int] = None,
    orth=None,
    eager: Optional[bool] = None,
    verbosity: Optional[int] = None,
):
    """Two-sided eigensolve: returns ``(values, (vecsV, vecsW), (infoV,
    infoW))`` with biorthogonal left/right eigenvector pairs (reference
    ``bieigsolve``, ``src/eigsolve/biarnoldi.jl:1-200``).  ``A`` is a matrix
    (tensor or numpy array), a callable, an ``(f, fadjoint)`` pair or a
    ``LinearOperator``; a bare callable's adjoint is derived
    (``with_adjoint_from``).  Without ``v0``/``w0`` a concrete matrix gets
    the JAX package's start vectors.  The solve runs on the device of
    ``v0``.  No differentiation rule, as in the JAX package: an input that
    requires grad raises ``NotImplementedError``.  On a sharded space
    (``psum_axis``) every rank holds its block of ``v0`` and ``w0``, every
    reduction is all-reduced, and the two dense Schur problems of a round
    are solved on every rank from the same inputs."""
    if v0 is None or w0 is None:
        if isinstance(A, (np.ndarray, torch.Tensor)) and A.ndim == 2:
            v0, w0 = _default_starts(A, v0, w0)
        else:
            raise ValueError("v0 and w0 are required unless A is a concrete matrix")
    op = as_operator(A, device=device_of(v0))
    refuse_grad("bieigsolve", op, v0, w0)
    if op.adjoint is None:
        op = op.with_adjoint_from(v0)
    if alg is None:
        kw = dict(tol=tol, krylovdim=krylovdim, maxiter=maxiter, orth=orth,
                  eager=eager, verbosity=verbosity)
        alg = BiArnoldi(**{k: v for k, v in kw.items() if v is not None})
    elif tol is not None and alg.tol != tol:
        alg = dataclasses.replace(alg, tol=tol)
    return bieigsolve_driver(op, v0, w0, howmany, which, alg, space)
