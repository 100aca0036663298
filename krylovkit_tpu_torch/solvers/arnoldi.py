"""General (non-Hermitian) eigsolve / schursolve solver: Krylov-Schur Arnoldi
(counterpart of ``krylovkit_tpu/solvers/arnoldi.py``).

The reference's ``_schursolve`` core (``src/eigsolve/arnoldi.jl:351-452``)
with the JAX package's restart: the factorization is kept in Krylov-Schur
form (sorted triangular block + spike row) and the next processing round
re-reduces the small projected matrix (``dense.schur_active`` reduces to
Hessenberg form itself), instead of restoring Arnoldi form with Householder
sweeps over the basis.

Two arithmetic modes, chosen by the problem's scalar type:

* **real**: real inputs keep the basis real and the projected problem uses
  the REAL Schur form with standardized 2×2 blocks
  (``dense.real_schur_active`` / ``sort_schur_real`` /
  ``triangular_eigvecs_real``), like the reference's ``dhseqr``/``dtrevc``
  path.  Convergence counting and the Krylov-Schur ``keep`` never split a
  2×2 block (reference ``src/eigsolve/arnoldi.jl:404-406, 463``).
* **complex**: complex inputs use the complex Schur form (no 2×2 blocks).

The loops are eager Python on the host over device tensors; ``k``, ``keep``,
``nconv`` and the counters are host ``int``s.  Real float32 stencil operators
with ``(R, 128)`` vectors run the one-stream fused expansion
(``kf.fused_expansions(..., hermitian=False)``).  Vectors may be pytrees
(``ops/vector.py``): the basis is the same pytree of stacked leaves.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import dense
from ..algorithms import Arnoldi
from ..factorizations import krylov as kf
from ..info import EACHITERATION, ConvergenceInfo, log_if, warn_if
from ..ops import basis as bs
from ..ops import orthonormal as on
from ..ops.operator import LinearOperator, probe_dtype
from ..ops.vector import STANDARD, VectorSpace, device_of, rounded, tree_map

__all__ = ["eigsolve_arnoldi", "schursolve", "realeigsolve_arnoldi"]


@dataclass
class _LoopState:
    fact: kf.KrylovState
    numiter: int
    numops: int
    nconv: int
    T: torch.Tensor  # (m+1, m+1) sorted Schur factor of the active block
    Q: torch.Tensor  # (m+1, m+1) sorted Schur basis (block-diagonal)
    resnorms: torch.Tensor  # (m+1,) sorted Schur residual norms
    sc: kf.FusedScales  # basis bookkeeping (identity unless fused expansion)


def _count_converged(Q, k: int, beta, tol: float):
    """Schur residual norms ``|β·Q[k-1, i]|`` (``inf`` beyond ``k``) and the
    number of leading ones within ``tol``."""
    valid = torch.arange(Q.shape[0], device=Q.device) < k
    res = torch.abs(beta * Q[max(k - 1, 0)])
    res = torch.where(valid, res, torch.full_like(res, float("inf")))
    flags = (res <= tol).to(torch.int64)
    return int(torch.sum(torch.cumprod(flags, 0))), res


def _process(H, k: int, beta, which, tol: float):
    """Schur + sort + convergence count on Schur residuals
    (reference src/eigsolve/arnoldi.jl:395-414)."""
    T, Q, _ = dense.schur_active(H, k)
    valid = torch.arange(H.shape[0], device=H.device) < k
    key = dense.which_key(torch.diagonal(T), which)
    key = torch.where(valid, key, torch.full_like(key, float("inf")))
    T, Q, _ = dense.sort_schur(T, Q, key)
    nconv, res = _count_converged(Q, k, beta, tol)
    return nconv, T, Q, res


def _process_real(H, k: int, beta, which, tol: float):
    """Real-Schur analogue of :func:`_process`: quasi-triangular sort +
    convergence count that never splits a 2×2 block."""
    T, Q, _ = dense.real_schur_active(H, k)
    T, Q = dense.sort_schur_real(T, Q, which, k)
    nconv, res = _count_converged(Q, k, beta, tol)
    # 2×2 guard: if position nconv is the second member of a block, the count
    # would split it — drop the whole block from the converged set
    if 0 < nconv < k and bool(dense.block_starts(T, k)[nconv - 1]):
        nconv -= 1
    return nconv, T, Q, res


def _block_safe_keep(T, k: int, keep: int) -> int:
    """Adjust ``keep`` so the Krylov-Schur truncation does not split a 2×2
    block (reference src/eigsolve/arnoldi.jl:463): prefer keeping the whole
    block, fall back to dropping it at the buffer edge."""
    split = 0 < keep < k and bool(dense.block_starts(T, k)[keep - 1])
    grown = keep + int(split)
    return grown if grown <= max(k - 1, 1) else keep - int(split)


def _masked(M: torch.Tensor, k: int, howmany: int) -> torch.Tensor:
    """``M`` with rows ``>= k`` and columns ``>= howmany`` zeroed."""
    out = torch.zeros_like(M)
    out[:k, :howmany] = M[:k, :howmany]
    return out


def _restart_rotation(fact: kf.KrylovState, T, Q, beta, keep: int, gate=None,
                      scales=None):
    """The Krylov-Schur truncation's rotation ``U`` of the stored rows and
    the truncated state (its basis not yet rotated): keep the leading
    sorted Schur vectors.  With ``gate`` false ``U`` is the identity and
    ``H``/``k`` keep their values (the JAX package's masked restart)."""
    V, H, k = fact.V, fact.H, fact.k
    m1 = H.shape[0]
    if gate is not None and not gate:
        return torch.eye(m1, dtype=Q.dtype, device=H.device), kf.KrylovState(V, H, k, beta)
    Qkeep = _masked(Q, k, keep)
    Qkeep[k, keep] += 1
    if scales is not None:
        # fused-expansion mode: stored rows are unnormalized with true basis
        # v_j = Σ_i L[i,j]·row_i — rotate with L·Q
        Qkeep = scales.to(Q.dtype) @ Qkeep
    # H ← [kept triangular block; spike row s = β·Q[k-1, :keep]]
    s = (beta * Q[max(k - 1, 0)]).to(H.dtype)
    Hnew = torch.zeros_like(H)
    Hnew[:keep, :keep] = T[:keep, :keep].to(H.dtype)
    Hnew[keep, :keep] = s[:keep]
    return Qkeep, kf.KrylovState(V, Hnew, keep, beta)


def _restart(fact: kf.KrylovState, T, Q, beta, keep: int, keep_max: int, gate=None,
             scales=None) -> kf.KrylovState:
    """Krylov-Schur truncation (:func:`_restart_rotation`) with the basis
    rotated.

    With ``gate`` false the rotation is the identity: the transform still
    runs, as in the JAX package's masked restart, and leaves the basis
    bit-identical.  ``keep_max`` bounds ``keep``, so only the surviving rows
    are written (``bs.transform_partial``)."""
    U, fact = _restart_rotation(fact, T, Q, beta, keep, gate, scales)
    Vnew = bs.transform_partial(fact.V, U, keep_max + 1)
    return kf.KrylovState(Vnew, fact.H, fact.k, beta)


def _fused(alg: Arnoldi, real: bool, cdt, op, x0, space) -> tuple:
    """``(fused, dgks)``: whether the solve runs the one-stream fused
    expansion (``ops/fused_lanczos.py``) in Arnoldi mode, full-Hessenberg
    column writes on real float32 stencil operators.  Plain cgs runs the
    single-sweep stream; the default cgs2 runs the one-reduce DGKS mode
    (deferred second sweep in scalar space)."""
    m = alg.krylovdim
    dgks = type(alg.orth) is on.ClassicalGramSchmidt2 and 2 * (m + 1) + 2 <= 128
    fused = (
        real
        and not alg.eager
        and (type(alg.orth) is on.ClassicalGramSchmidt or dgks)
        and cdt == torch.float32
        and kf.fused_available(op, x0, space, kmax=m + 1)
    )
    return fused, dgks


def _round(process, fact: kf.KrylovState, numiter: int, which, tol, btol: float,
           howmany: int, alg: Arnoldi, real: bool):
    """The host half of one Krylov-Schur round: process the projected
    problem and decide.  Returns ``(nconv, T, Q, res, numiter, done, keep,
    restart_now)``."""
    m = alg.krylovdim
    nconv, T, Q, res = process(fact.H, fact.k, fact.beta, which, tol)
    full = fact.k >= m
    numiter = numiter + int(full)
    # ¬(β > btol): a NaN β must count as breakdown
    stalled = not (float(fact.beta) > btol) and fact.k < m
    done = nconv >= howmany or (full and numiter >= alg.maxiter) or stalled
    keep = min(max((3 * m + 2 * nconv) // 5, 1), max(fact.k - 1, 1))
    if real:
        keep = _block_safe_keep(T, fact.k, keep)
    restart_now = not done and fact.k >= m
    log_if(
        alg.verbosity, EACHITERATION,
        "Arnoldi schursolve in iteration {it}: {nc} values converged, "
        "normres = {nr}",
        it=numiter, nc=nconv, nr=res[: min(8, m)],
    )
    return nconv, T, Q, res, numiter, done, keep, restart_now


def _keep_max(m: int, howmany: int) -> int:
    """Static bound on ``keep``: a restart implies ``nconv < howmany`` and
    ``k == m``; the block-safe adjustment can grow ``keep`` by one."""
    return min((3 * m + 2 * max(howmany - 1, 0)) // 5 + 1, m - 1)


def _arnoldi_loop(op, x0, howmany: int, which, alg: Arnoldi, space, cdt, real=False):
    m = alg.krylovdim
    rdt = cdt.to_real()
    tol = rounded(alg.tol, rdt)
    btol = float(torch.tensor(torch.finfo(rdt).eps, dtype=rdt) ** 0.75)
    dev = device_of(x0)

    process = _process_real if real else _process
    fact = kf.initialize(x0, m, cdt, space, vec_dtype=None if real else cdt,
                         verbosity=alg.verbosity)
    st = _LoopState(
        fact=fact, numiter=0, numops=0, nconv=0,
        T=torch.zeros((m + 1, m + 1), dtype=cdt, device=dev),
        Q=torch.eye(m + 1, dtype=cdt, device=dev),
        resnorms=torch.full((m + 1,), float("inf"), dtype=rdt, device=dev),
        sc=kf.fused_scales_init(m + 1, device=dev),
    )
    fused, dgks = _fused(alg, real, cdt, op, x0, space)
    keep_max = _keep_max(m, howmany)

    done = False
    while not done:
        fact, numops, sc = st.fact, st.numops, st.sc
        if fused:
            fact, sc, dops = kf.fused_expansions(
                op, fact, sc, m, btol, space, hermitian=False, dgks=dgks
            )
            numops += dops
        else:
            # do-while: at least one expansion if possible
            j = 0
            while fact.k < m and float(fact.beta) > btol:
                if alg.eager and not (j == 0 or fact.k < max(howmany, 1)):
                    break
                fact = kf.expand(op.normal, fact, alg.orth, space, alg.verbosity)
                numops += 1
                j += 1

        nconv, T, Q, res, numiter, done, keep, restart_now = _round(
            process, fact, st.numiter, which, tol, btol, howmany, alg, real)
        if alg.eager:
            # eager processes every step: restart only when it is due
            if restart_now:
                fact = _restart(fact, T, Q, fact.beta, keep, keep_max)
        else:
            # every processing but the last restarts; the last one runs the
            # identity rotation (the JAX package's masked restart)
            fact = _restart(fact, T, Q, fact.beta, keep, keep_max, gate=restart_now,
                            scales=sc.L if fused else None)
        if restart_now:
            # a restart renormalizes the surviving rows; the Krylov-Schur H
            # (triangular block + spike) seeds the stored-row Hessenberg of
            # the dgks mode
            sc = kf.fused_scales_init(m + 1, H=fact.H if fused else None, device=dev)
        st = _LoopState(fact, numiter, numops, nconv, T, Q, res, sc)
    return st


def _leading_rows(V, U: torch.Tensor, howmany: int):
    """Rows ``< howmany`` of ``bs.transform(V, U)``: the leading rotated
    vectors, without forming the rest of the rotated basis."""

    def leaf(lV):
        dt = torch.promote_types(U.dtype, lV.dtype)
        out = U[:, :howmany].to(dt).T @ lV.reshape(lV.shape[0], -1).to(dt)
        return out.reshape((howmany,) + tuple(lV.shape[1:])).to(lV.dtype)

    return tree_map(leaf, V)


def _check(howmany: int, m: int):
    if howmany > m:
        raise ValueError(f"howmany={howmany} exceeds krylovdim={m}")


def _residuals(st: _LoopState, s: torch.Tensor, howmany: int, dtype, out_dtype=None):
    """Residual vectors ``s[i]·v_k``: ``v_k`` is the normalized residual
    direction, rebuilt from the stored rows by column ``k`` of ``L``."""
    fact = st.fact
    vk = bs.unproject_bucketed(fact.V, st.sc.L[:, fact.k].to(dtype), fact.k + 1)

    def leaf(l):
        if out_dtype is not None:
            l = l.to(out_dtype)
        return s[:howmany].reshape((howmany,) + (1,) * l.ndim) * l[None]

    return tree_map(leaf, vk)


def _info(st: _LoopState, residuals, normres, howmany: int) -> ConvergenceInfo:
    return ConvergenceInfo(
        converged=min(st.nconv, howmany),
        residual=residuals,
        normres=normres,
        numiter=max(st.numiter, 1),
        numops=st.numops,
    )


def _schur_dtypes(op, x0):
    """``(real, cdt)`` of ``schursolve``: real inputs keep real arithmetic,
    complex ones work in at least complex64."""
    pdt = probe_dtype(op, x0)
    real = not pdt.is_complex
    return real, pdt if real else torch.promote_types(pdt, torch.complex64)


def _extract_schur(st: _LoopState, howmany: int, real: bool, cdt):
    """``(T, vecs, vals, info)`` of :func:`schursolve` from its final loop
    state."""
    fact = st.fact
    Qmask = kf.fold_scales(st.sc, _masked(st.Q, fact.k, howmany))  # fused row bookkeeping
    vecs = _leading_rows(fact.V, Qmask, howmany)
    Tsmall = st.T[:howmany, :howmany]
    if real:
        re, im = dense.real_schur_eigvals(st.T, fact.k)
        vals = (re[:howmany], im[:howmany])
    else:
        vals = torch.diagonal(st.T)[:howmany]
    s = fact.beta * st.Q[max(fact.k - 1, 0)]
    residuals = _residuals(st, s, howmany, cdt)
    return Tsmall, vecs, vals, _info(st, residuals, st.resnorms[:howmany], howmany)


def schursolve(op: LinearOperator, x0: torch.Tensor, howmany: int, which, alg: Arnoldi,
               space: VectorSpace = STANDARD):
    """Partial Schur decomposition (reference ``schursolve``,
    ``src/eigsolve/arnoldi.jl:1-150``): returns ``(T, vecs, vals, info)``
    where ``vecs`` are the leading ``howmany`` Schur vectors and ``T`` the
    ``(howmany, howmany)`` triangular factor.

    Real inputs run the REAL Schur path (real basis + quasi-triangular ``T``
    with standardized 2×2 blocks, like the reference's LAPACK ``dhseqr``);
    ``vals`` is then ``(re, im)`` as a pair of real tensors (combine with
    ``torch.complex(re, im)`` for complex values).  A 2×2 block straddling
    the ``howmany`` boundary is truncated; pick ``howmany`` that does not
    split a wanted conjugate pair."""
    _check(howmany, alg.krylovdim)
    real, cdt = _schur_dtypes(op, x0)
    st = _arnoldi_loop(op, x0, howmany, which, alg, space, cdt, real=real)
    return _extract_schur(st, howmany, real, cdt)


def _eig_dtypes(op, x0):
    """``(real, loop dtype, value dtype)`` of ``eigsolve_arnoldi``."""
    pdt = probe_dtype(op, x0)
    real = not pdt.is_complex
    cdt = torch.promote_types(pdt, torch.complex64)
    return real, pdt if real else cdt, cdt


def _extract_eig(st: _LoopState, howmany: int, real: bool, cdt):
    """``(vals, vecs, info)`` of :func:`eigsolve_arnoldi` from its final
    loop state."""
    fact = st.fact
    if real:
        Xre, Xim = dense.triangular_eigvecs_real(st.T, fact.k)
        re, im = dense.real_schur_eigvals(st.T, fact.k)
        vals = torch.complex(re, im).to(cdt)[:howmany]
        QXre, QXim = st.Q @ Xre, st.Q @ Xim
        Vre = _leading_rows(fact.V, kf.fold_scales(st.sc, _masked(QXre, fact.k, howmany)), howmany)
        Vim = _leading_rows(fact.V, kf.fold_scales(st.sc, _masked(QXim, fact.k, howmany)), howmany)
        vecs = tree_map(lambda a, b: torch.complex(a, b).to(cdt), Vre, Vim)
        QX = torch.complex(QXre, QXim).to(cdt)
    else:
        X = dense.triangular_eigvecs(st.T, fact.k)  # eigvecs of T in the Schur basis
        QX = st.Q @ X
        vecs = _leading_rows(
            fact.V, kf.fold_scales(st.sc, _masked(QX, fact.k, howmany)), howmany)
        vals = torch.diagonal(st.T)[:howmany]
    # eigenvector residuals: A x_i − λ_i x_i = β·(QX)[k-1, i]·v_k
    s = fact.beta * QX[max(fact.k - 1, 0)]
    residuals = _residuals(st, s, howmany, fact.H.dtype, out_dtype=cdt)
    return vals, vecs, _info(st, residuals, torch.abs(s)[:howmany], howmany)


def eigsolve_arnoldi(op: LinearOperator, x0: torch.Tensor, howmany: int, which,
                     alg: Arnoldi, space: VectorSpace = STANDARD):
    """General eigsolve via Krylov-Schur: returns ``(vals, vecs, info)``;
    eigenvectors extracted from the sorted Schur form with ``trevc``-style
    back-substitution (reference ``src/eigsolve/arnoldi.jl:151-170``).

    Real inputs run the real-arithmetic loop (real basis); complex
    eigenvalues and eigenvectors appear only in this final extraction, as in
    the reference's real ``dtrevc`` + pair combination
    (``src/dense/linalg.jl:223-246``)."""
    _check(howmany, alg.krylovdim)
    real, ldt, cdt = _eig_dtypes(op, x0)
    st = _arnoldi_loop(op, x0, howmany, which, alg, space, ldt, real=real)
    return _extract_eig(st, howmany, real, cdt)


def _require_real(pdt):
    if pdt.is_complex:
        raise ValueError(
            "realeigsolve requires a real linear map and vector; got "
            f"scalar type {pdt} (reference src/eigsolve/arnoldi.jl:293-300)"
        )
    return pdt


REALEIG_WARNING = (
    "realeigsolve: a complex conjugate pair entered the wanted window "
    "(max |imag| = {mi}); results are invalid — use eigsolve"
)


def _extract_realeig(st: _LoopState, howmany: int, pdt):
    """``(vals, vecs, info, maximag)`` of :func:`realeigsolve_arnoldi` from
    its final loop state (the caller warns)."""
    fact = st.fact
    re, im = dense.real_schur_eigvals(st.T, fact.k)
    maximag = torch.max(torch.abs(im[:howmany]))
    # real eigenvectors from the quasi-triangular form (imaginary parts are
    # zero for genuinely real eigenvalues)
    Xre, _ = dense.triangular_eigvecs_real(st.T, fact.k)
    QX = st.Q @ Xre
    vecs = _leading_rows(fact.V, kf.fold_scales(st.sc, _masked(QX, fact.k, howmany)), howmany)
    s = fact.beta * QX[max(fact.k - 1, 0)]
    residuals = _residuals(st, s, howmany, pdt)
    info = _info(st, residuals, torch.abs(s)[:howmany], howmany)
    return re[:howmany], vecs, info, maximag


def realeigsolve_arnoldi(op: LinearOperator, x0: torch.Tensor, howmany: int, which,
                         alg: Arnoldi, space: VectorSpace = STANDARD):
    """Eigsolve for real linear maps asserting real eigenvalues — the
    reference's ``realeigsolve`` (``src/eigsolve/arnoldi.jl:293-349``) in
    fully REAL arithmetic: real basis, real Schur form, real eigenvectors.

    Returns ``(vals, vecs, info, maximag)``: ``maximag`` is the largest
    |Im λ| among the ``howmany`` selected eigenvalues — nonzero means a
    complex conjugate pair entered the wanted window (the reference throws;
    the front-end raises)."""
    _check(howmany, alg.krylovdim)
    pdt = _require_real(probe_dtype(op, x0))
    st = _arnoldi_loop(op, x0, howmany, which, alg, space, pdt, real=True)
    out = _extract_realeig(st, howmany, pdt)
    warn_if(alg.verbosity, out[3] > 0, REALEIG_WARNING, mi=out[3])
    return out
