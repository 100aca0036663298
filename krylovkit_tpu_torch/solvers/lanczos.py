"""Hermitian eigsolve driver: Lanczos with thick restart (counterpart of
``krylovkit_tpu/solvers/lanczos.py``).

The reference's Krylov-Schur loop (``src/eigsolve/lanczos.jl``):

    expand to krylovdim (or breakdown / eager check)
      → dense eig of the projected matrix (``dense.eigh_active``)
      → sort by ``which``, count leading converged via |β·U[k-1, i]| ≤ tol
      → thick restart: keep (3·krylovdim + 2·nconv) ÷ 5 Ritz vectors, one
        in-place basis rotation, arrowhead projected matrix

as eager Python loops on the host over device tensors.  The control flow
reads a few scalars from the device: ``β`` per expansion step (and, with
``Lanczos(reorth="selective")``, the ω-recurrence's sweep test of
``kf.expand_hermitian_selective``) and ``nconv`` per restart.  Vectors may
be pytrees (``ops/vector.py``): the basis is then the same pytree of
stacked leaves, and the restart rotation runs the transform kernel on each
eligible leaf (``bs.transform_partial``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import dense
from ..algorithms import Lanczos
from ..factorizations import krylov as kf
from ..info import EACHITERATION, STARTSTOP, ConvergenceInfo, log_if, warn_if
from ..ops import basis as bs
from ..ops import orthonormal as on
from ..ops.operator import LinearOperator, probe_dtype
from ..ops.vector import STANDARD, VectorSpace, device_of, scalartype, tree_map

__all__ = ["eigsolve_lanczos"]


def _process(H, k: int, beta, which, tol: float, howmany: int):
    """Projected eig + sort + convergence count: ``(nconv, vals, U, res)``.

    The Hermitian Rayleigh quotient is rebuilt from the lower triangle of
    ``H``: expansion writes only ``(α, β)`` per column, restarts write both
    triangles."""
    T = torch.tril(H) + torch.tril(H, -1).conj().T
    w, U, valid = dense.eigh_active(T, k)
    perm = dense.sort_perm(w, valid, which)
    w, U, valid = w[perm], U[:, perm], valid[perm]
    res = torch.abs(beta * U[max(k - 1, 0)])
    res = torch.where(valid, res, torch.full_like(res, float("inf")))
    flags = (res <= tol).to(torch.int64)
    nconv = int(torch.sum(torch.cumprod(flags, 0)))
    return nconv, w, U, res


def _restart_rotation(H, k: int, U, keep: int, gate=None, scales=None):
    """The rotation of a thick restart to ``keep`` Ritz vectors, acting on
    the stored rows; the identity where ``gate`` is false."""
    m1 = H.shape[0]
    dev = H.device
    if gate is not None and not gate:
        return torch.eye(m1, dtype=U.dtype, device=dev)
    rows = torch.arange(m1, device=dev)[:, None]
    cols = torch.arange(m1, device=dev)[None, :]
    Ukeep = torch.where((cols < keep) & (rows < k), U, torch.zeros((), dtype=U.dtype, device=dev))
    Ukeep[k, keep] += 1
    if scales is not None:
        # stored rows are unnormalized (v_j = Σ_i L[i,j]·row_i): the rotation
        # acting on stored rows is L·U
        Ukeep = scales.to(U.dtype) @ Ukeep
    return Ukeep


def _arrowhead(H, k: int, vals, U, beta, keep: int):
    """The restarted projected matrix: ``diag(θ)`` plus the spike row
    ``s[j] = β·conj(U[k-1, j])`` and its mirror."""
    m1 = H.shape[0]
    dev = H.device
    s = (beta * torch.conj(U[max(k - 1, 0)])).to(H.dtype)
    didx = torch.arange(m1, device=dev)
    zero = torch.zeros((), dtype=H.dtype, device=dev)
    Hnew = torch.diag(torch.where(didx < keep, vals.to(H.dtype), zero))
    spike = torch.where(didx < keep, s, zero)
    Hnew[keep, :] += spike
    Hnew[:, keep] += torch.conj(spike)
    return Hnew


def _restart(fact: kf.KrylovState, vals, U, beta, keep: int, keep_max: int,
             gate=None, scales=None) -> kf.KrylovState:
    """Thick restart to an arrowhead factorization of size ``keep``.

    With ``gate`` false the rotation is the identity and ``H``/``k`` keep
    their values: the transform still runs, as in the JAX package's masked
    restart, and leaves the basis bit-identical."""
    Ukeep = _restart_rotation(fact.H, fact.k, U, keep, gate, scales)
    # rows < keep_max + 1 survive (kept Ritz vectors + relocated residual)
    Vnew = bs.transform_partial(fact.V, Ukeep, keep_max + 1)
    if gate is not None and not gate:
        return kf.KrylovState(Vnew, fact.H, fact.k, beta)
    return kf.KrylovState(Vnew, _arrowhead(fact.H, fact.k, vals, U, beta, keep), keep, beta)


@dataclass
class _LoopState:
    fact: kf.KrylovState
    numiter: int
    numops: int
    nconv: int
    vals: torch.Tensor  # (m+1,) sorted Ritz values
    U: torch.Tensor  # (m+1, m+1) sorted Ritz coefficient vectors
    resnorms: torch.Tensor  # (m+1,) sorted Ritz residual norms
    sc: kf.FusedScales  # basis bookkeeping (identity unless fused)


def eigsolve_lanczos(op: LinearOperator, x0, howmany: int, which,
                     alg: Lanczos, space: VectorSpace = STANDARD, coeff_dtype=None):
    """Hermitian eigsolve on ``x0``'s device.  Returns ``(vals, vecs, info)``
    with ``howmany`` leading entries (reference ``src/eigsolve/lanczos.jl``)."""
    m = alg.krylovdim
    if howmany > m:
        raise ValueError(f"howmany={howmany} exceeds krylovdim={m}; enlarge krylovdim")
    if isinstance(which, str) and which.upper() in ("LI", "SI"):
        raise ValueError(
            "which=:LI/:SI invalid for Hermitian eigsolve (real spectrum) — "
            "reference src/eigsolve/eigsolve.jl:209-236"
        )
    selective = getattr(alg, "reorth", "full") == "selective"
    if selective and alg.eager:
        raise ValueError(
            "reorth='selective' is incompatible with eager=True (the "
            "omega-recurrence state does not persist across eager processings)"
        )
    cdt = coeff_dtype or probe_dtype(op, x0)
    rdt = cdt.to_real()
    tol = alg.tol
    btol = float(torch.tensor(torch.finfo(rdt).eps, dtype=rdt) ** 0.75)
    dev = device_of(x0)

    # a complex operator and a real x0: the basis takes the operator's type,
    # as in the Arnoldi solver (the JAX package's Lanczos keeps x0's type and
    # drops the imaginary part of A v at the basis write)
    promote = cdt.is_complex and not scalartype(x0).is_complex
    fact = kf.initialize(x0, m, cdt, space, vec_dtype=cdt if promote else None,
                         verbosity=alg.verbosity)
    st = _LoopState(
        fact=fact, numiter=0, numops=0, nconv=0,
        vals=torch.zeros(m + 1, dtype=rdt, device=dev),
        U=torch.zeros((m + 1, m + 1), dtype=cdt, device=dev),
        resnorms=torch.full((m + 1,), float("inf"), dtype=rdt, device=dev),
        sc=kf.fused_scales_init(m + 1, device=dev),
    )

    # plain cgs runs the single-sweep fused stream; the default cgs2 runs the
    # one-reduce DGKS mode (deferred second sweep in scalar space)
    dgks = type(alg.orth) is on.ClassicalGramSchmidt2 and 2 * (m + 1) + 2 <= 128
    fused = (
        not alg.eager
        and not selective
        and (type(alg.orth) is on.ClassicalGramSchmidt or dgks)
        and cdt == torch.float32
        and kf.fused_available(op, x0, space, kmax=m + 1)
    )

    done = False
    while not done:
        fact, numops, sc = st.fact, st.numops, st.sc
        if fused:
            fact, sc, dops = kf.fused_expansions(
                op, fact, sc, m, btol, space, dgks=dgks
            )
            numops += dops
        else:
            if selective:
                # the ω-recurrence's state, at the eps level after every
                # restart (the kept Ritz vectors are orthonormal)
                om = torch.full((m + 1,), torch.finfo(rdt).eps, dtype=rdt, device=dev)
                omp = om.clone()
            j = 0
            while fact.k < m and float(fact.beta) > btol:
                if alg.eager and not (j == 0 or fact.k < max(howmany, 1)):
                    break
                if selective:
                    # the first expansion after a restart sweeps
                    fact, om, omp, _ = kf.expand_hermitian_selective(
                        op.normal, fact, om, omp, alg.orth, space,
                        force_sweep=j == 0 and st.numiter > 0)
                else:
                    fact = kf.expand_hermitian(op.normal, fact, alg.orth, space,
                                               verbosity=alg.verbosity)
                numops += 1
                j += 1

        nconv, vals, U, res = _process(fact.H, fact.k, fact.beta, which, tol, howmany)
        full = fact.k >= m
        numiter = st.numiter + int(full)
        # ¬(β > btol) rather than β ≤ btol: a NaN β counts as breakdown
        stalled = not (float(fact.beta) > btol) and fact.k < m
        done = nconv >= howmany or (full and numiter >= alg.maxiter) or stalled

        keep = min(max((3 * m + 2 * nconv) // 5, 1), max(fact.k - 1, 1))
        keep_max = min((3 * m + 2 * max(howmany - 1, 0)) // 5, m - 1)
        restart_now = not done and fact.k >= m
        if alg.eager:
            if restart_now:
                fact = _restart(fact, vals, U, fact.beta, keep, keep_max)
        else:
            # every processing but the last restarts; the last one runs the
            # identity rotation (the JAX package's masked restart)
            fact = _restart(fact, vals, U, fact.beta, keep, keep_max,
                            gate=restart_now, scales=sc.L if fused else None)
        if restart_now:
            # a restart renormalizes every surviving row: identity
            # bookkeeping, with the arrowhead H as stored-row Hessenberg
            sc = kf.fused_scales_init(m + 1, H=fact.H if fused else None, device=dev)
        log_if(
            alg.verbosity, EACHITERATION,
            "Lanczos eigsolve in iteration {it}: {nc} values converged, "
            "normres = {nr}",
            it=numiter, nc=nconv, nr=res[:howmany],
        )
        st = _LoopState(fact, numiter, numops, nconv, vals, U, res, sc)

    # --- extract results ---
    fact = st.fact
    k = fact.k
    m1 = m + 1
    rows = torch.arange(m1, device=dev)[:, None]
    cols = torch.arange(m1, device=dev)[None, :]
    Umask = torch.where((rows < k) & (cols < howmany), st.U,
                        torch.zeros((), dtype=st.U.dtype, device=dev))
    Umask = kf.fold_scales(st.sc, Umask)
    # V[k] (the residual direction) before the in-place rotation
    vk = bs.unproject_bucketed(fact.V, st.sc.L[:, k].to(cdt), k + 1)
    Vr = bs.transform_partial(fact.V, Umask, howmany)
    vecs = tree_map(lambda l: l[:howmany].clone(), Vr)
    # residual vectors r_i = β·U[k-1,i]·V[k] (reference src/eigsolve/lanczos.jl:127-133)
    s = fact.beta * st.U[max(k - 1, 0)]
    residuals = tree_map(lambda l: s[:howmany].reshape((howmany,) + (1,) * l.ndim) * l[None], vk)
    nconv_out = min(st.nconv, howmany)
    numiter_out = max(st.numiter, 1)
    log_if(
        alg.verbosity, STARTSTOP,
        "Lanczos eigsolve finished after {it} iterations: {nc} values "
        "converged, numops = {no}, normres = {nr}",
        it=numiter_out, nc=nconv_out, no=st.numops, nr=st.resnorms[:howmany],
    )
    warn_if(
        alg.verbosity, nconv_out < howmany,
        "Lanczos eigsolve stopped without convergence: {nc} of "
        f"{howmany} values converged " + "after {it} iterations",
        nc=nconv_out, it=numiter_out,
    )
    info = ConvergenceInfo(
        converged=nconv_out,
        residual=residuals,
        normres=st.resnorms[:howmany],
        numiter=numiter_out,
        numops=st.numops,
    )
    return st.vals[:howmany], vecs, info
