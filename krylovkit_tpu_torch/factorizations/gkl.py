"""Golub-Kahan-Lanczos bidiagonalization (counterpart of
``krylovkit_tpu/factorizations/gkl.py``).

The reference factorization (``src/factorizations/gkl.jl``) keeps two bases,
U in the codomain and V in the domain, with ``A V = U B + r b'`` and
``Aᴴ U = V Bᴴ`` for a lower-bidiagonal ``B`` (``gklrecurrence``,
``src/factorizations/gkl.jl:294-404``; two applies per step).  As in the JAX
package both bases are static ``(m+1,) + shape`` buffers and the projected
matrix is a dense ``(m+1, m+1)`` buffer ``B[i, j] = ⟨u_i, A v_j⟩``: a thick
restart writes a broken-arrow form (diag(σ) + spike row) and needs no
Householder restoration of the bidiagonal form.  ``k`` is a host ``int``;
buffers are updated in place.  The unfused steps take pytree vectors
(``ops/vector.py``), each basis with the tree of its side: ``U`` that of
the codomain, ``V`` that of the domain, which may differ.

Invariants after ``k`` steps (active sizes: ``U[0..k]``, ``V[0..k-1]``):

    A V[:, :k]  = U[:, :k] B[:k, :k] + u_k · B[k, :k]     (residual row)
    Aᴴ U[:, :k] = V[:, :k] B[:k, :k]ᴴ                      (exact)

The fused section steps the two bases in turn with the one-stream kernel of
``ops/fused_lanczos.py``: the normal stencil over V, the adjoint stencil
over U.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..info import EACHITERATION, log_if, warn_if
from ..ops import basis as bs
from ..ops import fused_lanczos as fl
from ..ops import orthonormal as on
from ..ops.operator import probe_adjoint
from ..ops.vector import (STANDARD, VectorSpace, alloc_batched, astype, device_of, tree_flatten,
                          tree_map, tree_row)
from . import krylov as kf

__all__ = ["GKLState", "initialize", "expand", "fused_kernel_available", "fused_expansions",
           "initialize_batched", "expand_batched", "fused_expansions_batched"]


@dataclasses.dataclass
class GKLState:
    """GKL factorization state."""

    U: Any  # codomain basis, capacity m+1
    V: Any  # domain basis, capacity m+1 (m used)
    B: torch.Tensor  # (m+1, m+1) projected matrix ⟨u_i, A v_j⟩
    k: int  # completed steps (= number of V vectors)
    beta: torch.Tensor  # 0-d, real: residual norm β_k


def initialize(op, x0, m: int, coeff_dtype, space: VectorSpace = STANDARD,
               vec_dtype=None, verbosity: int = 0) -> GKLState:
    """``U[0] = x0/‖x0‖``; the domain basis V takes the tree, shapes and
    dtypes of ``Aᴴ x0`` from a probe that is not counted (reference
    ``initialize``, ``src/factorizations/gkl.jl:183-215``)."""
    if vec_dtype is not None:
        x0 = astype(x0, vec_dtype)
    nrm = space.norm(x0)
    warn_if(
        verbosity, nrm == 0,
        "[krylovkit_tpu] starting vector x0 has zero norm: results are NaN "
        "and converged = 0",
    )
    dev = device_of(x0)
    u0 = tree_map(lambda l: l / nrm.to(l.dtype), x0)
    U = bs.set(bs.alloc(u0, m + 1), 0, u0)
    V = tree_map(lambda l: torch.zeros((m + 1,) + tuple(l.shape), dtype=l.dtype, device=dev),
                 probe_adjoint(op, u0))
    B = torch.zeros((m + 1, m + 1), dtype=coeff_dtype, device=dev)
    beta = torch.ones((), dtype=coeff_dtype.to_real(), device=dev)
    return GKLState(U, V, B, 0, beta)


def _two_pass(orth: on.Orthogonalizer) -> bool:
    return isinstance(orth, (on.ClassicalGramSchmidt2, on.ModifiedGramSchmidt2))


def _sweep(orth: on.Orthogonalizer) -> on.Orthogonalizer:
    """The orthogonalizer a half-step runs: one drift sweep for the two-pass
    orthogonalizers (their first pass is the exact subtraction), else
    ``orth`` itself."""
    if not _two_pass(orth):
        return orth
    return on.cgs if isinstance(orth, on.ClassicalGramSchmidt2) else on.mgs


def _domain_front(state: GKLState, w, orth: on.Orthogonalizer):
    """``w = Aᴴ u_k`` less its exact components along V (two-pass only)."""
    if not _two_pass(orth):
        return w
    rowk = bs.mask_coeffs(state.B[state.k], state.k)
    return tree_map(torch.sub, w, bs.unproject_bucketed(state.V, torch.conj(rowk), state.k))


def _codomain_front(state: GKLState, s, alpha, orth: on.Orthogonalizer):
    """``s = A v_k`` less ``α·u_k`` (two-pass only)."""
    if not _two_pass(orth):
        return s
    return tree_map(lambda ls, lu: ls - alpha.to(ls.dtype) * lu, s, bs.get(state.U, state.k))


def _append(state: GKLState, u_new, alpha, beta, c, d, orth: on.Orthogonalizer,
            verbosity: int) -> GKLState:
    """Row ``k + 1`` of U and the entries of ``B`` that the step wrote
    (``v_k`` is already in V)."""
    U, V, B, k = state.U, state.V, state.B, state.k
    bs.set(U, k + 1, u_new)
    if not _two_pass(orth):
        # row k of B gets (conj(c), α), column k gets (d, β)
        B[:, k] = d.to(B.dtype)
        B[k, :] = torch.conj(c).to(B.dtype)
    B[k, k] = alpha.to(B.dtype)
    B[k + 1, k] = beta.to(B.dtype)
    log_if(
        verbosity, EACHITERATION + 1,
        "GKL expansion to dimension {k}: subspace normres = {b}",
        k=k + 1, b=beta,
    )
    return GKLState(U, V, B, k + 1, beta)


def expand(op, state: GKLState, orth: on.Orthogonalizer, space: VectorSpace = STANDARD,
           verbosity: int = 0) -> GKLState:
    """One GKL step (two operator applies): ``w = Aᴴ u_k`` orthonormalized
    against V gives ``(α, v_k)``; ``s = A v_k`` orthonormalized against U
    gives ``(β, u_{k+1})`` (reference ``gklrecurrence``,
    ``src/factorizations/gkl.jl:294-404``).

    The two-pass orthogonalizers (cgs2/mgs2) subtract the exact recurrence
    components and run ONE drift sweep per half-step:

    * domain: the components of ``Aᴴ u_k`` along ``V[0..k-1]`` are
      ``conj(B[k, :k])`` exactly: ``β_{k-1} e_{k-1}`` at an ordinary step
      (``gkl.jl:352-355``), the spike row after a thick restart;
    * codomain: ``⟨u_i, A v_k⟩ = α δ_{ik}`` for ``i <= k``, so one ``α·u_k``
      subtraction replaces the first sweep (``gkl.jl:356-359``).

    The drift coefficients are dropped: ``B`` keeps the exact entries already
    in the buffer.  The other orthogonalizers run full sweeps and write row
    and column ``k`` of ``B`` from their coefficients."""
    k, sweep = state.k, _sweep(orth)
    w = _domain_front(state, op.apply_adjoint(bs.get(state.U, k)), orth)
    v_new, alpha, c = on.orthonormalize(w, state.V, k, sweep, space)
    bs.set(state.V, k, v_new)
    s = _codomain_front(state, op.normal(v_new), alpha, orth)
    u_new, beta, d = on.orthonormalize(s, state.U, k + 1, sweep, space)
    return _append(state, u_new, alpha, beta, c, d, orth, verbosity)


def initialize_batched(ops, x0s, m: int, coeff_dtype, space: VectorSpace = STANDARD,
                       vec_dtype=None, verbosity: int = 0):
    """:func:`initialize` of every problem ``p`` (operator ``ops[p]``, start
    ``x0s[p]``) on stacked bases: ``(U (P, m+1, ...), V (P, m+1, ...),
    [GKLState])``, problem ``p``'s state holding rows ``U[p]`` and ``V[p]``
    and its own ``B (m+1, m+1)``; a pytree vector's bases are trees of
    stacks, each problem's rows views of them.  The starts' norms are one
    ``norm_batched`` (:func:`~.krylov.normalized_batched`).  The problems'
    domain vectors must share one structure, shapes and types."""
    u0s = kf.normalized_batched(x0s, space, vec_dtype, verbosity)
    doms = [probe_adjoint(o, u0) for o, u0 in zip(ops, u0s)]
    P, u0, v0 = len(x0s), u0s[0], doms[0]
    dev = device_of(u0)
    Ub = alloc_batched(u0, P, m + 1)
    Vb = alloc_batched(v0, P, m + 1, device=dev)

    def layout(v):
        leaves, spec = tree_flatten(v)
        return spec, [(tuple(l.shape), l.dtype) for l in leaves]

    states = []
    for p in range(P):
        if layout(doms[p]) != layout(v0):
            raise ValueError(f"problem {p}: its domain vectors {layout(doms[p])[1]} differ "
                             f"from problem 0's {layout(v0)[1]}")
        Up, Vp = tree_row(Ub, p), tree_row(Vb, p)
        bs.set(Up, 0, u0s[p])
        B = torch.zeros((m + 1, m + 1), dtype=coeff_dtype, device=dev)
        beta = torch.ones((), dtype=coeff_dtype.to_real(), device=dev)
        states.append(GKLState(Up, Vp, B, 0, beta))
    return Ub, Vb, states


def expand_batched(ops, states: dict, orth: on.Orthogonalizer, space: VectorSpace = STANDARD,
                   verbosity: int = 0) -> dict:
    """One :func:`expand` step of every problem in ``states`` (``{p:
    GKLState}``) at once, each at its own ``k``: ``ops`` is the batch's
    ``solvers/batched.py:_Operators`` (``ops.adjoint`` and ``ops`` apply a
    set of problems' vectors at once: one batched launch where the operator
    allows).  Each half-step is one stack apply and one sweep of every
    problem through :func:`~..ops.orthonormal.orthonormalize_batched` (with
    the projection flag on, a cgs-family sweep is one batched K5 and one
    batched K6 launch).  Each problem's new state is its one-problem step's.
    Returns ``{p: GKLState}``."""
    ps = list(states)
    sweep = _sweep(orth)
    W = ops.adjoint({p: bs.get(states[p].U, states[p].k) for p in ps})
    W = {p: _domain_front(states[p], W[p], orth) for p in ps}
    dom = on.orthonormalize_batched([W[p] for p in ps], [states[p].V for p in ps],
                                    [states[p].k for p in ps], sweep, space)
    for p, (v_new, _, _) in zip(ps, dom):
        bs.set(states[p].V, states[p].k, v_new)
    S = ops({p: v_new for p, (v_new, _, _) in zip(ps, dom)})
    S = {p: _codomain_front(states[p], S[p], alpha, orth) for p, (_, alpha, _) in zip(ps, dom)}
    cod = on.orthonormalize_batched([S[p] for p in ps], [states[p].U for p in ps],
                                    [states[p].k + 1 for p in ps], sweep, space)
    return {p: _append(states[p], u_new, alpha, beta, c, d, orth, verbosity)
            for p, (_, alpha, c), (u_new, beta, d) in zip(ps, dom, cod)}


# --------------------------------------------------------------------------
# Fused one-stream GKL expansion (square stencil operators, (R, 128) float32)
# --------------------------------------------------------------------------

def fused_kernel_available(op, x0, space: VectorSpace, kmax: int) -> bool:
    """Eligibility of the fused-kernel GKL expansion: a real SQUARE fusable
    stencil (``fl.spec_for`` and ``fl.adjoint_spec``), one ``(R, 128)``
    float32 tensor in domain and codomain (never a pytree vector, as in the
    JAX package), the standard inner product,
    ``2·kmax + 2 <= 128`` (the drift packing), and a vector on a CUDA device
    (the kernel) or on the CPU (its plain version).

    A sharded space (``psum_axis``) is refused: the two-basis stream has no
    cross-shard halos or all-reduced reductions, so a sharded ``svdsolve``
    runs unfused.  The JAX package's gate does not look at
    ``space.psum_axis`` and gives wrong singular values inside a sharded
    solve."""
    if 2 * kmax + 2 > fl.LANES or space.psum_axis is not None:
        return False
    if not isinstance(x0, torch.Tensor):
        return False
    spec, spec_a = fl.spec_for(op), fl.adjoint_spec(op)
    if spec is None or spec_a is None or space.inner_fn is not None:
        return False
    if x0.ndim != 2 or x0.shape[1] != fl.LANES or x0.dtype != torch.float32:
        return False
    R = x0.shape[0]
    if R % 8 != 0 or R < 16:
        return False
    if spec.gc and R * fl.LANES != spec.gr * spec.gc:
        return False
    try:
        fl.choose_tile(R, h=max(spec.h, spec_a.h))
    except ValueError:
        return False
    return x0.device.type in ("cuda", "cpu")


def _correct_col(sc: kf.FusedScales, d, q, k: int):
    """Immediate DGKS correction of column ``k`` of the basis bookkeeping from
    the drift ``d_j = <X_j, X_row_k>`` the kernel measured and ``q =
    ‖row_k‖²`` (the scalar-space second sweep of ``krylov._step_coeffs``).
    Returns ``(sc', λ = L[k, k])``."""
    L, s = sc.L, sc.s
    idx = torch.arange(L.shape[0], device=L.device)
    sk = kf._safe_inv(torch.sqrt(q))
    s = torch.where(idx == k, sk, s)
    ohk = (idx == k).to(torch.float32)
    d = torch.where(idx == k, q, d)
    d = torch.where(idx <= k, d, 0.0)
    c2 = sk * (L.T @ d)
    c2 = torch.where(idx < k, c2, 0.0)
    N = 1.0 / torch.sqrt(torch.clamp(1.0 - torch.sum(c2 * c2), min=0.25))
    Lcol = N * (sk * ohk - L @ c2)
    Lcol = torch.where(idx <= k, Lcol, 0.0)
    return kf.FusedScales(_set_col(L, Lcol, k), s, sc.Hs, sc.M), N * sk


def _set_col(A, col, k: int):
    A = A.clone()
    A[:, k] = col
    return A


def _domain_coeffs(scU: kf.FusedScales, scV: kf.FusedScales, B, k: int, idx):
    """``λ_U``, column ``k`` of ``L_U`` and the subtraction coefficients of
    the domain half-step at ``k``."""
    LUk = scU.L[:, k]
    p = torch.where(idx < k, B[k].to(torch.float32), 0.0)
    cD = scV.L @ p - scU.Hs @ torch.where(idx < k, LUk, 0.0)
    return scU.L[k, k], LUk, torch.where(idx < k, cD, 0.0)


def _codomain_coeffs(scV: kf.FusedScales, LUk, alpha, k: int, idx):
    """The subtraction coefficients of the codomain half-step at ``k``."""
    cC = alpha * LUk - scV.Hs @ torch.where(idx < k, scV.L[:, k], 0.0)
    return torch.where(idx <= k, cC, 0.0)


def _bcur(scU: kf.FusedScales, k: int):
    """Residual norm of the current factorization: ``‖U-row k‖ = 1/s_U[k]``."""
    return kf._safe_inv(scU.s[k])


def _drift(raw, kp1: int, kmax: int):
    """The drift of a half-step's new row against ``X[:kp1]`` (padded to
    ``kmax``) and its squared norm, from the kernel's packed reductions."""
    return torch.nn.functional.pad(raw[kp1:2 * kp1], (0, kmax - kp1)), raw[2 * kp1 + 1]


def _after_domain(scU, scV, dV, qV, cD, lamU, k: int, idx):
    """Bookkeeping of the new V-row ``k``: ``(α, scU', scV', λ_V)``."""
    alpha = torch.sqrt(qV)
    scV, lamV = _correct_col(scV, dV, qV, k)
    # stored-row image: Aᴴ U_{row k} = (V_row k + Σ cD V)/λ_U
    ohk = (idx == k).to(torch.float32)
    scU = dataclasses.replace(
        scU, Hs=_set_col(scU.Hs, torch.where(idx <= k, (ohk + cD) / lamU, 0.0), k))
    return alpha, scU, scV, lamV


def _after_codomain(scU, scV, dU, qU, cC, lamV, k: int, idx):
    """Bookkeeping of the new U-row ``k + 1``: ``(β, scU', scV')``."""
    beta = torch.sqrt(qU)
    scU, _ = _correct_col(scU, dU, qU, k + 1)
    ohk1 = (idx == k + 1).to(torch.float32)
    scV = dataclasses.replace(
        scV, Hs=_set_col(scV.Hs, torch.where(idx <= k + 1, (ohk1 + cC) / lamV, 0.0), k))
    return beta, scU, scV


def _tail(op, state: GKLState, scU, scV, y_d, idx):
    """The tail step at ``k = m-1``: both half-steps in plain operations; the
    domain apply ``A·v`` counts (1 op), the adjoint apply is skipped.
    Returns ``(scU', scV', β)``; writes V-row ``k``, U-row ``k + 1`` and
    ``B``."""
    U, V, B, k = state.U, state.V, state.B, state.k
    kmax = B.shape[0]
    lamU, LUk, cD = _domain_coeffs(scU, scV, B, k, idx)
    W = lamU * y_d - bs.unproject_bucketed(V, cD, k)
    qV = torch.sum(W * W)
    alpha = torch.sqrt(qV)
    V[k] = W
    scV, lamV = _correct_col(scV, torch.zeros(kmax, dtype=torch.float32, device=W.device), qV, k)
    y_c = op.normal(W)
    cC = _codomain_coeffs(scV, LUk, alpha, k, idx)
    S = lamV * y_c - bs.unproject_bucketed(U, cC, k + 1)
    beta_m = torch.sqrt(torch.sum(S * S))
    U[k + 1] = S
    # placeholder (uncorrected) column for the tail row of U
    ohk1 = (idx == k + 1).to(torch.float32)
    s_inv = kf._safe_inv(beta_m)
    scU = dataclasses.replace(
        scU, L=_set_col(scU.L, s_inv * ohk1, k + 1),
        s=torch.where(idx == k + 1, s_inv, scU.s))
    B[k, k] = alpha.to(B.dtype)
    B[k + 1, k] = beta_m.to(B.dtype)
    return scU, scV, beta_m


def fused_expansions(op, state: GKLState, scU: kf.FusedScales, scV: kf.FusedScales,
                     m: int, btol: float, space: VectorSpace):
    """Expand a GKL factorization from ``k`` to ``m`` with the one-stream
    fused kernel: per step one launch over the domain basis V (subtract,
    append ``v_k``, **normal** stencil apply → ``A v_k``) and one over the
    codomain basis U (subtract, append ``u_{k+1}``, **adjoint** stencil apply
    → ``Aᴴ u_{k+1}``).  The GKL analogue of ``krylov.fused_expansions``
    (recurrence replaced: ``src/factorizations/gkl.jl:294-404``).

    The bidiagonal structure supplies the exact subtraction coefficients
    (``Aᴴ u_k`` along V is row ``k`` of the buffer, ``A v_k`` along U is
    ``α e_k``); stored rows stay raw with one :class:`~.krylov.FusedScales`
    per basis, and each launch's drift reduction feeds an IMMEDIATE
    scalar-space DGKS correction (cgs2 orthogonality).  What a subtraction
    misses lands in the drift and is removed from the TRUE basis by the
    correction, so no reduction across the two bases is needed.

    Stored-row images ride the scales' ``Hs`` slots: ``scU.Hs[j,i]`` holds
    ``Aᴴ U_i = Σ_j scU.Hs[j,i] V_j`` and ``scV.Hs[j,i]`` holds ``A V_i =
    Σ_j scV.Hs[j,i] U_j`` (after a thick restart they are seeded from the
    broken-arrow buffer).

    The kernel launches with the live rows ``B = k`` over V (new row ``k``)
    and ``B = k + 1`` over U (new row ``k + 1``); the first domain half-step
    of a solve has no live row (``B = 0``: the kernel scales ``y`` alone).
    The two half-steps alternate on one stream, as the kernel's per-device
    scratch requires.

    ``numops``: ``2·(m − k)`` per call, one in-kernel apply per half-step
    and the codomain tail without the adjoint apply it would waste, the
    unfused count.  The loop test reads one scalar per step.

    Returns ``(state', scU', scV', numops_inc)``."""
    U, V, B, k0 = state.U, state.V, state.B, state.k
    kmax = B.shape[0]
    spec_n, spec_a = fl.spec_for(op), fl.adjoint_spec(op)
    idx = torch.arange(kmax, device=B.device)

    # prime: y_d = Aᴴ u_{k0} (stored row k0 is normalized: a fresh start or a
    # restart)
    y_d = op.apply_adjoint(U[k0])
    k = k0
    while k < m - 1 and float(_bcur(scU, k)) > btol:
        # ---- domain half-step: append V-row k, y_c = A·(V-row k) ----
        lamU, LUk, cD = _domain_coeffs(scU, scV, B, k, idx)
        y_c, raw = fl.fused_step(V, y_d, torch.cat([cD, lamU[None]]), k, k, spec_n,
                                 with_drift=True)
        alpha, scU, scV, lamV = _after_domain(scU, scV, *_drift(raw, k, kmax), cD, lamU, k, idx)
        # ---- codomain half-step: append U-row k+1, y_d = Aᴴ·(U-row k+1) ----
        cC = _codomain_coeffs(scV, LUk, alpha, k, idx)
        y_d, raw = fl.fused_step(U, y_c, torch.cat([cC, lamV[None]]), k + 1, k + 1, spec_a,
                                 with_drift=True)
        beta, scU, scV = _after_codomain(scU, scV, *_drift(raw, k + 1, kmax), cC, lamV, k, idx)
        # ---- B: α at [k, k], β at [k+1, k] (the exact rows stay) ----
        B[k, k] = alpha.to(B.dtype)
        B[k + 1, k] = beta.to(B.dtype)
        k += 1

    b_k = _bcur(scU, k)
    go = k == m - 1 and float(b_k) > btol
    if go:
        scU, scV, beta_out = _tail(op, GKLState(U, V, B, k, state.beta), scU, scV, y_d, idx)
        k += 1
    else:
        beta_out = b_k
    state_new = GKLState(U, V, B, k, beta_out.to(state.beta.dtype))
    return state_new, scU, scV, 2 * (k - k0)


def fused_expansions_batched(ops, Ub, Vb, states: dict, scUs: dict, scVs: dict, m: int,
                             btol: float):
    """:func:`fused_expansions` of every problem in ``states`` (``{p:
    GKLState}``, ``states[p].U`` and ``.V`` the rows ``Ub[p]`` and ``Vb[p]``
    of the batch's bases ``(P, m + 1, R, 128)``) on one fusable stencil
    operator at once (the counterpart of the JAX function under
    ``jax.vmap``): each problem expands from its own ``k`` to ``m`` as its
    own solve would, and leaves the launches when its solve would stop.
    ``ops`` is the batch's ``solvers/batched.py:_Operators`` (the priming
    adjoint applies, one stack where it batches them).

    A step reads one list of the stepping problems' ``‖U-row k‖`` from the
    device, then makes the two half-steps in turn on one stream: one
    :func:`~..ops.fused_lanczos.fused_step_batched` launch over the V stack
    (normal spec) for each distinct live-row count among the problems that
    step, then one over the U stack (adjoint spec) for each.  A launch of
    unequal live rows would run the plan of the largest and round the
    others' reductions otherwise than their one-problem launches; one count
    a launch keeps every problem's one-problem bits.  The scalar
    bookkeeping and the plain tail step run per problem.  Returns ``({p:
    GKLState}, {p: scU}, {p: scV}, {p: numops increment})``."""
    problems = sorted(states)
    op = ops.ops[problems[0]]
    spec_n, spec_a = fl.spec_for(op), fl.adjoint_spec(op)
    kmax = m + 1
    dev = Ub.device
    idx = torch.arange(kmax, device=dev)
    P = Ub.shape[0]
    # y_d (Aᴴ of the top U-row) and y_c (A of the new V-row) of every problem
    Yd = torch.empty((P,) + tuple(Vb.shape[2:]), dtype=Vb.dtype, device=dev)
    Yc = torch.empty((P,) + tuple(Ub.shape[2:]), dtype=Ub.dtype, device=dev)
    for p, y in ops.adjoint({p: Ub[p, states[p].k] for p in problems}).items():
        Yd[p].copy_(y)
    k = {p: states[p].k for p in problems}
    scU, scV = dict(scUs), dict(scVs)
    B = {p: states[p].B for p in problems}
    none = torch.zeros(kmax + 1, dtype=torch.float32, device=dev)

    def launches(X, Y, Ynext, rows, kp1, spec, stepping):
        """One batched half-step per distinct ``kp1`` (= live rows); the
        packed reductions of each problem."""
        G = torch.stack([rows.get(p, none) for p in range(P)])
        kp1s = [kp1.get(p, 0) for p in range(P)]
        raws = {}
        for b in sorted({kp1[p] for p in stepping}):
            group = [p for p in stepping if kp1[p] == b]
            _, raw = fl.fused_step_batched(X, Y, G, kp1s, kp1s, spec, with_drift=True,
                                           active=group, ynext=Ynext)
            raws.update({p: raw[p] for p in group})
        return raws

    go, stepping = {}, problems
    while stepping:
        bcur = torch.stack([_bcur(scU[p], k[p]) for p in stepping]).tolist()
        nxt = []
        for p, b in zip(stepping, bcur):
            if k[p] < m - 1 and b > btol:
                nxt.append(p)
            else:
                go[p] = k[p] == m - 1 and b > btol
        if not nxt:
            break
        # ---- domain half-steps: append V-row k, y_c = A·(V-row k) ----
        dom = {p: _domain_coeffs(scU[p], scV[p], B[p], k[p], idx) for p in nxt}
        raws = launches(Vb, Yd, Yc, {p: torch.cat([cD, lamU[None]])
                                     for p, (lamU, _, cD) in dom.items()},
                        {p: k[p] for p in nxt}, spec_n, nxt)
        cod, alphas = {}, {}
        for p in nxt:
            lamU, LUk, cD = dom[p]
            alphas[p], scU[p], scV[p], lamV = _after_domain(
                scU[p], scV[p], *_drift(raws[p], k[p], kmax), cD, lamU, k[p], idx)
            cod[p] = (_codomain_coeffs(scV[p], LUk, alphas[p], k[p], idx), lamV)
        # ---- codomain half-steps: append U-row k+1, y_d = Aᴴ·(U-row k+1) ----
        raws = launches(Ub, Yc, Yd, {p: torch.cat([cC, lamV[None]])
                                     for p, (cC, lamV) in cod.items()},
                        {p: k[p] + 1 for p in nxt}, spec_a, nxt)
        for p in nxt:
            cC, lamV = cod[p]
            beta, scU[p], scV[p] = _after_codomain(
                scU[p], scV[p], *_drift(raws[p], k[p] + 1, kmax), cC, lamV, k[p], idx)
            B[p][k[p], k[p]] = alphas[p].to(B[p].dtype)
            B[p][k[p] + 1, k[p]] = beta.to(B[p].dtype)
            k[p] += 1
        stepping = nxt

    new, dops = {}, {}
    for p in problems:
        st = states[p]
        if go[p]:
            scU[p], scV[p], beta_out = _tail(ops.ops[p], GKLState(st.U, st.V, B[p], k[p], st.beta),
                                             scU[p], scV[p], Yd[p], idx)
            k[p] += 1
        else:
            beta_out = _bcur(scU[p], k[p])
        new[p] = GKLState(st.U, st.V, B[p], k[p], beta_out.to(st.beta.dtype))
        dops[p] = 2 * (k[p] - st.k)
    return new, scU, scV, dops
