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
from ..ops.vector import STANDARD, VectorSpace, astype, device_of, tree_map
from . import krylov as kf

__all__ = ["GKLState", "initialize", "expand", "fused_kernel_available", "fused_expansions"]


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
    U, V, B, k = state.U, state.V, state.B, state.k
    w = op.apply_adjoint(bs.get(U, k))
    if isinstance(orth, (on.ClassicalGramSchmidt2, on.ModifiedGramSchmidt2)):
        sweep = on.cgs if isinstance(orth, on.ClassicalGramSchmidt2) else on.mgs
        rowk = bs.mask_coeffs(B[k], k)
        w = tree_map(torch.sub, w, bs.unproject_bucketed(V, torch.conj(rowk), k))
        v_new, alpha, _ = on.orthonormalize(w, V, k, sweep, space)
        bs.set(V, k, v_new)
        s = op.normal(v_new)
        s = tree_map(lambda ls, lu: ls - alpha.to(ls.dtype) * lu, s, bs.get(U, k))
        u_new, beta, _ = on.orthonormalize(s, U, k + 1, sweep, space)
        bs.set(U, k + 1, u_new)
    else:
        # row k of B gets (conj(c), α), column k gets (d, β)
        v_new, alpha, c = on.orthonormalize(w, V, k, orth, space)
        bs.set(V, k, v_new)
        s = op.normal(v_new)
        u_new, beta, d = on.orthonormalize(s, U, k + 1, orth, space)
        bs.set(U, k + 1, u_new)
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
    f32 = torch.float32

    def kernel_call(X, y, c, lam, kp1: int, spec):
        """One half-step: ``X[kp1] = λ·y − Σ_{j<kp1} c_j X_j``; returns the
        image of the new row, its drift against ``X[:kp1]`` and its squared
        norm."""
        yn, raw = fl.fused_step(X, y, torch.cat([c, lam[None]]), kp1, kp1, spec,
                                with_drift=True)
        dn = torch.nn.functional.pad(raw[kp1:2 * kp1], (0, kmax - kp1))
        return yn, dn, raw[2 * kp1 + 1]

    def domain_coeffs(scU, scV, B, k: int):
        """``λ_U``, column ``k`` of ``L_U`` and the subtraction coefficients
        of the domain half-step."""
        LUk = scU.L[:, k]
        p = torch.where(idx < k, B[k].to(f32), 0.0)
        cD = scV.L @ p - scU.Hs @ torch.where(idx < k, LUk, 0.0)
        return scU.L[k, k], LUk, torch.where(idx < k, cD, 0.0)

    def codomain_coeffs(scV, LUk, alpha, k: int):
        cC = alpha * LUk - scV.Hs @ torch.where(idx < k, scV.L[:, k], 0.0)
        return torch.where(idx <= k, cC, 0.0)

    def bcur(scU, k: int):
        # residual norm of the current factorization = ‖U-row k‖ = 1/s_U[k]
        return kf._safe_inv(scU.s[k])

    # prime: y_d = Aᴴ u_{k0} (stored row k0 is normalized: a fresh start or a
    # restart)
    y_d = op.apply_adjoint(U[k0])
    k = k0
    while k < m - 1 and float(bcur(scU, k)) > btol:
        # ---- domain half-step: append V-row k, y_c = A·(V-row k) ----
        lamU, LUk, cD = domain_coeffs(scU, scV, B, k)
        y_c, dV, qV = kernel_call(V, y_d, cD, lamU, k, spec_n)
        alpha = torch.sqrt(qV)
        scV, lamV = _correct_col(scV, dV, qV, k)
        # stored-row image: Aᴴ U_{row k} = (V_row k + Σ cD V)/λ_U
        ohk = (idx == k).to(f32)
        scU = dataclasses.replace(
            scU, Hs=_set_col(scU.Hs, torch.where(idx <= k, (ohk + cD) / lamU, 0.0), k))

        # ---- codomain half-step: append U-row k+1, y_d = Aᴴ·(U-row k+1) ----
        cC = codomain_coeffs(scV, LUk, alpha, k)
        y_d, dU, qU = kernel_call(U, y_c, cC, lamV, k + 1, spec_a)
        beta = torch.sqrt(qU)
        scU, _ = _correct_col(scU, dU, qU, k + 1)
        ohk1 = (idx == k + 1).to(f32)
        scV = dataclasses.replace(
            scV, Hs=_set_col(scV.Hs, torch.where(idx <= k + 1, (ohk1 + cC) / lamV, 0.0), k))

        # ---- B: α at [k, k], β at [k+1, k] (the exact rows stay) ----
        B[k, k] = alpha.to(B.dtype)
        B[k + 1, k] = beta.to(B.dtype)
        k += 1

    # ---- tail step (k = m-1): both half-steps in plain operations; the
    # domain apply A·v counts (1 op), the adjoint apply is skipped ----
    b_k = bcur(scU, k)
    go = k == m - 1 and float(b_k) > btol
    if go:
        lamU, LUk, cD = domain_coeffs(scU, scV, B, k)
        W = lamU * y_d - bs.unproject_bucketed(V, cD, k)
        qV = torch.sum(W * W)
        alpha = torch.sqrt(qV)
        V[k] = W
        scV, lamV = _correct_col(scV, torch.zeros(kmax, dtype=f32, device=W.device), qV, k)
        y_c = op.normal(W)
        cC = codomain_coeffs(scV, LUk, alpha, k)
        S = lamV * y_c - bs.unproject_bucketed(U, cC, k + 1)
        beta_m = torch.sqrt(torch.sum(S * S))
        U[k + 1] = S
        # placeholder (uncorrected) column for the tail row of U
        ohk1 = (idx == k + 1).to(f32)
        s_inv = kf._safe_inv(beta_m)
        scU = dataclasses.replace(
            scU, L=_set_col(scU.L, s_inv * ohk1, k + 1),
            s=torch.where(idx == k + 1, s_inv, scU.s))
        B[k, k] = alpha.to(B.dtype)
        B[k + 1, k] = beta_m.to(B.dtype)
        beta_out = beta_m
        k += 1
    else:
        beta_out = b_k
    state_new = GKLState(U, V, B, k, beta_out.to(state.beta.dtype))
    return state_new, scU, scV, 2 * (k - k0)
