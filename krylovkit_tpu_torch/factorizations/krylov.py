"""Krylov factorization state and expansion steps (counterpart of
``krylovkit_tpu/factorizations/krylov.py``).

Contract (reference ``src/factorizations/krylov.jl:30-62``): after ``k``
steps ``A V[:, :k] = V[:, :k+1] @ H[:k+1, :k]`` with ``H[k, k-1] = β``.  The
basis is a static ``(m+1,) + x.shape`` buffer and ``H`` a static
``(m+1, m+1)`` buffer, as in the JAX package; ``k`` is a host ``int`` and the
loops are plain Python.  Buffers are updated in place.

The fused section drives the one-stream expansion kernel
(``ops/fused_lanczos.py``): stored basis rows are raw residuals and the
true basis is ``v_j = Σ_i L[i, j] R_i`` (:class:`FusedScales`).  Its
``dgks`` mode is the one-reduce CGS2 of the JAX package: the second
Gram-Schmidt sweep is deferred and applied in scalar space one step later.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..info import EACHITERATION, log_if, warn_if
from ..ops import basis as bs
from ..ops import fused_lanczos as fl
from ..ops import orthonormal as on
from ..ops.vector import STANDARD, VectorSpace

__all__ = [
    "KrylovState",
    "initialize",
    "expand",
    "expand_hermitian",
    "fused_available",
    "FusedScales",
    "fused_scales_init",
    "fold_scales",
    "make_fused_stepper",
    "fused_expansions",
]


@dataclasses.dataclass
class KrylovState:
    """Factorization state: basis buffer, projected matrix, size, ``‖r‖``."""

    V: torch.Tensor  # (m+1,) + x.shape
    H: torch.Tensor  # (m+1, m+1)
    k: int
    beta: torch.Tensor  # 0-d, real


def initialize(x0: torch.Tensor, m: int, coeff_dtype, space: VectorSpace = STANDARD,
               vec_dtype=None, verbosity: int = 0) -> KrylovState:
    """``V[0] = x0/‖x0‖`` in a fresh ``(m+1)``-row basis (reference
    ``initialize``, ``src/factorizations/lanczos.jl:180-249``).  A zero-norm
    ``x0`` gives a NaN row, so every residual test fails and
    ``converged == 0``; a WARN-level message says so."""
    if vec_dtype is not None:
        x0 = x0.to(vec_dtype)
    nrm = space.norm(x0)
    warn_if(
        verbosity, nrm == 0,
        "[krylovkit_tpu] starting vector x0 has zero norm: results are NaN "
        "and converged = 0",
    )
    v0 = x0 / nrm.to(x0.dtype)
    V = bs.alloc(v0, m + 1)
    V[0] = v0
    H = torch.zeros((m + 1, m + 1), dtype=coeff_dtype, device=x0.device)
    beta = torch.ones((), dtype=coeff_dtype.to_real(), device=x0.device)
    return KrylovState(V, H, 0, beta)


def expand(op_apply, state: KrylovState, orth: on.Orthogonalizer,
           space: VectorSpace = STANDARD, verbosity: int = 0) -> KrylovState:
    """One Krylov step: ``w = A V[k]``, orthonormalize against ``V[:k+1]``,
    append (reference ``expand!``, ``src/factorizations/arnoldi.jl:199-219``)."""
    V, H, k = state.V, state.H, state.k
    w = op_apply(V[k])
    v_new, beta, c = on.orthonormalize(w, V, k + 1, orth, space)
    V[k + 1] = v_new
    H[:, k] = c.to(H.dtype)
    H[k + 1, k] = beta.to(H.dtype)
    log_if(
        verbosity, EACHITERATION + 1,
        "Krylov expansion to dimension {k}: subspace normres = {b}",
        k=k + 1, b=beta,
    )
    return KrylovState(V, H, k + 1, beta)


def expand_hermitian(op_apply, state: KrylovState, orth: on.Orthogonalizer,
                     space: VectorSpace = STANDARD, verbosity: int = 0) -> KrylovState:
    """Hermitian Lanczos step (reference ``lanczosrecurrence``,
    ``src/factorizations/lanczos.jl:295-376``).

    Plain ``cgs``: one full projection sweep, ``α`` read from it.  Other
    orthogonalizers: the explicit 3-term subtraction, then ONE full drift
    sweep (cgs for cgs/cgs2, mgs for mgs/mgs2, else the orthogonalizer
    itself).  Column ``k`` of ``H`` gets ``α`` at ``k`` and ``β`` at
    ``k+1``; its other entries (the restart's arrowhead couplings) stay."""
    V, H, k, beta_prev = state.V, state.H, state.k, state.beta
    vk = V[k]
    w = op_apply(vk)
    if isinstance(orth, on.ClassicalGramSchmidt):
        v_new, beta, c = on.orthonormalize(w, V, k + 1, on.cgs, space)
        alpha = c[k]
    else:
        if k > 0:
            w = w - beta_prev.to(w.dtype) * V[k - 1]
        alpha = space.inner(vk, w)
        if torch.is_complex(alpha):
            # hermiticity check (reference src/factorizations/lanczos.jl:172-178)
            eps = torch.finfo(alpha.real.dtype).eps
            htol = eps ** 0.75
            warn_if(
                verbosity,
                torch.abs(alpha.imag) > htol * torch.clamp(torch.abs(alpha), min=1),
                "Lanczos iteration: operator does not appear to be hermitian: "
                "imag(alpha) = {ia}",
                ia=alpha.imag,
            )
        w = w - alpha.to(w.dtype) * vk
        if isinstance(orth, (on.ClassicalGramSchmidt, on.ClassicalGramSchmidt2)):
            sweep_orth = on.cgs
        elif isinstance(orth, (on.ModifiedGramSchmidt, on.ModifiedGramSchmidt2)):
            sweep_orth = on.mgs
        else:
            sweep_orth = orth
        v_new, beta, _ = on.orthonormalize(w, V, k + 1, sweep_orth, space)
    V[k + 1] = v_new
    H[k, k] = alpha.to(H.dtype)
    H[k + 1, k] = beta.to(H.dtype)
    log_if(
        verbosity, EACHITERATION + 1,
        "Lanczos expansion to dimension {k}: subspace normres = {b}",
        k=k + 1, b=beta,
    )
    return KrylovState(V, H, k + 1, beta)


# --------------------------------------------------------------------------
# Fused expansion loop (stencil operators, single (R, 128) float32 vectors)
# --------------------------------------------------------------------------

def fused_available(op, x0: torch.Tensor, space: VectorSpace, kmax=None) -> bool:
    """Eligibility of the one-stream fused expansion: a fusable stencil
    operator (``fl.spec_for``), an ``(R, 128)`` float32 vector with
    ``R % 8 == 0`` and ``R >= 16`` (a grid vector covers its grid exactly),
    the standard inner product, ``kmax + 2 <= 128``, and a vector on a CUDA
    device (the kernel) or on the CPU (its plain version)."""
    if kmax is not None and kmax + 2 > fl.LANES:
        return False
    spec = fl.spec_for(op)
    if spec is None or space.inner_fn is not None:
        return False
    if x0.ndim != 2 or x0.shape[1] != fl.LANES or x0.dtype != torch.float32:
        return False
    R = x0.shape[0]
    if R % 8 != 0 or R < 16:
        return False
    if spec.gc and R * fl.LANES != spec.gr * spec.gc:
        return False
    try:
        fl.choose_tile(R, h=spec.h)
    except ValueError:
        return False
    return x0.device.type in ("cuda", "cpu")


def _safe_inv(x):
    pos = x > 0
    return torch.where(pos, 1.0 / torch.where(pos, x, torch.ones_like(x)), torch.ones_like(x))


@dataclasses.dataclass
class FusedScales:
    """Scalar-space bookkeeping of the fused expansion: ``L`` (true basis
    coefficients, upper triangular), ``s`` (inverse stored-row norms),
    ``Hs`` (stored-row images, dgks mode) and ``M`` (stored-row Gram from the
    kernel's drift reductions, dgks mode).  All ``float32``."""

    L: torch.Tensor
    s: torch.Tensor
    Hs: torch.Tensor
    M: torch.Tensor


def fused_scales_init(kmax: int, H: Optional[torch.Tensor] = None,
                      device=None) -> FusedScales:
    """Identity bookkeeping; ``H`` seeds the stored-row Hessenberg after a
    thick restart."""
    if H is not None:
        device = H.device
    eye = torch.eye(kmax, dtype=torch.float32, device=device)
    Hs = (torch.zeros((kmax, kmax), dtype=torch.float32, device=device) if H is None
          else torch.real(H).to(torch.float32))
    return FusedScales(eye, torch.ones(kmax, dtype=torch.float32, device=device), Hs, eye)


def fold_scales(sc: FusedScales, coeffs: torch.Tensor) -> torch.Tensor:
    """True-basis coefficients → stored-row coefficients: ``L @ c``."""
    return (sc.L.to(coeffs.dtype) @ coeffs).to(coeffs.dtype)


def _step_coeffs(r, d, rp, q, sc: FusedScales, k: int, dgks: bool):
    """Scalar front half of one fused step at top row ``k``: clean the
    measured reductions, apply the deferred DGKS correction of row ``k``
    (dgks mode) and build the subtraction coefficients.  The math is the
    JAX package's ``_step_coeffs``; masks keep every vector ``kmax`` long."""
    kmax = sc.L.shape[0]
    idx = torch.arange(kmax, device=r.device)
    L, s, Hs, M = sc.L, sc.s, sc.Hs, sc.M
    r = torch.where(idx == k, rp, r)
    r = torch.where(idx <= k, r, 0.0)
    sk = _safe_inv(torch.sqrt(q))
    s = torch.where(idx == k, sk, s)
    ohk = (idx == k).to(torch.float32)
    if dgks:
        d = torch.where(idx == k, q, d)
        d = torch.where(idx <= k, d, 0.0)
        M = M * (1 - ohk)[None, :] + d[:, None] * ohk[None, :]
        M = M * (1 - ohk)[:, None] + d[None, :] * ohk[:, None]
        c2 = sk * (L.T @ d)
        c2 = torch.where(idx < k, c2, 0.0)
        N = 1.0 / torch.sqrt(torch.clamp(1.0 - torch.sum(c2 * c2), min=0.25))
        Lcol = N * (sk * ohk - L @ c2)
        lam = N * sk
    else:
        Lcol = sk * ohk
        lam = sk
    Lcol = torch.where(idx <= k, Lcol, 0.0)
    L = L * (1 - ohk)[None, :] + Lcol[:, None] * ohk[None, :]
    if dgks:
        u = Hs @ torch.where(idx < k, Lcol, 0.0)
        h = lam * (L.T @ r) + L.T @ (M @ u)
    else:
        u = torch.zeros_like(r)
        h = lam * (L.T @ r)
    h = torch.where(idx <= k, h, 0.0)
    csub = torch.where(idx <= k, L @ h - u, 0.0)
    return csub, lam, h, h[k], FusedScales(L, s, Hs, M)


class FusedCarry(NamedTuple):
    """State of the fused stepper between steps."""

    V: torch.Tensor  # basis, rows stored unnormalized
    y: torch.Tensor  # A R_k
    r: torch.Tensor  # (kmax,) <R_j, y>
    d: torch.Tensor  # (kmax,) drift <R_j, R_k> (dgks)
    rp: torch.Tensor  # <R_k, y>
    q: torch.Tensor  # ‖R_k‖²
    sc: FusedScales
    k: int


def make_fused_stepper(op, kmax: int, dgks: bool, space: VectorSpace):
    """Return ``(prime, advance, tail)`` over a :class:`FusedCarry`.
    ``dgks=True`` is the one-reduce CGS2 mode; it needs ``2·kmax + 2 <= 128``."""
    spec = fl.spec_for(op)
    if spec is None:
        raise ValueError("make_fused_stepper requires a fusable stencil operator")

    def prime(V, k0: int, sc: FusedScales) -> FusedCarry:
        """``y = A R_{k0}`` and its projections; the priming norm comes from
        the scale vector."""
        y = op.normal(V[k0])
        r = bs.project_bucketed(V, y, k0 + 1, space).to(torch.float32)
        q = _safe_inv(sc.s[k0]) ** 2
        d = torch.zeros(kmax, dtype=torch.float32, device=V.device)
        return FusedCarry(V, y, r, d, r[k0], q, sc, k0)

    def advance(c: FusedCarry):
        """One fused step (scalar front half + kernel + bookkeeping).
        Returns ``(carry', alpha, beta_new)``."""
        k = c.k
        csub, lam, _, alpha, sc = _step_coeffs(c.r, c.d, c.rp, c.q, c.sc, k, dgks)
        g = torch.cat([csub, lam[None]])
        B = k + 1  # live rows: row k+1 (written) is never read
        yn, raw = fl.fused_step(c.V, c.y, g, k + 1, B, spec, with_drift=dgks)
        pad = (0, kmax - B)
        rn = torch.nn.functional.pad(raw[:B], pad)
        if dgks:
            dn = torch.nn.functional.pad(raw[B:2 * B], pad)
            rpn, qn = raw[2 * B], raw[2 * B + 1]
        else:
            dn = torch.zeros(kmax, dtype=torch.float32, device=raw.device)
            rpn, qn = raw[B], raw[B + 1]
        beta = torch.sqrt(qn)
        sc = _append_row(sc, k, beta, csub, lam, dgks)
        return FusedCarry(c.V, yn, rn, dn, rpn, qn, sc, k + 1), alpha, beta

    def _append_row(sc: FusedScales, k: int, beta, csub, lam, with_hs: bool):
        idx = torch.arange(kmax, device=beta.device)
        ohk1 = (idx == k + 1).to(torch.float32)
        s = torch.where(idx == k + 1, _safe_inv(beta), sc.s)
        # placeholder L column for the new row (its deferred correction
        # overwrites it next step)
        L = sc.L * (1 - ohk1)[None, :] + (_safe_inv(beta) * ohk1)[:, None] * ohk1[None, :]
        Hs = sc.Hs
        if with_hs:
            # stored-row image of R_k: y = (R_{k+1} + Σ csub_i R_i)/λ
            hscol = torch.where(idx <= k + 1, (ohk1 + csub) / lam, 0.0)
            ohk = (idx == k).to(torch.float32)
            Hs = Hs * (1 - ohk)[None, :] + hscol[:, None] * ohk[None, :]
        return FusedScales(L, s, Hs, sc.M)

    def tail(c: FusedCarry, go: bool):
        """Final append WITHOUT the next operator apply, only when ``go``.
        Returns ``(V, scales', alpha, beta)``; with ``go`` false the basis
        and scales are unchanged and ``alpha``/``beta`` are ``None``."""
        if not go:
            return c.V, c.sc, None, None
        k = c.k
        csub, lam, _, alpha, sc = _step_coeffs(c.r, c.d, c.rp, c.q, c.sc, k, dgks)
        W = lam * c.y - bs.unproject_bucketed(c.V, csub, k + 1)
        beta = torch.sqrt(torch.sum(W * W))
        c.V[k + 1] = W
        return c.V, _append_row(sc, k, beta, csub, lam, False), alpha, beta

    return prime, advance, tail


def _h_column(H, k: int, alpha, beta):
    """Column ``k`` of ``H``: ``α`` at ``k`` and ``β`` at ``k+1``."""
    H[k, k] = alpha.to(H.dtype)
    H[k + 1, k] = beta.to(H.dtype)
    return H


def fused_expansions(op, state: KrylovState, scales: FusedScales, m: int, btol: float,
                     space: VectorSpace, dgks: bool = False):
    """Expand ``state`` from ``k`` to ``m`` with the one-stream fused kernel.

    Rows appended here are stored unnormalized; the returned
    :class:`FusedScales` must be folded into every later basis use.  Per
    restart cycle this makes exactly ``m - k`` operator applications (one
    priming apply + one in-kernel apply per fused step, none in the tail),
    the unfused loop's ``numops``.  The loop test ``‖R_k‖ > btol`` reads one
    scalar from the device per step.  (The JAX package's Arnoldi column
    writes and ``min_one`` re-entry serve drivers not ported yet.)

    Returns ``(state_new, scales_new, numops_increment)``."""
    V, H, k0 = state.V, state.H, state.k
    kmax = H.shape[0]
    prime, advance, tail = make_fused_stepper(op, kmax, dgks, space)
    c = prime(V, k0, scales)

    def going(c):
        return float(torch.sqrt(c.q)) > btol

    while c.k < m - 1 and going(c):
        k = c.k
        c, alpha, beta_k = advance(c)
        H = _h_column(H, k, alpha, beta_k)

    k = c.k
    go = k == m - 1 and going(c)
    V, sc, alpha, beta_m = tail(c, go)
    if go:
        H = _h_column(H, k, alpha, beta_m)
        beta_out = beta_m
    else:
        beta_out = torch.sqrt(c.q)
    state_new = KrylovState(V, H, k + int(go), beta_out.to(state.beta.dtype))
    return state_new, sc, (k - k0) + 1
