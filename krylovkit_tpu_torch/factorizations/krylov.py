"""Krylov factorization state and expansion steps (counterpart of
``krylovkit_tpu/factorizations/krylov.py``).

Contract (reference ``src/factorizations/krylov.jl:30-62``): after ``k``
steps ``A V[:, :k] = V[:, :k+1] @ H[:k+1, :k]`` with ``H[k, k-1] = β``.  The
basis is a static ``(m+1,) + x.shape`` buffer and ``H`` a static
``(m+1, m+1)`` buffer, as in the JAX package; ``k`` is a host ``int`` and the
loops are plain Python.  Buffers are updated in place.  The unfused steps
take pytree vectors (``ops/vector.py``); the fused ones take one tensor.

The fused section drives the one-stream expansion kernel
(``ops/fused_lanczos.py``): stored basis rows are raw residuals and the
true basis is ``v_j = Σ_i L[i, j] R_i`` (:class:`FusedScales`).  Its
``dgks`` mode is the one-reduce CGS2 of the JAX package: the second
Gram-Schmidt sweep is deferred and applied in scalar space one step later.
On a sharded space (``psum_axis``) each rank runs the kernel on its block of
rows with the neighbours' edge rows as external halos, and one all-reduce
per step finishes the kernel's reductions and brings the new row's and
``y'``'s edge rows (the JAX package's ``psum`` and ``_edge_fix``); the
batched stepper does the same for ``P`` problems, each with its own halos,
in one batched launch and one all-reduce a step.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..info import EACHITERATION, log_if, warn_if
from ..ops import basis as bs
from ..ops import fused_lanczos as fl
from ..ops import orthonormal as on
from ..ops.vector import (STANDARD, VectorSpace, astype, device_of, inner_batched, norm_batched,
                          psum, tree_map)

__all__ = [
    "KrylovState",
    "Lanczos3State",
    "initialize",
    "normalized_batched",
    "initialize_3term",
    "expand",
    "expand_hermitian",
    "expand_batched",
    "expand_hermitian_selective",
    "expand_hermitian_selective_batched",
    "expand_3term",
    "fused_available",
    "fused_available_batched",
    "check_sharded_blocks",
    "FusedScales",
    "fused_scales_init",
    "fold_scales",
    "make_fused_stepper",
    "fused_expansions",
    "make_fused_stepper_batched",
    "fused_expansions_batched",
]


@dataclasses.dataclass
class KrylovState:
    """Factorization state: basis buffer, projected matrix, size, ``‖r‖``."""

    V: object  # (m+1,) + x.shape, leaf by leaf
    H: torch.Tensor  # (m+1, m+1)
    k: int
    beta: torch.Tensor  # 0-d, real


ZERO_START = ("[krylovkit_tpu] starting vector x0 has zero norm: results are NaN "
              "and converged = 0")


def initialize(x0, m: int, coeff_dtype, space: VectorSpace = STANDARD,
               vec_dtype=None, verbosity: int = 0) -> KrylovState:
    """``V[0] = x0/‖x0‖`` in a fresh ``(m+1)``-row basis (reference
    ``initialize``, ``src/factorizations/lanczos.jl:180-249``).  A zero-norm
    ``x0`` gives a NaN row, so every residual test fails and
    ``converged == 0``; a WARN-level message says so."""
    if vec_dtype is not None:
        x0 = astype(x0, vec_dtype)
    nrm = space.norm(x0)
    warn_if(verbosity, nrm == 0, ZERO_START)
    v0 = tree_map(lambda l: l / nrm.to(l.dtype), x0)
    V = bs.set(bs.alloc(v0, m + 1), 0, v0)
    dev = device_of(x0)
    H = torch.zeros((m + 1, m + 1), dtype=coeff_dtype, device=dev)
    beta = torch.ones((), dtype=coeff_dtype.to_real(), device=dev)
    return KrylovState(V, H, 0, beta)


def normalized_batched(x0s, space: VectorSpace = STANDARD, vec_dtype=None,
                       verbosity: int = 0) -> list:
    """``x0s[p]/‖x0s[p]‖`` for every start of a batch (tensors or pytrees),
    each the row 0 that :func:`initialize` makes of it, with its WARN line
    for a zero norm, in order; the norms are one ``norm_batched`` (on a
    sharded space one all-reduce for all)."""
    if vec_dtype is not None:
        x0s = [astype(x, vec_dtype) for x in x0s]
    out = []
    for x, nrm in zip(x0s, norm_batched(x0s, space)):
        warn_if(verbosity, nrm == 0, ZERO_START)
        out.append(tree_map(lambda l: l / nrm.to(l.dtype), x))
    return out


def expand(op_apply, state: KrylovState, orth: on.Orthogonalizer,
           space: VectorSpace = STANDARD, verbosity: int = 0) -> KrylovState:
    """One Krylov step: ``w = A V[k]``, orthonormalize against ``V[:k+1]``,
    append (reference ``expand!``, ``src/factorizations/arnoldi.jl:199-219``)."""
    V, k = state.V, state.k
    w = op_apply(bs.get(V, k))
    v_new, beta, c = on.orthonormalize(w, V, k + 1, orth, space)
    return _arnoldi_append(state, v_new, beta, c, verbosity)


def _arnoldi_append(state: KrylovState, v_new, beta, c, verbosity: int) -> KrylovState:
    V, H, k = state.V, state.H, state.k
    bs.set(V, k + 1, v_new)
    H[:, k] = c.to(H.dtype)
    H[k + 1, k] = beta.to(H.dtype)
    log_if(
        verbosity, EACHITERATION + 1,
        "Krylov expansion to dimension {k}: subspace normres = {b}",
        k=k + 1, b=beta,
    )
    return KrylovState(V, H, k + 1, beta)


def _lanczos_front(w, state: KrylovState, orth: on.Orthogonalizer, space: VectorSpace,
                   verbosity: int):
    """The part of a Hermitian Lanczos step before its drift sweep, for an
    orthogonalizer other than plain cgs: the explicit 3-term subtraction and
    ``α``.  Returns ``(w, α, the drift sweep's orthogonalizer)``."""
    V, k, beta_prev = state.V, state.k, state.beta
    vk = bs.get(V, k)
    if k > 0:
        w = tree_map(lambda a, b: a - beta_prev.to(a.dtype) * b, w, bs.get(V, k - 1))
    alpha = space.inner(vk, w)
    _check_hermitian(alpha, verbosity)
    w = tree_map(lambda a, b: a - alpha.to(a.dtype) * b, w, vk)
    return w, alpha, _drift_sweep(orth)


def _check_hermitian(alpha, verbosity: int) -> None:
    """Warn when a complex ``α`` is not real to ``eps^0.75`` (reference
    ``src/factorizations/lanczos.jl:172-178``)."""
    if torch.is_complex(alpha):
        eps = torch.finfo(alpha.real.dtype).eps
        warn_if(
            verbosity,
            torch.abs(alpha.imag) > eps ** 0.75 * torch.clamp(torch.abs(alpha), min=1),
            "Lanczos iteration: operator does not appear to be hermitian: "
            "imag(alpha) = {ia}",
            ia=alpha.imag,
        )


def _drift_sweep(orth: on.Orthogonalizer) -> on.Orthogonalizer:
    """The one full drift sweep of a Lanczos step after its 3-term part:
    cgs for cgs/cgs2, mgs for mgs/mgs2, else the orthogonalizer itself."""
    if isinstance(orth, (on.ClassicalGramSchmidt, on.ClassicalGramSchmidt2)):
        return on.cgs
    if isinstance(orth, (on.ModifiedGramSchmidt, on.ModifiedGramSchmidt2)):
        return on.mgs
    return orth


def _lanczos_front_batched(W: dict, states: dict, orth: on.Orthogonalizer,
                           space: VectorSpace, verbosity: int):
    """:func:`_lanczos_front` of every problem of ``W`` (``{p: w}``, tensor
    or pytree vectors), each with its one-problem bits, the ``α`` of all
    from one :func:`~..ops.vector.inner_batched` (one all-reduce on a
    sharded space).  Returns ``({p: w}, {p: α}, the drift sweep's
    orthogonalizer)``."""
    ps = list(W)
    vks = {p: bs.get(states[p].V, states[p].k) for p in ps}
    for p in ps:
        st = states[p]
        if st.k > 0:
            W[p] = tree_map(lambda a, b: a - st.beta.to(a.dtype) * b, W[p],
                            bs.get(st.V, st.k - 1))
    alphas = inner_batched([vks[p] for p in ps], [W[p] for p in ps], space)
    out_w, out_a = {}, {}
    for p, alpha in zip(ps, alphas):
        _check_hermitian(alpha, verbosity)
        out_w[p] = tree_map(lambda a, b: a - alpha.to(a.dtype) * b, W[p], vks[p])
        out_a[p] = alpha
    return out_w, out_a, _drift_sweep(orth)


def _lanczos_append(state: KrylovState, v_new, alpha, beta, verbosity: int) -> KrylovState:
    V, H, k = state.V, state.H, state.k
    bs.set(V, k + 1, v_new)
    H[k, k] = alpha.to(H.dtype)
    H[k + 1, k] = beta.to(H.dtype)
    log_if(
        verbosity, EACHITERATION + 1,
        "Lanczos expansion to dimension {k}: subspace normres = {b}",
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
    V, k = state.V, state.k
    w = op_apply(bs.get(V, k))
    if isinstance(orth, on.ClassicalGramSchmidt):
        v_new, beta, c = on.orthonormalize(w, V, k + 1, on.cgs, space)
        alpha = c[k]
    else:
        w, alpha, sweep_orth = _lanczos_front(w, state, orth, space, verbosity)
        v_new, beta, _ = on.orthonormalize(w, V, k + 1, sweep_orth, space)
    return _lanczos_append(state, v_new, alpha, beta, verbosity)


def expand_batched(apply, states: dict, orth: on.Orthogonalizer, space: VectorSpace = STANDARD,
                   verbosity: int = 0, hermitian: bool = False) -> dict:
    """One :func:`expand` (or, ``hermitian``, :func:`expand_hermitian`) step
    of every problem in ``states`` (``{p: KrylovState}``) at once, each at
    its own ``k``: ``apply({p: x_p})`` gives ``{p: A_p x_p}`` for all of
    them (one call, e.g. one batched operator launch), then the
    orthonormalizations run through :func:`~..ops.orthonormal.orthonormalize_batched`
    (a cgs or cgs2 sweep: one batched project and one batched unproject for
    all).  Each problem's new state is its one-problem step's.  On a
    sharded space every reduction of the step is one all-reduce for all the
    problems.  Returns ``{p: KrylovState}``."""
    ps = list(states)
    W = apply({p: bs.get(states[p].V, states[p].k) for p in ps})
    alphas, sweep_orth = {}, orth
    if hermitian:
        sweep_orth = on.cgs
        if not isinstance(orth, on.ClassicalGramSchmidt):
            W, alphas, sweep_orth = _lanczos_front_batched(W, states, orth, space, verbosity)
    outs = on.orthonormalize_batched([W[p] for p in ps], [states[p].V for p in ps],
                                     [states[p].k + 1 for p in ps], sweep_orth, space)
    new = {}
    for p, (v_new, beta, c) in zip(ps, outs):
        st = states[p]
        if hermitian:
            alpha = alphas[p] if p in alphas else c[st.k]
            new[p] = _lanczos_append(st, v_new, alpha, beta, verbosity)
        else:
            new[p] = _arnoldi_append(st, v_new, beta, c, verbosity)
    return new


def _normalized(w, beta):
    """``w/β``, or zero where ``β == 0`` (breakdown)."""
    safe = torch.where(beta > 0, beta, torch.ones_like(beta))
    return tree_map(lambda l: torch.where(beta > 0, l / safe.to(l.dtype), 0 * l), w)


@dataclasses.dataclass
class Lanczos3State:
    """O(1)-vector-memory pure 3-term Lanczos state (``keepvecs=false``).

    The reference's ``keepvecs=false`` mode keeps only the rolling pair
    ``(v_{k-1}, v_k)`` (``src/factorizations/lanczos.jl:133-144``); it is
    legal only without reorthogonalization (``lanczos.jl:137-141``).  The
    tridiagonal coefficients still fill the ``(m+1, m+1)`` buffer ``H``."""

    v_prev: object  # v_{k-1}
    v_cur: object  # v_k (the residual direction)
    H: torch.Tensor  # (m+1, m+1), tridiagonal in the lower triangle
    k: int
    beta: torch.Tensor  # 0-d, real: ‖residual‖ of the last step


def initialize_3term(x0, m: int, coeff_dtype, space: VectorSpace = STANDARD,
                     verbosity: int = 0) -> Lanczos3State:
    """``v_0 = x0/‖x0‖`` with no stored basis (reference ``keepvecs=false``
    initialize, ``src/factorizations/lanczos.jl:184-207``)."""
    nrm = space.norm(x0)
    warn_if(
        verbosity, nrm == 0,
        "[krylovkit_tpu] starting vector x0 has zero norm: results are NaN "
        "and converged = 0",
    )
    v0 = tree_map(lambda l: l / nrm.to(l.dtype), x0)
    dev = device_of(x0)
    H = torch.zeros((m + 1, m + 1), dtype=coeff_dtype, device=dev)
    beta = torch.ones((), dtype=coeff_dtype.to_real(), device=dev)
    return Lanczos3State(tree_map(torch.zeros_like, v0), v0, H, 0, beta)


def expand_3term(op_apply, state: Lanczos3State, space: VectorSpace = STANDARD) -> Lanczos3State:
    """One pure 3-term step ``w = A v_k − β_{k-1} v_{k-1} − α_k v_k`` with no
    reorthogonalization (reference ``lanczosrecurrence`` for plain cgs/mgs,
    ``src/factorizations/lanczos.jl:295-328``).  ``H`` gets ``α`` at
    ``[k, k]`` and ``β`` at ``[k+1, k]``, the lower-triangle convention of
    :func:`expand_hermitian`."""
    v_prev, v_cur, H, k = state.v_prev, state.v_cur, state.H, state.k
    w = op_apply(v_cur)
    if k > 0:
        w = tree_map(lambda a, b: a - state.beta.to(a.dtype) * b, w, v_prev)
    alpha = space.inner(v_cur, w)
    w = tree_map(lambda a, b: a - alpha.to(a.dtype) * b, w, v_cur)
    beta = space.norm(w)
    H[k, k] = alpha.to(H.dtype)
    H[k + 1, k] = beta.to(H.dtype)
    return Lanczos3State(v_cur, _normalized(w, beta), H, k + 1, beta)


def expand_hermitian_selective(op_apply, state: KrylovState, omega: torch.Tensor,
                               omega_prev: torch.Tensor, orth: on.Orthogonalizer,
                               space: VectorSpace = STANDARD, force_sweep: bool = False):
    """Hermitian Lanczos step with partial reorthogonalization.

    Simon's ω-recurrence (H. D. Simon, *The Lanczos algorithm with partial
    reorthogonalization*, Math. Comp. 42 (1984)) estimates ``|⟨v_j,
    v_{k+1}⟩|`` from the tridiagonal coefficients alone; the drift sweep (one
    plain cgs sweep against ``V[:k+1]``) runs only when ``max_{j<k} ω_j >
    sqrt(eps)`` or ``force_sweep``.  The test is one host read per step.  No
    reference counterpart: the JAX package's opt-in
    ``Lanczos(reorth="selective")``.  ``omega``/``omega_prev`` are real
    ``(m+1,)`` tensors on the vectors' device.

    Returns ``(state, omega_new, omega, swept)``."""
    V, k = state.V, state.k
    vk = bs.get(V, k)
    w = _three_term(op_apply(vk), state)
    alpha = space.inner(vk, w)
    w = tree_map(lambda a, b: a - alpha.to(a.dtype) * b, w, vk)
    om_new, test = _omega_step(state, omega, omega_prev, alpha, space.norm(w))
    swept = bool(force_sweep) or bool(test)
    if swept:
        w, _ = on.orthogonalize(w, V, k + 1, on.cgs, space)
    return _selective_append(state, w, space.norm(w), alpha, om_new, omega, swept)


def _three_term(w, state: KrylovState):
    """``w − β_{k−1}·v_{k−1}`` (``w`` itself at ``k = 0``)."""
    if state.k == 0:
        return w
    beta_prev = state.beta
    return tree_map(lambda a, b: a - beta_prev.to(a.dtype) * b, w, bs.get(state.V, state.k - 1))


def _omega_step(state: KrylovState, omega, omega_prev, alpha, beta_raw):
    """Simon's ω-recurrence for the would-be ``v_{k+1}`` against ``v_j``,
    ``j <= k``: ``(ω_new, test)``, ``test`` the 0-d device flag
    ``max_{j<k} ω_j > sqrt(eps)``."""
    H, k, beta_prev = state.H, state.k, state.beta
    m1 = H.shape[0]
    rdt = omega.dtype
    dev = omega.device
    eps = torch.finfo(rdt).eps
    bcoef = beta_prev.to(rdt) if k > 0 else torch.zeros((), dtype=rdt, device=dev)
    alphas = torch.real(torch.diagonal(H)).to(rdt)  # α_j at [j, j]
    betas = torch.abs(torch.cat([torch.diagonal(H, -1), H.new_zeros(1)])).to(rdt)  # β_j at [j+1, j]
    a_k = torch.real(alpha).to(rdt)
    b_k = torch.clamp(beta_raw.to(rdt), min=eps)
    idx = torch.arange(m1, device=dev)
    scale_n = torch.clamp(torch.abs(a_k) + b_k + bcoef, min=1.0)
    theta = eps * (betas + b_k) / b_k + eps * scale_n / b_k
    om_new = (
        betas * torch.roll(omega, -1)
        + (alphas - a_k) * omega
        + torch.roll(betas, 1) * torch.roll(omega, 1)
        - bcoef * omega_prev
    ) / b_k + theta
    om_new = torch.abs(om_new)
    # boundary values: ω_{k+1,k} at the eps level, ω_{k+1,k+1} = 1, zero beyond
    om_new = torch.where(idx == k, eps * scale_n / b_k, om_new)
    om_new = torch.where(idx == k + 1, torch.ones_like(om_new), om_new)
    om_new = torch.where(idx > k + 1, torch.zeros_like(om_new), om_new)
    # (a sweep is also forced on the first expansion after a thick restart:
    # the arrowhead spike gives A·v_keep components along every kept Ritz
    # vector, which the 3-term recurrence does not remove and the
    # ω-recurrence does not model)
    test = torch.max(torch.where(idx < k, om_new, torch.zeros_like(om_new))) > eps ** 0.5
    return om_new, test


def _selective_append(state: KrylovState, w, beta, alpha, om_new, omega, swept: bool):
    """The end of a selective step: ``v_{k+1} = w/β`` and ``(α, β)`` into
    ``H``; after a sweep the basis is orthogonal to the eps level again.
    Returns ``(state, omega_new, omega, swept)``."""
    V, H, k = state.V, state.H, state.k
    if swept:
        eps = torch.finfo(omega.dtype).eps
        idx = torch.arange(H.shape[0], device=omega.device)
        eps_row = torch.where(idx <= k, torch.full_like(omega, eps), torch.zeros_like(omega))
        om_out, om_cur = eps_row.clone(), eps_row
    else:
        om_out, om_cur = om_new, omega
    om_out[k + 1] = 1.0
    bs.set(V, k + 1, _normalized(w, beta))
    H[k, k] = alpha.to(H.dtype)
    H[k + 1, k] = beta.to(H.dtype)
    return KrylovState(V, H, k + 1, beta), om_out, om_cur, swept


def expand_hermitian_selective_batched(apply, states: dict, omegas: dict, force: dict,
                                       space: VectorSpace = STANDARD) -> dict:
    """:func:`expand_hermitian_selective` of every problem in ``states``
    (``{p: KrylovState}``) at once, each at its own ``k`` with its own ω
    state ``omegas[p] = (omega, omega_prev)`` and ``force[p]`` (its
    ``force_sweep``).  ``apply({p: x_p})`` gives ``{p: A_p x_p}`` in one
    call; the ``α`` and both norms of all problems are
    :func:`~..ops.vector.inner_batched`/``norm_batched`` (each one
    all-reduce on a sharded space), the ω-recurrence runs per problem on the
    device, the sweep decisions of all are one host read, and the problems
    that sweep go through one :func:`~..ops.orthonormal.orthogonalize_batched`
    cgs call (one batched project and one batched unproject with the
    projection flag on).  Each problem's ``(state, ω, ω_prev, swept)`` is
    its one-problem step's, bit for bit.  Returns ``{p: (state, omega_new,
    omega, swept)}``."""
    ps = list(states)
    vks = {p: bs.get(states[p].V, states[p].k) for p in ps}
    W = apply(vks)
    W = {p: _three_term(W[p], states[p]) for p in ps}
    alphas = inner_batched([vks[p] for p in ps], [W[p] for p in ps], space)
    for p, alpha in zip(ps, alphas):
        W[p] = tree_map(lambda a, b: a - alpha.to(a.dtype) * b, W[p], vks[p])
    raws = norm_batched([W[p] for p in ps], space)
    steps = {p: _omega_step(states[p], *omegas[p], alpha, raw)
             for p, alpha, raw in zip(ps, alphas, raws)}
    tests = torch.stack([steps[p][1] for p in ps]).tolist()
    swept = {p: bool(force[p]) or t for p, t in zip(ps, tests)}
    sweeping = [p for p in ps if swept[p]]
    if sweeping:
        outs = on.orthogonalize_batched([W[p] for p in sweeping], [states[p].V for p in sweeping],
                                        [states[p].k + 1 for p in sweeping], on.cgs, space)
        W.update({p: w for p, (w, _) in zip(sweeping, outs)})
    betas = norm_batched([W[p] for p in ps], space)
    return {p: _selective_append(states[p], W[p], beta, alpha, steps[p][0], omegas[p][0], swept[p])
            for p, alpha, beta in zip(ps, alphas, betas)}


# --------------------------------------------------------------------------
# Fused expansion loop (stencil operators, single (R, 128) float32 vectors)
# --------------------------------------------------------------------------

def fused_available(op, x0, space: VectorSpace, kmax=None) -> bool:
    """Eligibility of the one-stream fused expansion: a fusable stencil
    operator (``fl.spec_for``), one ``(R, 128)`` float32 tensor (never a
    pytree vector, as in the JAX package) with
    ``R % 8 == 0`` and ``R >= 16`` (a grid vector covers its grid exactly),
    the standard inner product, ``kmax + 2 <= 128``, and a vector on a CUDA
    device (the kernel) or on the CPU (its plain version).  On a sharded
    space ``x0`` is this rank's block: it must hold at least ``h`` rows (its
    halos come from the next rank alone), and a grid's blocks must cut whole
    grid rows, with the global row count (``R`` times the axis size)
    covering the grid."""
    if kmax is not None and kmax + 2 > fl.LANES:
        return False
    if not isinstance(x0, torch.Tensor):
        return False
    spec = fl.spec_for(op)
    if spec is None or space.inner_fn is not None:
        return False
    if x0.ndim != 2 or x0.shape[1] != fl.LANES or x0.dtype != torch.float32:
        return False
    R = x0.shape[0]
    if R % 8 != 0 or R < 16:
        return False
    nloc = R * fl.LANES
    if space.psum_axis is not None:
        if _rank_refusal(spec, R) is not None:
            return False
        nloc *= space.psum_axis.size
    if spec.gc and nloc != spec.gr * spec.gc:
        return False
    try:
        fl.choose_tile(R, h=spec.h)
    except ValueError:
        return False
    return x0.device.type in ("cuda", "cpu")


def _rank_refusal(spec, R: int) -> Optional[str]:
    """The per-rank rule of the fused gate that a sharded block of ``R``
    rows of 128 fails, or ``None``: its halos come from the next rank alone,
    and a grid's blocks cut whole grid rows."""
    if R < spec.h:
        return f"a block of {R} rows is shorter than the stencil's reach of {spec.h} rows"
    if spec.gc and (R * fl.LANES) % spec.gc != 0:
        return f"a block of {R} rows of {fl.LANES} does not cut whole grid rows of {spec.gc}"
    return None


def check_sharded_blocks(what: str, ops, xs, space: VectorSpace) -> None:
    """Raise where a batched solve on a sharded space meets a fusable
    stencil (``fl.spec_for``) and a ``(R, 128)`` block ``xs[p]`` that fails
    a per-rank rule of :func:`fused_available` (:func:`_rank_refusal`).
    Batched K1 cannot take such a block's halos, and a batched sharded
    solve does not step it otherwise without a word.  The other rules of the
    gate (dtype, ``R % 8``, ``kmax``) send it to the unfused lock-step, as
    they do an unsharded batched solve."""
    if space.psum_axis is None:
        return
    for op in ops:
        spec = fl.spec_for(op)
        if spec is None:
            continue
        for x in xs:
            if isinstance(x, torch.Tensor) and x.ndim == 2 and x.shape[1] == fl.LANES:
                why = _rank_refusal(spec, x.shape[0])
                if why is not None:
                    raise ValueError(f"{what}: on a sharded space {why}; batched K1 "
                                     "cannot take its halos")


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


def _unpack_raw(raw, B: int, kmax: int, dgks: bool):
    """The kernel's packed reductions at ``B`` live rows as ``(r, d, rp, q)``,
    ``r`` and ``d`` padded to ``kmax`` (``d`` zero without drift)."""
    pad = (0, kmax - B)
    rn = torch.nn.functional.pad(raw[:B], pad)
    if dgks:
        dn = torch.nn.functional.pad(raw[B:2 * B], pad)
        rpn, qn = raw[2 * B], raw[2 * B + 1]
    else:
        dn = torch.zeros(kmax, dtype=torch.float32, device=raw.device)
        rpn, qn = raw[B], raw[B + 1]
    return rn, dn, rpn, qn


def _append_row(sc: FusedScales, k: int, beta, csub, lam, with_hs: bool) -> FusedScales:
    """Bookkeeping of the new stored row ``k + 1`` of norm ``beta``."""
    idx = torch.arange(sc.L.shape[0], device=beta.device)
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
    Vext: Optional[torch.Tensor] = None  # (kmax, 2, h, 128) neighbours' edge rows
    yext: Optional[torch.Tensor] = None  # (2, h, 128), sharded spaces only


def _edge_rows(V, y, k0: int, h: int):
    """``(first, last)``: the first and the last ``h`` rows of the live basis
    rows ``V[:k0 + 1]`` and of ``y``, ``k0 + 2`` of each, what a sharded
    prime sends its neighbours."""
    return (torch.cat([V[:k0 + 1, :h], y[None, :h]]), torch.cat([V[:k0 + 1, -h:], y[None, -h:]]))


def _primed(V, y, r, k0: int, sc: FusedScales, above=None, below=None, Vext=None,
            yext=None) -> FusedCarry:
    """The carry of a primed problem, ``r`` its finished projections of
    ``y = A R_{k0}``; the priming norm comes from the scale vector.
    Sharded: the neighbours' edge rows ``above``/``below`` (laid out as
    :func:`_edge_rows` sends them) are written into the zero halo buffers
    ``Vext (kmax, 2, h, 128)`` and ``yext (2, h, 128)``."""
    r = r.to(torch.float32)
    q = _safe_inv(sc.s[k0]) ** 2
    d = torch.zeros_like(r)
    if above is not None:
        Vext[:k0 + 1, 0] = above[:k0 + 1]
        Vext[:k0 + 1, 1] = below[:k0 + 1]
        yext[0], yext[1] = above[k0 + 1], below[k0 + 1]
    return FusedCarry(V, y, r, d, r[k0], q, sc, k0, Vext, yext)


def _stepped(c: FusedCarry, front, raw, yn, dgks: bool, Vext, yext):
    """``(carry', alpha, beta, hcol)`` of a step from the front half
    ``front`` (:func:`_step_coeffs` of ``c``) and the kernel's finished
    reductions ``raw``."""
    csub, lam, hcol, alpha, sc = front
    rn, dn, rpn, qn = _unpack_raw(raw, c.k + 1, c.r.shape[0], dgks)
    beta = torch.sqrt(qn)
    sc = _append_row(sc, c.k, beta, csub, lam, dgks)
    return FusedCarry(c.V, yn, rn, dn, rpn, qn, sc, c.k + 1, Vext, yext), alpha, beta, hcol


def _exchange(ax, h: int, raws, rows, ys):
    """Sharded: one all-reduce of a zero-filled buffer sums the kernel's
    partial reductions ``raws[j]`` of each stepping problem and brings the
    neighbours' edge rows of its new basis row ``rows[j]`` and of its
    ``y'`` ``ys[j]``.  Returns the summed reductions and ``mine (n, 2, 2, h,
    128)``: problem ``j``'s rows from the rank above and below, of ``V`` at
    ``mine[j, :, 0]`` and of ``y'`` at ``mine[j, :, 1]``."""
    D, i = ax.size, ax.index
    width = max(r.numel() for r in raws)
    R = torch.zeros((len(raws), width), dtype=torch.float32, device=ys[0].device)
    slots = torch.zeros((D, len(raws), 2, 2, h, fl.LANES), dtype=torch.float32,
                        device=ys[0].device)
    for j, (raw, row, y) in enumerate(zip(raws, rows, ys)):
        R[j, :raw.numel()] = raw
        if i + 1 < D:
            slots[i + 1, j, 0, 0], slots[i + 1, j, 0, 1] = row[-h:], y[-h:]
        if i > 0:
            slots[i - 1, j, 1, 0], slots[i - 1, j, 1, 1] = row[:h], y[:h]
    total = ax.psum(torch.cat([R.reshape(-1), slots.reshape(-1)]))
    summed = total[:R.numel()].reshape(R.shape)
    mine = total[R.numel():].reshape(slots.shape)[i]
    return [summed[j, :r.numel()] for j, r in enumerate(raws)], mine


def _tail_front(c: FusedCarry, dgks: bool):
    """The local half of a tail: ``(W, front)``, the new row ``W`` (its norm
    still to be finished) and the step's front half."""
    front = _step_coeffs(c.r, c.d, c.rp, c.q, c.sc, c.k, dgks)
    csub, lam = front[0], front[1]
    return lam * c.y - bs.unproject_bucketed(c.V, csub, c.k + 1), front


def _tailed(c: FusedCarry, W, front, beta):
    """The tail's ``(V, scales', alpha, beta, hcol)``, ``W`` written as row
    ``k + 1``, ``beta`` its finished norm."""
    csub, lam, hcol, alpha, sc = front
    c.V[c.k + 1] = W
    return c.V, _append_row(sc, c.k, beta, csub, lam, False), alpha, beta, hcol


def make_fused_stepper(op, kmax: int, dgks: bool, space: VectorSpace):
    """Return ``(prime, advance, tail)`` over a :class:`FusedCarry`.
    ``dgks=True`` is the one-reduce CGS2 mode; it needs ``2·kmax + 2 <= 128``."""
    spec = fl.spec_for(op)
    if spec is None:
        raise ValueError("make_fused_stepper requires a fusable stencil operator")
    ax = space.psum_axis
    h = spec.h

    def prime(V, k0: int, sc: FusedScales) -> FusedCarry:
        """``y = A R_{k0}`` and its projections.  Sharded: the edge rows of
        the live basis rows and of ``y`` from the neighbours, in one
        all-reduce (after a restart rotation they are all new)."""
        y = op.normal(V[k0])
        r = bs.project_bucketed(V, y, k0 + 1, space)
        if ax is None:
            return _primed(V, y, r, k0, sc)
        above, below = ax.edges(*_edge_rows(V, y, k0, h))
        Vext = torch.zeros((kmax, 2, h, fl.LANES), dtype=torch.float32, device=V.device)
        yext = torch.zeros((2, h, fl.LANES), dtype=torch.float32, device=V.device)
        return _primed(V, y, r, k0, sc, above, below, Vext, yext)

    def advance(c: FusedCarry):
        """One fused step (scalar front half + kernel + bookkeeping).
        Returns ``(carry', alpha, beta_new, hcol)``: ``hcol`` is the full
        normalized-units projection column (``j <= k``; callers add ``β`` at
        ``k+1``)."""
        k = c.k
        front = _step_coeffs(c.r, c.d, c.rp, c.q, c.sc, k, dgks)
        g = torch.cat([front[0], front[1][None]])
        B = k + 1  # live rows: row k+1 (written) is never read
        yn, raw = fl.fused_step(c.V, c.y, g, k + 1, B, spec, with_drift=dgks,
                                Vext=c.Vext, yext=c.yext)
        Vext, yext = c.Vext, c.yext
        if ax is not None:
            (raw,), mine = _exchange(ax, h, [raw], [c.V[k + 1]], [yn])
            Vext[k + 1], yext = mine[0, :, 0], mine[0, :, 1].contiguous()
        return _stepped(c, front, raw, yn, dgks, Vext, yext)

    def tail(c: FusedCarry, go: bool):
        """Final append WITHOUT the next operator apply, only when ``go``.
        Returns ``(V, scales', alpha, beta, hcol)``; with ``go`` false the
        basis and scales are unchanged and the rest is ``None``."""
        if not go:
            return c.V, c.sc, None, None, None
        W, front = _tail_front(c, dgks)
        return _tailed(c, W, front, torch.sqrt(psum(torch.sum(W * W), ax)))

    return prime, advance, tail


def _h_column(H, k: int, alpha, beta, c=None):
    """Column ``k`` of ``H``: ``α`` at ``k`` and ``β`` at ``k+1``; other
    entries stay.  With ``c`` (the full projection coefficients of the
    normalized basis) the Arnoldi column: ``c[:k+1]`` above ``β``."""
    if c is None:
        H[k, k] = alpha.to(H.dtype)
    else:
        H[: k + 1, k] = c[: k + 1].to(H.dtype)
    H[k + 1, k] = beta.to(H.dtype)
    return H


def fused_expansions(op, state: KrylovState, scales: FusedScales, m: int, btol: float,
                     space: VectorSpace, hermitian: bool = True, min_one: bool = False,
                     dgks: bool = False):
    """Expand ``state`` from ``k`` to ``m`` with the one-stream fused kernel.

    Rows appended here are stored unnormalized; the returned
    :class:`FusedScales` must be folded into every later basis use.  Per
    restart cycle this makes exactly ``m - k`` operator applications (one
    priming apply + one in-kernel apply per fused step, none in the tail),
    the unfused loop's ``numops``.  The loop test ``‖R_k‖ > btol`` reads one
    scalar from the device per step.

    ``hermitian=False`` is the Arnoldi variant: the same stream, but the
    ``H`` column keeps the full projection coefficients (upper Hessenberg)
    instead of the tridiagonal ``(α, β)`` pair.

    ``min_one=True`` forces one step even when the entry residual is already
    within ``btol``: the expintegrator's outer loop must make progress after
    a rejected partial attempt, as the reference expands once per outer
    iteration while ``K < krylovdim``
    (``src/matrixfun/expintegrator.jl:285-287``).  The entry row may then be
    unnormalized; its norm comes from ``scales.s``.

    Returns ``(state_new, scales_new, numops_increment)``."""
    V, H, k0 = state.V, state.H, state.k
    kmax = H.shape[0]
    prime, advance, tail = make_fused_stepper(op, kmax, dgks, space)
    c = prime(V, k0, scales)

    def going(c):
        return (min_one and c.k == k0) or float(torch.sqrt(c.q)) > btol

    while c.k < m - 1 and going(c):
        k = c.k
        c, alpha, beta_k, h = advance(c)
        H = _h_column(H, k, alpha, beta_k, None if hermitian else h)

    k = c.k
    go = k == m - 1 and going(c)
    V, sc, alpha, beta_m, h = tail(c, go)
    if go:
        H = _h_column(H, k, alpha, beta_m, None if hermitian else h)
        beta_out = beta_m
    else:
        beta_out = torch.sqrt(c.q)
    state_new = KrylovState(V, H, k + int(go), beta_out.to(state.beta.dtype))
    return state_new, sc, (k - k0) + 1


# --------------------------------------------------------------------------
# Batched fused expansion (P problems on one stencil operator)
# --------------------------------------------------------------------------

def fused_available_batched(op, x0s, space: VectorSpace, kmax=None) -> bool:
    """:func:`fused_available` for the problems of a batched solve, ``x0s``
    their start vectors (one shared start, or one each): every problem's
    block must pass the one-problem gate, on a sharded space its per-rank
    rules too (at least ``h`` rows, a grid's blocks cut whole grid rows)."""
    return all(fused_available(op, x, space, kmax) for x in x0s)


def make_fused_stepper_batched(op, kmax: int, dgks: bool, space: VectorSpace = STANDARD):
    """Return ``(prime, advance, tail)`` over the :class:`FusedCarry` of each
    of ``P`` problems on one fusable stencil operator (the counterpart of
    :func:`make_fused_stepper` under ``jax.vmap``).  The problems share the
    basis ``V (P, kmax, R, 128)`` and the ``y`` buffer ``Y (P, R, 128)``:
    ``carries[p].V`` is ``V[p]`` and ``carries[p].y`` is ``Y[p]``.

    * ``prime(V, Y, k0s, scs, problems)``: each problem's
      :func:`make_fused_stepper` prime (its local part, the collectives for
      all, then the shared :func:`_primed`), its ``y`` copied into ``Y[p]``;
    * ``advance(V, Y, carries, problems)``: one step of every problem in
      ``problems``, each at its own top row, the scalar front half per
      problem and one :func:`~..ops.fused_lanczos.fused_step_batched` launch
      for each distinct top row among them (a launch whose problems have
      unequal live rows runs the plan of the largest, which rounds the
      others' reductions otherwise than their one-problem launches; one
      ``B`` a launch keeps every problem's one-problem bits); returns
      ``(Y', {p: (carry', alpha, beta, hcol)})``, ``Y'`` the launches'
      ``y'`` (only the stepped problems' rows are defined);
    * ``tail(carries, go)``: the one-problem tail of each problem of ``go``
      (``{p: bool}``, :func:`_tail_front` and :func:`_tailed` around one
      sum of the norms), as ``{p: (V, scales', alpha, beta, hcol)}``.

    On a sharded space (``space.psum_axis``) each rank steps its block of
    every problem, the neighbours' edge rows of each problem's basis and
    ``y`` its external halos (``Vext (P, kmax, 2, h, 128)`` and ``yext (P,
    2, h, 128)``, held here), and each collective the one-problem stepper
    makes a problem is one all-reduce for all the problems of a call:
    ``prime`` applies the operator to the stack (its ``normal_stack``),
    finishes the projections and brings the edge rows of every problem's
    live rows and ``y``; ``advance`` sums every stepping problem's partial
    reductions and brings the edge rows of its new row and ``y'`` in one
    zero-filled buffer; ``tail`` sums the norms."""
    spec = fl.spec_for(op)
    if spec is None:
        raise ValueError("make_fused_stepper_batched requires a fusable stencil operator")
    ax = space.psum_axis
    h = spec.h
    local = dataclasses.replace(space, psum_axis=None)
    halos = {}  # sharded: the halo buffers of the problems primed last

    def prime(V, Y, k0s, scs, problems):
        X = [V[p, k0s[p]] for p in problems]
        Yp = (op.normal_stack(torch.stack(X)) if op.normal_stack is not None
              else [op.normal(x) for x in X])
        C = psum(torch.stack([bs.project_bucketed(V[p], y, k0s[p] + 1, local)
                              for p, y in zip(problems, Yp)]), ax)
        if ax is not None:
            sent = [_edge_rows(V[p], y, k0s[p], h) for p, y in zip(problems, Yp)]
            above, below = ax.edges(torch.cat([f for f, _ in sent]),
                                    torch.cat([l for _, l in sent]))
            P = V.shape[0]
            halos.update(
                Vext=torch.zeros((P, kmax, 2, h, fl.LANES), dtype=torch.float32, device=V.device),
                yext=torch.zeros((P, 2, h, fl.LANES), dtype=torch.float32, device=V.device))
        carries, off = {}, 0
        for i, p in enumerate(problems):
            Y[p].copy_(Yp[i])
            ext = ()
            if ax is not None:
                n = k0s[p] + 2
                ext = (above[off:off + n], below[off:off + n], halos["Vext"][p],
                       halos["yext"][p])
                off += n
            carries[p] = _primed(V[p], Y[p], C[i], k0s[p], scs[p], *ext)
        return carries

    def advance(V, Y, carries, problems):
        P = V.shape[0]
        none = torch.zeros(kmax + 1, dtype=torch.float32, device=V.device)
        kp1, fronts, rows = [0] * P, {}, [none] * P
        for p in problems:
            c = carries[p]
            if c.y.data_ptr() != Y[p].data_ptr():
                raise ValueError(f"problem {p}: its y is not row {p} of the batch's y buffer")
            if ax is not None and c.yext.data_ptr() != halos["yext"][p].data_ptr():
                raise ValueError(f"problem {p}: its halos are not row {p} of the batch's halos")
            fronts[p] = _step_coeffs(c.r, c.d, c.rp, c.q, c.sc, c.k, dgks)
            rows[p] = torch.cat([fronts[p][0], fronts[p][1][None]])
            kp1[p] = c.k + 1
        G = torch.stack(rows)
        ext = {} if ax is None else {"Vext": halos["Vext"], "yext": halos["yext"]}
        # live rows: B = k + 1 = kp1 for every problem; one launch per B
        Yn, raws = torch.empty_like(Y), {}
        for B in sorted({kp1[p] for p in problems}):
            group = [p for p in problems if kp1[p] == B]
            _, raw = fl.fused_step_batched(V, Y, G, kp1, kp1, spec, with_drift=dgks,
                                           active=group, ynext=Yn, **ext)
            raws.update({p: raw[p] for p in group})
        if ax is not None:
            summed, mine = _exchange(ax, h, [raws[p] for p in problems],
                                     [V[p, kp1[p]] for p in problems], [Yn[p] for p in problems])
            yext = halos["yext"].clone()  # a stopped problem keeps its halos
            for j, p in enumerate(problems):
                halos["Vext"][p, kp1[p]], yext[p] = mine[j, :, 0], mine[j, :, 1]
                raws[p] = summed[j]
            halos["yext"] = yext
        out = {}
        for p in problems:
            Vext, yext = ((halos["Vext"][p], halos["yext"][p]) if ax is not None
                          else (None, None))
            out[p] = _stepped(carries[p], fronts[p], raws[p], Yn[p], dgks, Vext, yext)
        return Yn, out

    def tail(carries, go):
        out = {p: (carries[p].V, carries[p].sc, None, None, None) for p, g in go.items() if not g}
        fronts = {p: _tail_front(carries[p], dgks) for p, g in go.items() if g}
        if fronts:
            betas = torch.sqrt(psum(torch.stack([torch.sum(W * W) for W, _ in fronts.values()]),
                                    ax))
            for (p, (W, front)), beta in zip(fronts.items(), betas):
                out[p] = _tailed(carries[p], W, front, beta)
        return out

    return prime, advance, tail


def fused_expansions_batched(op, V, states, scales, m: int, btol, dgks: bool = False,
                             hermitian: bool = True, min_one: bool = False,
                             space: VectorSpace = STANDARD):
    """:func:`fused_expansions` of every problem in ``states``
    (``{p: KrylovState}``, ``states[p].V`` the row ``V[p]`` of the batch's
    basis ``V (P, m + 1, R, 128)``; ``scales`` ``{p: FusedScales}``) at
    once: each problem expands from its own ``k`` to ``m`` as its own solve
    would, and leaves the launches when its solve would stop (frozen, as a
    vmapped ``while_loop`` selects a finished problem's old carry).  A step
    reads one ``(problems,)`` list of ``‖R_k‖`` from the device and makes one
    batched kernel launch per distinct top row (on a sharded space, then one
    all-reduce for all of them).  ``btol`` is one bound for all or ``{p:
    bound}``; ``hermitian`` and ``min_one`` are :func:`fused_expansions`'s
    (the Arnoldi column, one forced step).  Returns ``({p: KrylovState}, {p:
    FusedScales}, {p: numops increment})``."""
    problems = sorted(states)
    btols = btol if isinstance(btol, dict) else {p: btol for p in problems}
    kmax = m + 1
    prime, advance, tail = make_fused_stepper_batched(op, kmax, dgks, space)
    Y = torch.empty((V.shape[0],) + tuple(V.shape[2:]), dtype=V.dtype, device=V.device)
    k0s = {p: states[p].k for p in problems}
    carries = prime(V, Y, k0s, scales, problems)
    H = {p: states[p].H for p in problems}
    go = {}
    stepping = problems
    while stepping:
        qnorms = torch.stack([torch.sqrt(carries[p].q) for p in stepping]).tolist()
        nxt = []
        for p, qn in zip(stepping, qnorms):
            going = (min_one and carries[p].k == k0s[p]) or qn > btols[p]
            if carries[p].k < m - 1 and going:
                nxt.append(p)
            else:
                go[p] = carries[p].k == m - 1 and going
        if not nxt:
            break
        Y, outs = advance(V, Y, carries, nxt)
        for p in nxt:
            c, alpha, beta_k, h = outs[p]
            H[p] = _h_column(H[p], carries[p].k, alpha, beta_k, None if hermitian else h)
            carries[p] = c
        stepping = nxt
    tails = tail(carries, go)
    new_states, new_scales, dops = {}, {}, {}
    for p in problems:
        c = carries[p]
        k = c.k
        Vp, sc, alpha, beta_m, h = tails[p]
        if go[p]:
            H[p] = _h_column(H[p], k, alpha, beta_m, None if hermitian else h)
            beta_out = beta_m
        else:
            beta_out = torch.sqrt(c.q)
        new_states[p] = KrylovState(Vp, H[p], k + int(go[p]),
                                    beta_out.to(states[p].beta.dtype))
        new_scales[p] = sc
        dops[p] = (k - k0s[p]) + 1
    return new_states, new_scales, dops
