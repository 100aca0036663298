"""Differentiable ``eigsolve`` (counterpart of ``krylovkit_tpu/ad/eigsolve.py``;
reference ``ext/KrylovKitChainRulesCoreExt/eigsolve.jl``).

torch's cotangents are ChainRules' "adjoint" ones (the conjugates of the
JAX package's), so the reference's formulas apply as written, with no
conjugation on the way in or out.  Three backward routes, picked as the
JAX package's ``_bwd`` picks them:

* ``alg_rrule`` not ``Arnoldi`` (default ``GMRES`` of the primal's
  settings): per converged eigenpair ``(λ, v)`` with cotangents ``(Δλ,
  Δv)`` the bordered adjoint system on a ``(vector, scalar)`` pytree

      [ conj(λ)·I − Aᴴ   v ] [w]   [Δv − v⟨v,Δv⟩]
      [      vᴴ          0 ] [δ] = [     Δλ      ]

  is one ``linsolve`` with ``alg_rrule``;
* ``Arnoldi`` ``alg_rrule`` with a Lanczos primal: the subspace-aware
  Sylvester pullback (reference ``:318-419``), one Arnoldi eigsolve on
  ``(vector, small-vector)`` pytrees;
* ``Arnoldi`` ``alg_rrule`` with an Arnoldi primal: the general Sylvester
  pullback (reference ``:182-310``), projections through the Gram matrix of
  the non-orthonormal eigenvectors.

The operator cotangent is ``Ā = Σᵢ wᵢ vᵢᴴ``: the vector-Jacobian products of
``t ↦ A_t vᵢ`` at ``wᵢ`` on the operator's tensors.  Gauge-sensitive
cotangent components are projected out after a warning (``ad/gauge.py``).
``x0`` gets no gradient.
"""

from __future__ import annotations

import torch

from ..algorithms import GMRES
from ..ops import basis as bs
from ..ops.operator import TypedOperator
from ..ops.vector import tree_flatten, tree_leaves, tree_map, tree_unflatten, zerovector
from ._common import (Call, Inner, detached, euclidean, operator_cotangent, real_safe, row,
                      solve_inner, split_operator)
from .gauge import warn_gauge_eager

__all__ = ["eigsolve_vjp", "route"]


def _default_rrule_alg(alg):
    return GMRES(tol=alg.tol, krylovdim=alg.krylovdim, maxiter=alg.maxiter, orth=alg.orth)


def _verbosity(alg, alg_rrule) -> int:
    return getattr(alg_rrule or alg, "verbosity", 1)


def _mix(basis, coeffs):
    """``Σ_j coeffs[j, i] basis_j`` for each column ``i``: a stacked pytree
    with one row per column of ``coeffs``, the coefficients in each leaf's
    type (their real part for a real leaf)."""
    return tree_map(
        lambda l: (real_safe(coeffs.T, l.dtype) @ l.reshape(l.shape[0], -1)).reshape(
            (coeffs.shape[1],) + tuple(l.shape[1:])),
        basis,
    )


def _contract(x, D):
    """``Σ_i x[i] D_i`` for a stacked pytree ``D``."""
    return tree_map(
        lambda l: (real_safe(x, l.dtype) @ l.reshape(l.shape[0], -1)).reshape(l.shape[1:]), D)


def _sub(a, b):
    return tree_map(lambda x, y: x - y, a, b)


def _which_shift(vals, n: int, which, cdt):
    """``2·conj(λ_{n-1})`` if 0 would sort before the last wanted value,
    else 0: the shift that keeps the projected block out of the way."""
    from .. import dense

    key_last = dense.which_key(vals[n - 1: n].to(cdt), which)[0]
    key_zero = dense.which_key(torch.zeros(1, dtype=cdt, device=vals.device), which)[0]
    zero = torch.zeros((), dtype=cdt, device=vals.device)
    return torch.where(key_last < key_zero, 2 * torch.conj(vals[n - 1]).to(cdt), zero)


def _nearest_sorter(valsc):
    from ..algorithms import EigSorter

    target = torch.conj(valsc)
    return EigSorter(by=lambda v: torch.min(torch.abs(v[..., None] - target[None, :]), dim=-1)
                     .values, rev=False)


def _gmres_inner(howmany, alg, alg_rrule, space, op, vals, vecs, gvals, gvecs) -> Inner:
    """The GMRES rule: one bordered system per eigenpair, ``w_i`` the
    vector part of each solution."""
    rrule_alg = alg_rrule or _default_rrule_alg(alg)
    cdt = tree_leaves(vecs)[0].dtype
    dev = vals.device
    systems = []
    for i in range(howmany):
        lam = vals[i]
        v = row(vecs, i)
        dlam = gvals[i].to(cdt)
        dv = row(gvecs, i)
        vddv = space.inner(v, dv)
        warn_gauge_eager(
            torch.abs(torch.imag(vddv)) if torch.is_complex(vddv) else 0.0, alg.tol,
            _verbosity(alg, alg_rrule),
            f"`eigsolve` cotangent for eigenvector {i} is sensitive to gauge "
            "choice: (|gauge| = {gauge})",
        )
        dv = tree_map(lambda a, b: a - vddv.to(a.dtype) * b, dv, v)

        def opb(xz, lam=lam, v=v):
            x1, x2 = xz
            y1 = tree_map(
                lambda ax, xx, vv: torch.conj(lam).to(xx.dtype) * xx - ax + x2.to(vv.dtype) * vv,
                op.apply_adjoint(x1), x1, v,
            )
            return y1, [space.local_inner(v, x1)]

        rhs = (dv, dlam)
        zero = (zerovector(dv), torch.zeros((), dtype=cdt, device=dev))
        # the bordered row ⟨v, x₁⟩ is split off: a batch sums every
        # system's in one all-reduce
        systems.append((split_operator(opb, lambda y1, sums: (y1, sums[0]), space, cdt), rhs,
                        zero))

    def finish(sols):
        return [("normal", row(vecs, i), w) for i, (w, _delta) in enumerate(sols)]

    shifts = (torch.zeros((), dtype=cdt, device=dev), torch.ones((), dtype=cdt, device=dev))
    return Inner("linsolve", rrule_alg, systems, finish, shifts)


def _sylvester_tail(Ws, n: int, vecs, Z0, overlap):
    """``wsᵢ = z_i − Σ_j Wq_j Z⁻¹[j, i]`` from the Sylvester eigensolve's
    vectors ``Ws = (W, X)``: ``Z = Xᵀ`` (pseudo-inverted: with exactly
    degenerate eigenvalues the inner solve may return a rank-deficient
    ``Z``) and ``Wq`` the part of ``W`` outside ``span(vecs)``, whose
    coefficients ``overlap(W)`` gives."""
    Wvec, Wx = Ws
    Zinv = torch.linalg.pinv(Wx.T[:n, :n], rtol=1e-10)
    Wq = _sub(Wvec, _mix(vecs, overlap(Wvec)))
    return _sub(Z0, _mix(tree_map(lambda l: l[:n], Wq), Zinv))


def _sylvester_inner(howmany, which, alg, alg_rrule, space, op, vals, vecs, gvals,
                     gvecs) -> Inner:
    """Subspace-aware pullback of a Hermitian primal (reference
    ``ext/.../eigsolve.jl:318-419``): the subspace components come from the
    antihermitian part of ``VᴴΔV`` divided by eigenvalue gaps (robust for
    degenerate eigenvalues), the orthogonal-complement components from the
    Sylvester problem ``(Aᴴ(1−P) + shift·P) W − W Λ = ΔV_perp``, solved as
    one eigenproblem on ``(w, x)`` pytrees with ``alg_rrule``."""
    n = howmany
    cdt = tree_leaves(vecs)[0].dtype
    rdt = cdt.to_real()
    tol = alg.tol
    dvals = gvals[:n].to(cdt)
    dvecs = tree_map(lambda l: l[:n], gvecs)

    gspace = euclidean(space)
    VdDV = bs.gram(vecs, dvecs, gspace)[:n, :n].to(cdt)
    a = (VdDV - VdDV.conj().T) / 2
    degmask = torch.abs(vals[None, :n] - vals[:n, None]).to(rdt) < tol
    warn_gauge_eager(
        torch.max(torch.abs(torch.where(degmask, a, torch.zeros_like(a)))), tol,
        _verbosity(alg, alg_rrule),
        "`eigsolve` cotangents sensitive to gauge choice: (|gauge| = {gauge})",
    )
    gaps = vals[None, :n].to(cdt) - vals[:n, None].to(cdt)
    inv_gaps = torch.where(torch.abs(gaps) < tol, torch.zeros_like(gaps),
                           1 / torch.where(gaps == 0, torch.ones_like(gaps), gaps))
    a = a * inv_gaps + torch.diag(torch.real(dvals).to(cdt))
    Z0 = _mix(vecs, a)  # z_i = Σ_j a[j, i] v_j
    Dperp = _sub(dvecs, _mix(vecs, VdDV))  # ΔV_i − Σ_j VdΔV[j, i] v_j
    shift = _which_shift(vals, n, which, cdt)
    valsc = vals[:n].to(cdt)

    def block_op(wx):
        w, x = wx
        w0 = bs.unproject(vecs, bs.project(vecs, w, n, space))
        wp = op.apply_adjoint(_sub(w, w0))
        wp = tree_map(lambda l, l0: l + real_safe(shift, l.dtype) * l0, wp, w0)
        wp = _sub(wp, _contract(x, Dperp))
        return wp, valsc * x

    def finish(sols):
        ws = _sylvester_tail(sols[0], n, vecs, Z0, lambda W: bs.gram(vecs, W, gspace))
        if not cdt.is_complex:
            # a real Hermitian primal: the inner solve ran in complex
            # arithmetic, but a consistent cotangent has vanishing imaginary part
            ws = tree_map(lambda l: torch.real(l).to(cdt), ws)
        return [("normal", row(vecs, i), row(ws, i)) for i in range(n)]

    return _sylvester_problem(block_op, vecs, n, valsc, alg_rrule, finish)


def _sylvester_general_inner(howmany, which, alg, alg_rrule, space, op, vals, vecs, gvals,
                             gvecs) -> Inner:
    """Sylvester pullback of a general (Arnoldi) primal (reference
    ``ext/.../eigsolve.jl:182-310``): as :func:`_sylvester_inner`, but the
    eigenvectors are not orthonormal, so projections go through the Gram
    matrix ``G = VᴴV``, and the subspace coefficients use the raw
    gauge-projected ``VᴴΔV``."""
    n = howmany
    cdt = tree_leaves(vecs)[0].dtype
    rdt = cdt.to_real()
    tol = alg.tol
    dvals = gvals[:n].to(cdt)
    dvecs = tree_map(lambda l: l[:n], gvecs)

    gspace = euclidean(space)
    G = bs.gram(vecs, vecs, gspace)[:n, :n].to(cdt)
    VdDV = bs.gram(vecs, dvecs, gspace)[:n, :n].to(cdt)
    degmask = torch.abs(vals[None, :n] - vals[:n, None]).to(rdt) < tol
    gaugepart = VdDV - torch.diag(torch.real(torch.diagonal(VdDV))).to(cdt)
    warn_gauge_eager(
        torch.max(torch.abs(torch.where(degmask, gaugepart, torch.zeros_like(gaugepart)))), tol,
        _verbosity(alg, alg_rrule),
        "`eigsolve` cotangents sensitive to gauge choice: (|Δgauge| = {gauge})",
    )
    # the gauge (diagonal) components removed: VdΔV' = VdΔV − G·Diag(diag/diagG)
    VdDVp = VdDV - G * (torch.diagonal(VdDV) / torch.diagonal(G))[None, :]
    gaps = torch.conj(vals[None, :n].to(cdt) - vals[:n, None].to(cdt))
    a = VdDVp * torch.where(torch.abs(gaps) < tol, torch.zeros_like(gaps),
                            1 / torch.where(gaps == 0, torch.ones_like(gaps), gaps))
    a = a + torch.diag(dvals)
    Z0 = _mix(vecs, torch.linalg.solve(G, a))
    # sylvester argument: fᴴ(z_i) + Δv_i − Σ_j (G⁻¹VdΔV)[j, i] v_j
    fz = [op.apply_adjoint(row(Z0, i)) for i in range(n)]
    fz = tree_map(lambda *ls: torch.stack(ls), *fz)
    Dperp = tree_map(lambda la, ld, ls: la + ld - ls, fz, dvecs,
                     _mix(vecs, torch.linalg.solve(G, VdDV)))
    shift = _which_shift(vals, n, which, cdt)
    valsc = vals[:n].to(cdt)

    def proj(w):
        c = torch.linalg.solve(G, bs.project(vecs, w, n, space)[:n].to(cdt))
        return bs.unproject(vecs, c)

    def block_op(wx):
        w, x = wx
        w0 = proj(w)
        wp = op.apply_adjoint(_sub(w, w0))
        wp = tree_map(lambda l, l0: l + real_safe(shift, l.dtype) * l0, wp, w0)
        wp = _sub(wp, _contract(x, Dperp))
        return wp, torch.conj(valsc) * x

    def finish(sols):
        ws = _sylvester_tail(sols[0], n, vecs, Z0, lambda W: torch.linalg.solve(
            G, bs.gram(vecs, W, gspace)[:n, :].to(cdt)))
        if not cdt.is_complex:
            ws = tree_map(lambda l: torch.real(l).to(cdt), ws)
        return [("normal", row(vecs, i), row(ws, i)) for i in range(n)]

    return _sylvester_problem(block_op, vecs, n, valsc, alg_rrule, finish)


def _sylvester_problem(block_op, vecs, n: int, valsc, alg_rrule, finish) -> Inner:
    """The one Arnoldi eigsolve of a Sylvester rule on ``(w, x)`` pytrees,
    from ``(0, 1)``, its ``n`` values nearest ``conj(valsc)``."""
    cdt = valsc.dtype
    w0 = (tree_map(lambda l: torch.zeros_like(l[0]), vecs),
          torch.ones(n, dtype=cdt, device=valsc.device))
    problem = (TypedOperator(block_op, None, dtype=cdt), w0, n, _nearest_sorter(valsc))
    return Inner("eigsolve", alg_rrule, [problem], finish)


def route(howmany, which, alg, alg_rrule, space, op, vals, vecs, gvals, gvecs) -> Inner:
    """The inner solves of the rule the JAX package's ``_bwd`` picks, for
    one problem."""
    from ..algorithms import Arnoldi, Lanczos

    args = (howmany, which, alg, alg_rrule, space, op, vals, vecs, gvals, gvecs)
    if isinstance(alg_rrule, Arnoldi):
        if isinstance(alg, Lanczos):
            return _sylvester_inner(*args)
        return _sylvester_general_inner(*args)
    return _gmres_inner(howmany, alg, alg_rrule, space, op, vals, vecs, gvals, gvecs)


class _Eigsolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, call, *flat):
        from ..solvers.eigsolve import _eigsolve_impl

        nx = call.nx
        x0 = tree_unflatten([t.detach() for t in flat[:nx]], call.spec_x0)
        op = detached(call.op, flat[nx:])
        vals, vecs, info = _eigsolve_impl(op, x0, call.howmany, call.which, call.alg, call.space)
        vl, call.spec_v = tree_flatten(vecs)
        call.info = info
        ctx.call, ctx.op = call, op
        ctx.save_for_backward(vals, *vl)
        return (vals, *vl)

    @staticmethod
    def backward(ctx, gvals, *gvl):
        call, op = ctx.call, ctx.op
        saved = [t.detach() for t in ctx.saved_tensors]
        vals, vecs = saved[0], tree_unflatten(saved[1:], call.spec_v)
        gvecs = tree_unflatten(list(gvl), call.spec_v)
        nx = call.nx
        grads = [None] * (len(call.dtypes))
        if any(ctx.needs_input_grad[1 + nx:]):
            terms = solve_inner(route(call.howmany, call.which, call.alg, call.alg_rrule,
                                      call.space, op, vals, vecs, gvals, gvecs), call.space)
            grads[nx:] = operator_cotangent(call.op, terms)
        return (None,) + tuple(
            real_safe(g, dt) if g is not None else None for g, dt in zip(grads, call.dtypes)
        )


def eigsolve_vjp(howmany, which, alg, alg_rrule, space, op, x0):
    """The Lanczos or Arnoldi eigsolve as a ``torch.autograd.Function`` of
    ``x0`` and the tensors ``op`` holds.  Returns ``(vals, vecs, info)``; the
    forward solve runs on detached tensors and records no graph, and
    ``info`` and its counts are those of the undifferentiated solve.  ``op``
    needs an adjoint (``with_adjoint_from`` derives one)."""
    xl, spec_x0 = tree_flatten(x0)
    flat = (*xl, *op.tensors())
    call = Call(howmany=howmany, which=which, alg=alg, alg_rrule=alg_rrule, space=space, op=op,
                 nx=len(xl), spec_x0=spec_x0, dtypes=[t.dtype for t in flat])
    out = _Eigsolve.apply(call, *flat)
    return out[0], tree_unflatten(list(out[1:]), call.spec_v), call.info
