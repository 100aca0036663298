"""Differentiable ``svdsolve`` (counterpart of ``krylovkit_tpu/ad/svdsolve.py``;
reference ``ext/KrylovKitChainRulesCoreExt/svdsolve.jl``).

torch's cotangents are ChainRules' "adjoint" ones, so the reference's
formulas apply as written.  Two backward routes:

* ``alg_rrule`` not ``Arnoldi`` (default ``GMRES`` of the primal's
  settings): per converged triplet ``(σ, u, v)`` with cotangents ``(Δσ,
  Δu, Δv)`` the coupled system on an ``(x, y)`` pytree

      x' = P_u(σ x − A y),   y' = P_v(σ y − Aᴴ x)      (P: complement projector)
      (x', y') = (Δu − u⟨u,Δu⟩, Δv − v⟨v,Δv⟩)

  is one ``linsolve``; then ``x += u·Δs/2``, ``y += v·conj(Δs)/2`` with
  ``Δs = Re Δσ + i·Im(⟨u,Δu⟩ − ⟨v,Δv⟩)/(2σ)`` (reference ``:105-159``);
* ``Arnoldi`` ``alg_rrule`` (``which == "LR"`` only, as the reference):
  every triplet at once through one Arnoldi eigsolve on ``(x, y, z)``
  pytrees (reference ``:160-273``), robust for (near-)degenerate singular
  values.

The operator cotangent is ``Ā = Σᵢ (xᵢ vᵢᴴ + uᵢ yᵢᴴ)``: the vector-Jacobian
products of ``t ↦ A_t vᵢ`` at ``xᵢ`` and of ``t ↦ A_tᴴ uᵢ`` at ``yᵢ``.
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
from .eigsolve import _contract, _mix, _sub
from .gauge import warn_gauge_eager

__all__ = ["svdsolve_vjp", "route"]


def _axpy(y, x, a):
    """``y + a·x`` leaf by leaf, ``a`` in each leaf's type."""
    return tree_map(lambda ly, lx: ly + real_safe(a, ly.dtype) * lx, y, x)


def _gmres_inner(howmany, alg, alg_rrule, space, op, vals, lvecs, rvecs, gs, gu, gv) -> Inner:
    """The GMRES rule: one coupled ``(x, y)`` system per triplet."""
    rrule_alg = alg_rrule or GMRES(tol=alg.tol, krylovdim=alg.krylovdim, maxiter=alg.maxiter,
                                   orth=alg.orth)
    cdt = tree_leaves(lvecs)[0].dtype
    dev = vals.device
    systems, shifts = [], []
    for i in range(howmany):
        sig = vals[i].to(cdt.to_real())
        u, v = row(lvecs, i), row(rvecs, i)
        du, dv = row(gu, i), row(gv, i)
        uddu, vddv = space.inner(u, du), space.inner(v, dv)
        warn_gauge_eager(
            torch.abs(torch.imag(uddu + vddv)) if torch.is_complex(uddu) else 0.0, alg.tol,
            getattr(alg_rrule or alg, "verbosity", 1),
            f"`svdsolve` cotangents for singular vectors {i} are sensitive "
            "to gauge choice: (|gauge| = {gauge})",
        )
        if cdt.is_complex:
            ds = torch.real(gs[i]) + 1j * torch.imag(uddu - vddv) / (2 * sig)
        else:
            ds = torch.real(gs[i])
        shifts.append(ds.to(cdt))
        bu, bv = _axpy(du, u, -uddu), _axpy(dv, v, -vddv)

        def opb(xy, sig=sig, u=u, v=v):
            x, y = xy
            xp = tree_map(lambda lx, lay: real_safe(sig, lx.dtype) * lx - lay, x, op.normal(y))
            yp = tree_map(lambda ly, lax_: sig.to(ly.dtype) * ly - lax_, y, op.apply_adjoint(x))
            return (xp, yp), [space.local_inner(u, xp), space.local_inner(v, yp)]

        def project(xpyp, sums, u=u, v=v):
            xp, yp = xpyp
            return _axpy(xp, u, -sums[0]), _axpy(yp, v, -sums[1])

        # the projections' inner products are split off: a batch sums every
        # system's in one all-reduce
        systems.append((split_operator(opb, project, space, cdt), (bu, bv),
                        (zerovector(bu), zerovector(bv))))

    def finish(sols):
        terms = []
        for i, ((x, y), ds) in enumerate(zip(sols, shifts)):
            u, v = row(lvecs, i), row(rvecs, i)
            terms += [("normal", v, _axpy(x, u, ds / 2)),
                      ("adjoint", u, _axpy(y, v, torch.conj(ds) / 2))]
        return terms

    return Inner("linsolve", rrule_alg, systems, finish,
                 (torch.zeros((), dtype=cdt, device=dev), torch.ones((), dtype=cdt, device=dev)))


def _sylvester_inner(howmany, alg, alg_rrule, space, op, vals, lvecs, rvecs, gs, gu,
                     gv) -> Inner:
    """Coupled ``(x, y, z)`` eigenproblem pullback (reference
    ``ext/.../svdsolve.jl:160-273``, ``which == "LR"``): every triplet's
    cotangents through one eigsolve of

        (x, y, z) ↦ (Q_U(A y) − Σᵢ ΔUᵢ zᵢ, Q_V(Aᴴ x) − Σᵢ ΔVᵢ zᵢ, Σ·z)."""
    n = howmany
    cdt = tree_leaves(lvecs)[0].dtype
    rdt = cdt.to_real()
    tol = alg.tol
    dev = vals.device
    sig = vals[:n].to(rdt)
    dlv = tree_map(lambda l: l[:n], gu)
    drv = tree_map(lambda l: l[:n], gv)

    gspace = euclidean(space)
    UdDU = bs.gram(lvecs, dlv, gspace)[:n, :n].to(cdt)
    VdDV = bs.gram(rvecs, drv, gspace)[:n, :n].to(cdt)
    aU = (UdDU - UdDU.conj().T) / 2
    aV = (VdDV - VdDV.conj().T) / 2
    degmask = torch.abs(sig[None, :] - sig[:, None]) < tol
    warn_gauge_eager(
        torch.max(torch.abs(torch.where(degmask, aU + aV, torch.zeros_like(aU)))), tol,
        getattr(alg_rrule or alg, "verbosity", 1),
        "`svdsolve` cotangents for singular vectors are sensitive to gauge "
        "choice: (|gauge| = {gauge})",
    )

    def safe_inv(m):
        return torch.where(torch.abs(m) < tol, torch.zeros_like(m),
                           1 / torch.where(m == 0, torch.ones_like(m), m))

    gm = sig[None, :] - sig[:, None]
    gp = sig[None, :] + sig[:, None]
    UdDAV = (aU + aV) * safe_inv(gm).to(cdt) + (aU - aV) * safe_inv(gp).to(cdt)
    UdDAV = UdDAV + torch.diag(torch.real(gs[:n]).to(cdt))
    xs0 = _mix(lvecs, UdDAV / 2)
    ys0 = _mix(rvecs, UdDAV.conj().T / 2)
    DU = _sub(dlv, _mix(lvecs, UdDU))
    DV = _sub(drv, _mix(rvecs, VdDV))

    def qproj(basis, w):
        return _sub(w, bs.unproject(basis, bs.project(basis, w, n, space)))

    def block_op(xyz):
        x, y, z = xyz
        xp = _sub(qproj(lvecs, op.normal(y)), _contract(z, DU))
        yp = _sub(qproj(rvecs, op.apply_adjoint(x)), _contract(z, DV))
        return xp, yp, sig.to(cdt) * z

    w0 = (tree_map(lambda l: torch.zeros_like(l[0]), lvecs),
          tree_map(lambda l: torch.zeros_like(l[0]), rvecs),
          torch.ones(n, dtype=cdt, device=dev))

    def finish(sols):
        Wx, Wy, Wz = sols[0]
        Zinv = torch.linalg.pinv(Wz.T[:n, :n], rtol=1e-10)
        xs = _sub(xs0, _mix(tree_map(lambda l: l[:n], Wx), Zinv))
        ys = _sub(ys0, _mix(tree_map(lambda l: l[:n], Wy), Zinv))
        if not cdt.is_complex:
            xs = tree_map(lambda l: torch.real(l).to(cdt), xs)
            ys = tree_map(lambda l: torch.real(l).to(cdt), ys)
        terms = []
        for i in range(n):
            terms += [("normal", row(rvecs, i), row(xs, i)),
                      ("adjoint", row(lvecs, i), row(ys, i))]
        return terms

    return Inner("eigsolve", alg_rrule, [(TypedOperator(block_op, None, dtype=cdt), w0, n, "LR")],
                 finish)


def route(howmany, which, alg, alg_rrule, space, op, vals, lvecs, rvecs, gs, gu, gv) -> Inner:
    """The inner solves of the rule ``alg_rrule`` picks, for one problem."""
    from ..algorithms import Arnoldi

    args = (howmany, alg, alg_rrule, space, op, vals, lvecs, rvecs, gs, gu, gv)
    if isinstance(alg_rrule, Arnoldi):
        w = which.upper() if isinstance(which, str) else which
        if w != "LR":
            raise NotImplementedError(
                "Arnoldi-path svdsolve pullback only for which='LR' "
                "(reference ext/.../svdsolve.jl:166)"
            )
        return _sylvester_inner(*args)
    return _gmres_inner(*args)


class _Svdsolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, call, *flat):
        from ..solvers.svdsolve import svdsolve_gkl

        nx = call.nx
        x0 = tree_unflatten([t.detach() for t in flat[:nx]], call.spec_x0)
        op = detached(call.op, flat[nx:])
        vals, lvecs, rvecs, info = svdsolve_gkl(op, x0, call.howmany, call.which, call.alg,
                                                call.space)
        ul, call.spec_u = tree_flatten(lvecs)
        vl, call.spec_v = tree_flatten(rvecs)
        call.nu, call.info = len(ul), info
        ctx.call, ctx.op = call, op
        ctx.save_for_backward(vals, *ul, *vl)
        return (vals, *ul, *vl)

    @staticmethod
    def backward(ctx, gs, *guv):
        call, op = ctx.call, ctx.op
        nu, nx = call.nu, call.nx
        saved = [t.detach() for t in ctx.saved_tensors]
        vals = saved[0]
        lvecs = tree_unflatten(saved[1:1 + nu], call.spec_u)
        rvecs = tree_unflatten(saved[1 + nu:], call.spec_v)
        gu = tree_unflatten(list(guv[:nu]), call.spec_u)
        gv = tree_unflatten(list(guv[nu:]), call.spec_v)
        grads = [None] * len(call.dtypes)
        if any(ctx.needs_input_grad[1 + nx:]):
            terms = solve_inner(route(call.howmany, call.which, call.alg, call.alg_rrule,
                                      call.space, op, vals, lvecs, rvecs, gs, gu, gv), call.space)
            grads[nx:] = operator_cotangent(call.op, terms)
        return (None,) + tuple(
            real_safe(g, dt) if g is not None else None for g, dt in zip(grads, call.dtypes)
        )


def svdsolve_vjp(howmany, which, alg, alg_rrule, space, op, x0):
    """The GKL ``svdsolve`` as a ``torch.autograd.Function`` of ``x0`` and
    the tensors ``op`` holds.  Returns ``(vals, lvecs, rvecs, info)``; the
    forward solve runs on detached tensors and records no graph, and
    ``info`` and its counts are those of the undifferentiated solve."""
    xl, spec_x0 = tree_flatten(x0)
    flat = (*xl, *op.tensors())
    call = Call(howmany=howmany, which=which, alg=alg, alg_rrule=alg_rrule, space=space, op=op,
                 nx=len(xl), spec_x0=spec_x0, dtypes=[t.dtype for t in flat])
    out = _Svdsolve.apply(call, *flat)
    nu = call.nu
    return (out[0], tree_unflatten(list(out[1:1 + nu]), call.spec_u),
            tree_unflatten(list(out[1 + nu:]), call.spec_v), call.info)
