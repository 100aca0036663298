"""Differentiable ``linsolve`` (counterpart of ``krylovkit_tpu/ad/linsolve.py``;
reference ``ext/KrylovKitChainRulesCoreExt/linsolve.jl``).

Implicit differentiation of ``(a0 + a1 A) x = b``.  In torch's convention a
cotangent is the conjugate of the JAX package's (for a real loss,
``t.grad = conj(jax.grad)``), which is ChainRules' "adjoint" convention, so
with ``M = a0 I + a1 A`` and ``x̄`` the cotangent of ``x``:

    u  = M⁻ᴴ x̄               one solve with Mᴴ = conj(a0) + conj(a1) Aᴴ
    b̄  = u
    Ā  = −conj(a1) · u xᴴ    (the vector-Jacobian product of ``t ↦ A_t x``
                              at ``−conj(a1) u``, on the operator's tensors)
    ā0 = −⟨x, u⟩,  ā1 = −⟨A x, u⟩

The backward is one ``linsolve`` of the adjoint system with ``alg_rrule``
(default: the primal algorithm), as in the reference.  ``x0`` gets no
gradient.
"""

from __future__ import annotations

import torch

from ..ops.vector import scalartype, tree_flatten, tree_leaves, tree_map, tree_unflatten, zerovector
from ._common import Call, adjoint_operator, detached, operator_cotangent, real_safe

__all__ = ["linsolve_vjp", "dot", "dotu", "shift_cotangents", "operator_terms"]


def dot(x, y) -> torch.Tensor:
    """``Σ conj(x)·y`` over all leaves (the Euclidean inner product, whatever
    the solve's space).  On a sharded space it sums this rank's rows only:
    the shift cotangents it gives are a rank's partials, as the JAX
    package's in-body :func:`dotu` is a device's."""
    parts = []
    for a, b in zip(tree_leaves(x), tree_leaves(y)):
        dt = torch.promote_types(a.dtype, b.dtype)
        parts.append(torch.vdot(a.reshape(-1).to(dt), b.reshape(-1).to(dt)))
    return sum(parts[1:], parts[0])


def dotu(x, y) -> torch.Tensor:
    """The unconjugated ``Σ x·y`` over all leaves (the JAX package's
    ``dotu``, with which its plain-transpose convention writes ``ā0``)."""
    parts = [torch.sum(a * b) for a, b in zip(tree_leaves(x), tree_leaves(y))]
    return sum(parts[1:], parts[0])


class _Linsolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, call, *flat):
        from ..solvers.linsolve import _linsolve_impl

        nb, nx = call.nb, call.nx
        b = tree_unflatten([t.detach() for t in flat[:nb]], call.spec_b)
        x0 = tree_unflatten([t.detach() for t in flat[nb:nb + nx]], call.spec_x0)
        a0, a1 = flat[nb + nx].detach(), flat[nb + nx + 1].detach()
        op = detached(call.op, flat[nb + nx + 2:])
        x, info = _linsolve_impl(op, b, x0, a0, a1, call.alg, call.space)
        xl, call.spec_x = tree_flatten(x)
        call.info = info
        ctx.call, ctx.op, ctx.a = call, op, (a0, a1)
        ctx.save_for_backward(*xl)
        return tuple(xl)

    @staticmethod
    def backward(ctx, *gx):
        from ..solvers.linsolve import _linsolve_impl

        call, op, (a0, a1) = ctx.call, ctx.op, ctx.a
        need = ctx.needs_input_grad[1:]
        nb, nx = call.nb, call.nx
        x = tree_unflatten([t.detach() for t in ctx.saved_tensors], call.spec_x)
        g = tree_unflatten(list(gx), call.spec_x)
        # u = M⁻ᴴ x̄: the adjoint system, solved with alg_rrule
        u, _ = _linsolve_impl(adjoint_operator(op, scalartype(x)), g, zerovector(g),
                              torch.conj(a0), torch.conj(a1), call.alg_rrule, call.space)
        grads = [None] * len(need)
        if any(need[:nb]):
            grads[:nb] = tree_leaves(u)
        grads[nb + nx], grads[nb + nx + 1] = shift_cotangents(op, x, u, need[nb + nx],
                                                              need[nb + nx + 1])
        if any(need[nb + nx + 2:]):
            grads[nb + nx + 2:] = operator_cotangent(call.op, operator_terms(x, u, a1))
        return (None,) + tuple(
            real_safe(gr, dt) if gr is not None else None for gr, dt in zip(grads, call.dtypes)
        )


def shift_cotangents(op, x, u, need0: bool, need1: bool):
    """``(ā0, ā1) = (−⟨x, u⟩, −⟨A x, u⟩)`` of one system, each ``None``
    where it is not needed."""
    return (-dot(x, u) if need0 else None), (-dot(op.normal(x), u) if need1 else None)


def operator_terms(x, u, a1):
    """The operator cotangent of one system, as :func:`operator_cotangent`
    takes it: the vector-Jacobian product of ``t ↦ A_t x`` at ``−conj(a1)·u``."""
    if not isinstance(a1, torch.Tensor):  # a Python shift, exact in float64/complex128
        a1 = torch.tensor(a1, dtype=torch.complex128 if isinstance(a1, complex) else torch.float64)
    return [("normal", x, tree_map(lambda l: -torch.conj(a1).to(l.dtype) * l, u))]


def linsolve_vjp(alg, alg_rrule, space, op, b, x0, a0, a1):
    """``_linsolve_impl(op, b, x0, a0, a1, alg, space)`` as a
    ``torch.autograd.Function`` of ``b``, ``x0``, ``a0``, ``a1`` (0-d
    tensors) and the tensors ``op`` holds.  Returns ``(x, info)``; the
    forward solve runs on detached tensors and records no graph, and
    ``info`` and its counts are those of the undifferentiated solve."""
    bl, spec_b = tree_flatten(b)
    xl, spec_x0 = tree_flatten(x0)
    flat = (*bl, *xl, a0, a1, *op.tensors())
    call = Call(alg=alg, alg_rrule=alg_rrule, space=space, op=op, nb=len(bl), nx=len(xl),
                 spec_b=spec_b, spec_x0=spec_x0, dtypes=[t.dtype for t in flat])
    out = _Linsolve.apply(call, *flat)
    return tree_unflatten(list(out), call.spec_x), call.info
