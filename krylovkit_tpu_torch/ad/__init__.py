"""Reverse-mode AD for the solvers (counterpart of ``krylovkit_tpu/ad/``;
reference ``ext/KrylovKitChainRulesCoreExt/``).

One ``torch.autograd.Function`` per custom VJP of the JAX package.  The
pullbacks are themselves Krylov solves on pytree vectors, as in the
reference: bordered systems on ``(vector, scalar)`` tuples through
``linsolve``, Sylvester problems on ``(vector, small-vector)`` and ``(u, v,
z)`` tuples through the Arnoldi eigsolve.  The differentiable inputs are the
start or right-hand-side vectors, the shifts of ``linsolve`` and the
tensors the operator holds (``LinearOperator.tensors``).  Forward and
backward solves record no autograd graph.

The batched drivers of ``solvers/batched*.py`` differentiate by the same
rules (``ad/batched.py``): each problem's inner solves are built as its
one-problem rule builds them (``route``, ``_common.Inner``), and all
problems' are solved in one batched call, on a sharded space too (each
rank's cotangents the one-problem sharded rule's, problem by problem).

Convention: torch's cotangents are conjugate-Wirtinger derivatives, the
conjugates of JAX's (for a real loss, ``t.grad == conj(jax.grad)``); they
are ChainRules' "adjoint" cotangents, so the reference's formulas apply
without the conjugations the JAX package wraps around them.
"""

from .eigsolve import eigsolve_vjp  # noqa: F401
from .linsolve import linsolve_vjp  # noqa: F401
from .svdsolve import svdsolve_vjp  # noqa: F401
