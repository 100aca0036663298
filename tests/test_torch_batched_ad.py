"""PyTorch port: gradients through the batched linear drivers
(``linsolve_{cg,gmres,minres,bicgstab}_batched``, ``ad/batched.py``) against
``jax.grad`` of the sum over ``jax.vmap`` of the JAX package's ``linsolve``
with the same algorithm, on the CPU.

Each rule's JAX reference is compiled once for the module (``lru_cache``):
the problems' matrices ride in a ``ParametricOperator`` as data, so one
compiled ``grad∘vmap`` serves a sequence of operators (``in_dims`` 0: ``P``
matrices) and a shared operator (the same matrix ``P`` times, whose
gradient is the sum over the problems, as ``jax.vmap`` with ``in_axes=None``
gives).  Real float64, so torch's gradient equals ``jax.grad``'s (in
general it is its conjugate, ``ad/linsolve.py``).

Tolerances: the gradients with respect to the matrices, ``b``, ``a0`` and
``a1`` within :data:`TOL` of JAX's (relative to the largest entry); each
problem's within :data:`TOL_ONE` of its one-problem ``kt.linsolve``
gradient, bit for bit where the batched driver keeps the one-problem
applies (``b``'s gradient and the forward ``x`` under a shared matrix,
applied row by row); the counts of the forward and of the backward's
adjoint solves equal to the one-problem solves'.
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import krylovkit_tpu as kk
import krylovkit_tpu_torch as kt
from krylovkit_tpu_torch.solvers import batched as tb
from krylovkit_tpu_torch.solvers import batched_linsolve as tbl
from krylovkit_tpu_torch.solvers import linsolve as tlin

N, P = 16, 3
TOL = 1e-10
TOL_ONE = 1e-12
RULES = ("cg", "gmres", "minres", "bicgstab")
KW = {"cg": {"tol": 1e-12, "maxiter": 100}, "gmres": {"tol": 1e-12, "krylovdim": N},
      "minres": {"tol": 1e-12, "maxiter": 100}, "bicgstab": {"tol": 1e-12, "maxiter": 100}}
CLS = {"cg": "CG", "gmres": "GMRES", "minres": "MINRES", "bicgstab": "BiCGStab"}
A0, A1 = 0.4, 1.3


def _data(seed=0):
    """``P`` SPD matrices, right-hand sides and loss directions."""
    rng = np.random.default_rng(seed)
    As = np.stack([(lambda B: B @ B.T / N + np.eye(N))(rng.standard_normal((N, N)))
                   for _ in range(P)])
    return As, rng.standard_normal((P, N)), rng.standard_normal((P, N))


@lru_cache(maxsize=None)
def _jax_grad(rule, tree=False):
    """``jax.grad`` of ``Σ_p ⟨c_p, x_p⟩`` over ``jax.vmap`` of
    ``kk.linsolve``: the gradients of the matrices, the right-hand sides
    (for ``tree``, a ``(b, b/2)`` tuple a problem and the map ``(m x₁, m
    x₂)``), ``a0`` and ``a1``; compiled once."""
    alg = getattr(kk, CLS[rule])(**KW[rule])

    def loss(As, B, C, a0, a1):
        def one(A, b):
            if tree:
                op = kk.ParametricOperator(lambda m, v: (m @ v[0], m @ v[1]), A)
                b = (b, 0.5 * b)
                x0 = (jnp.zeros_like(b[0]), jnp.zeros_like(b[1]))
            else:
                op = kk.ParametricOperator(lambda m, x: m @ x, A)
                x0 = jnp.zeros_like(b)
            x = kk.linsolve(op, b, x0, a0, a1, alg=alg)[0]
            return (x[0] + x[1]) if tree else x

        return jnp.sum(jax.vmap(one)(As, B) * C)

    return jax.jit(jax.grad(loss, argnums=(0, 1, 3, 4)))


def _jax(rule, As, B, C, tree=False):
    g = _jax_grad(rule, tree)(jnp.asarray(As), jnp.asarray(B), jnp.asarray(C),
                              jnp.float64(A0), jnp.float64(A1))
    return [np.asarray(x) for x in g]


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, np.abs(want).max()))


def _alg(rule):
    return getattr(kt, CLS[rule])(**KW[rule])


def _driver(rule):
    return getattr(kt, f"linsolve_{rule}_batched")


@pytest.fixture
def infos(monkeypatch):
    """The ``info`` of every call of the batched driver's module function
    and of the one-problem ``_linsolve_impl`` (forward and backward solves
    both pass there), recorded in call order."""
    seen = {"batched": [], "one": []}

    def recording(module, name, key):
        fn = getattr(module, name)

        def rec(*a, **kw):
            out = fn(*a, **kw)
            seen[key].append(out[-1])
            return out

        monkeypatch.setattr(module, name, rec)

    for rule in RULES:
        recording(tb if rule == "gmres" else tbl, f"linsolve_{rule}_batched", "batched")
    recording(tlin, "_linsolve_impl", "one")
    return seen


def _one_problem(rule, A, b, c):
    """One problem's ``kt.linsolve`` and its gradients ``(x, [Ā, b̄, ā0,
    ā1])``."""
    At, bt = torch.tensor(A, requires_grad=True), torch.tensor(b, requires_grad=True)
    a0, a1 = (torch.tensor(a, dtype=torch.float64, requires_grad=True) for a in (A0, A1))
    x, _ = kt.linsolve(At, bt, torch.zeros_like(bt), a0, a1, alg=_alg(rule))
    torch.sum(x * torch.from_numpy(c)).backward()
    return x.detach(), [At.grad, bt.grad, a0.grad, a1.grad]


def _counts(info, p=None):
    keys = ("numops", "numiter", "converged")
    if p is None:
        return [int(getattr(info, k)) for k in keys]
    return [int(getattr(info, k)[p]) for k in keys]


def _batched(rule, As, B, C, shared):
    """The batched solve differentiated: ``(x, info, [Ā, b̄, ā0, ā1])``,
    ``Ā`` the stack's gradient (or the shared matrix's)."""
    S = torch.tensor(As[0] if shared else As, requires_grad=True)
    Bt = torch.tensor(B, requires_grad=True)
    a0, a1 = (torch.tensor(a, dtype=torch.float64, requires_grad=True) for a in (A0, A1))
    ops = S if shared else [kt.MatrixOperator(S[p]) for p in range(P)]
    X, info = _driver(rule)(ops, Bt, torch.zeros_like(Bt), a0, a1, _alg(rule),
                            in_dims=(None if shared else 0, 0, 0))
    torch.sum(X * torch.from_numpy(C)).backward()
    return X.detach(), info, [S.grad, Bt.grad, a0.grad, a1.grad]


@pytest.mark.parametrize("rule", RULES)
def test_batched_linear_rule_with_a_sequence_of_operators_matches_jax(rule, infos):
    """``P`` matrices (``in_dims`` 0, views of one stack that requires
    grad), a batched ``b`` and shared ``a0``, ``a1``: every gradient
    within :data:`TOL` of ``jax.grad`` over ``jax.vmap``; each problem's
    matrix and ``b`` gradients within :data:`TOL_ONE` of its one-problem
    gradient, the shift gradients of the sum of the one-problem ones; the
    forward's and the backward's counts the one-problem solves'."""
    As, B, C = _data()
    X, info, (gA, gB, g0, g1) = _batched(rule, As, B, C, shared=False)
    back = infos["batched"][-1]
    jA, jB, j0, j1 = _jax(rule, As, B, C)
    for got, want in ((gA, jA), (gB, jB), (g0, j0), (g1, j1)):
        _close(got, want)
    infos["one"].clear()
    sums = [0.0, 0.0]
    for p in range(P):
        x1, (oA, oB, o0, o1) = _one_problem(rule, As[p], B[p], C[p])
        _close(X[p], x1, TOL_ONE)
        _close(gA[p], oA, TOL_ONE)
        _close(gB[p], oB, TOL_ONE)
        sums = [sums[0] + o0, sums[1] + o1]
        fwd, bwd = infos["one"][-2:]
        assert _counts(info, p) == _counts(fwd) and _counts(back, p) == _counts(bwd)
    _close(g0, sums[0], TOL_ONE)
    _close(g1, sums[1], TOL_ONE)


@pytest.mark.parametrize("rule", RULES)
def test_batched_linear_rule_with_a_shared_operator_matches_jax(rule, infos):
    """One matrix for every problem (``in_dims`` ``None``): its gradient is
    the sum over the problems, within :data:`TOL` of the JAX reference on
    the matrix repeated; each problem's ``x`` and ``b̄`` are its
    one-problem solve's bits, the matrix gradient within :data:`TOL_ONE`
    of the sum of the one-problem ones, and the counts equal."""
    As, B, C = _data(1)
    X, info, (gA, gB, g0, g1) = _batched(rule, As, B, C, shared=True)
    back = infos["batched"][-1]
    jA, jB, j0, j1 = _jax(rule, np.stack([As[0]] * P), B, C)
    for got, want in ((gA, jA.sum(0)), (gB, jB), (g0, j0), (g1, j1)):
        _close(got, want)
    infos["one"].clear()
    total = 0.0
    for p in range(P):
        x1, (oA, oB, _, _) = _one_problem(rule, As[0], B[p], C[p])
        assert torch.equal(X[p], x1) and torch.equal(gB[p], oB)
        total = total + oA
        fwd, bwd = infos["one"][-2:]
        assert _counts(info, p) == _counts(fwd) and _counts(back, p) == _counts(bwd)
    _close(gA, total, TOL_ONE)


def test_batched_cg_rule_with_a_tree_b_and_a_shared_b_matches_jax():
    """CG on ``(b, b/2)`` tuple right-hand sides under ``P`` matrices, each
    leaf's gradient against the JAX tree reference (``b̄`` its two leaves'
    sum, ``x₁ + x₂`` the loss's vector); and one right-hand side shared by
    the problems (``in_dims`` ``None``), whose gradient is the sum of the
    per-problem ones."""
    As, B, C = _data(2)
    S = torch.tensor(As, requires_grad=True)
    Bt = torch.tensor(B, requires_grad=True)
    tree = (Bt, 0.5 * Bt)
    ops = [kt.ParametricOperator(lambda m, v: (m @ v[0], m @ v[1]), S[p]) for p in range(P)]
    a0, a1 = (torch.tensor(a, dtype=torch.float64, requires_grad=True) for a in (A0, A1))
    X, info = kt.linsolve_cg_batched(ops, tree, tuple(torch.zeros_like(Bt) for _ in tree), a0,
                                     a1, _alg("cg"), in_dims=(0, 0, 0))
    torch.sum((X[0] + X[1]) * torch.from_numpy(C)).backward()
    jA, jB, j0, j1 = _jax("cg", As, B, C, tree=True)
    for got, want in ((S.grad, jA), (Bt.grad, jB), (a0.grad, j0), (a1.grad, j1)):
        _close(got, want)
    # a shared b: the sum of the batched-b reference's rows
    S = torch.tensor(As, requires_grad=True)
    b = torch.tensor(B[0], requires_grad=True)
    X, _ = kt.linsolve_cg_batched([kt.MatrixOperator(S[p]) for p in range(P)], b,
                                  torch.zeros_like(b), A0, A1, _alg("cg"),
                                  in_dims=(0, None, None))
    torch.sum(X * torch.from_numpy(C)).backward()
    jA, jB, _, _ = _jax("cg", As, np.stack([B[0]] * P), C)
    _close(S.grad, jA)
    _close(b.grad, jB.sum(0))
