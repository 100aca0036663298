"""PyTorch port: batched GKL ``svdsolve`` (``solvers/batched_gkl.py``)
against ``jax.jit(jax.vmap(...))`` of the JAX package's ``svdsolve_gkl`` on
numpy-seeded float64 and complex128 inputs: a stack of three 30 × 20
matrices with one shared start (``in_dims=(0, None)``), one shared matrix
with three starts (``in_dims=(None, 0)``), both ``which``, and restarts
(krylovdim 6 and 10, several rounds each); then the WARN lines, the
``repr``, a ``(f, fadjoint)`` pair as one shared operator, a space with its
own inner product, and the refusals.  The fused float32 route and the projection flag are in
``tests/test_torch_batched_gkl_fused.py``, LSMR in
``tests/test_torch_batched_gkl_lsmr.py``.

Tolerances, stated per test: singular values within 1e-10 of the JAX
package's, the singular vectors through ``‖A v − σ u‖`` (within ``normres``
+ 1e-10), counts exactly equal.  Against the port's own one-problem solve
each problem is bit-identical where its operator applies it alone (a shared
matrix, the pair), and within 1e-12 on a matrix stack (one batched
product).
"""

import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from batched_grad_specs import check_one_rank_axis
from krylovkit_tpu import GKL as JGKL
from krylovkit_tpu.ops.operator import MatrixOperator as JMatrixOperator
from krylovkit_tpu.solvers.svdsolve import svdsolve_gkl as j_svdsolve_gkl
import krylovkit_tpu_torch as kt
from krylovkit_tpu_torch import convert
from krylovkit_tpu_torch.ops.collectives import MeshAxis
from krylovkit_tpu_torch.ops.operator import as_operator
from krylovkit_tpu_torch.solvers.svdsolve import svdsolve_gkl as t_svdsolve_gkl

torch.set_num_threads(2)

M, N, P = 30, 20, 3


def _talg(jalg):
    return convert.gkl_from_dict({**dataclasses.asdict(jalg), "orth": type(jalg.orth).__name__})


def _counts(info):
    return [np.asarray(info.numops).tolist(), np.asarray(info.numiter).tolist(),
            np.asarray(info.converged).tolist()]


def _problems(kind, seed=41):
    """``(As, X)``: three ``M × N`` matrices (real or complex) and three
    starts in their ranges (a component in the left null space stalls "SR"
    in both packages)."""
    rng = np.random.default_rng(seed)
    As = rng.standard_normal((P, M, N))
    V = rng.standard_normal((P, N))
    if kind == "complex":
        As = As + 1j * rng.standard_normal((P, M, N))
        V = V + 1j * rng.standard_normal((P, N))
    return As, np.einsum("pmn,pn->pm", As, V)


def _check_triplets(A, S, U, W, info, p, howmany):
    """``‖A w_i − σ_i u_i‖`` within ``normres_i`` + 1e-10 for the
    ``howmany`` triplets of problem ``p``."""
    for i in range(howmany):
        res = np.linalg.norm(A @ W[p, i] - S[p, i] * U[p, i])
        assert res <= float(info.normres[p, i]) + 1e-10, (p, i, res)


CASES = {
    # name: (kind, in_dims, howmany, which, krylovdim)
    "stack_shared_x0_LR": ("real", (0, None), 3, "LR", 10),
    "stack_shared_x0_SR_restarts": ("real", (0, None), 2, "SR", 6),
    "shared_matrix_starts_SR": ("real", (None, 0), 3, "SR", 10),
    "shared_matrix_starts_LR_restarts": ("real", (None, 0), 2, "LR", 6),
    "complex_stack_LR": ("complex", (0, 0), 3, "LR", 10),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_vmap_of_svdsolve_gkl_matches_jax(name):
    """Each case against ``jax.jit(jax.vmap(svdsolve_gkl))``: counts equal
    per problem, singular values within 1e-10, each triplet's residual
    within its ``normres`` + 1e-10; and each problem against the port's
    one-problem ``svdsolve_gkl`` (bit-identical on a shared matrix, 1e-12 on
    a stack)."""
    kind, (op_dim, x_dim), howmany, which, m = CASES[name]
    As, X = _problems(kind)
    x0 = X[0]
    jalg = JGKL(krylovdim=m, tol=1e-10, maxiter=100)
    A_j = jnp.asarray(As) if op_dim == 0 else jnp.asarray(As[0])
    X_j = jnp.asarray(X) if x_dim == 0 else jnp.asarray(x0)
    f = jax.jit(jax.vmap(lambda A, x: j_svdsolve_gkl(JMatrixOperator(A), x, howmany, which, jalg),
                         in_axes=(op_dim, x_dim)))
    Sj, _, _, ij = f(A_j, X_j)
    op = convert.matrices_from_numpy(As, "cpu") if op_dim == 0 else torch.from_numpy(As[0])
    xt = torch.from_numpy(X) if x_dim == 0 else torch.from_numpy(x0)
    S, U, W, it = kt.svdsolve_gkl_batched(op, xt, howmany, which, _talg(jalg),
                                          in_dims=(op_dim, x_dim))
    assert _counts(it) == _counts(ij), (_counts(it), _counts(ij))
    assert it.numops.dtype == torch.int64 and S.shape == (P, howmany)
    assert U.shape == (P, howmany, M) and W.shape == (P, howmany, N)
    assert it.normres.shape == (P, howmany) and it.residual.shape == (P, howmany, M)
    np.testing.assert_allclose(S.numpy(), np.asarray(Sj), rtol=0, atol=1e-10)
    for p in range(P):
        A = As[p] if op_dim == 0 else As[0]
        _check_triplets(A, S.numpy(), U.numpy(), W.numpy(), it, p, howmany)
        one_op = as_operator(torch.from_numpy(A))
        S1, U1, W1, i1 = t_svdsolve_gkl(one_op, xt[p] if x_dim == 0 else xt, howmany, which,
                                        _talg(jalg))
        assert [i1.numops, i1.numiter, i1.converged] == [c[p] for c in _counts(it)]
        if op_dim is None:
            assert torch.equal(S[p], S1) and torch.equal(U[p], U1) and torch.equal(W[p], W1)
        else:
            np.testing.assert_allclose(S[p].numpy(), S1.numpy(), rtol=0, atol=1e-12)


def test_pair_is_one_shared_operator():
    """A ``(f, fadjoint)`` tuple of two callables is one operator: with
    ``P = 2`` starts (``in_dims=(None, 0)``) each problem is bit-identical
    to its one-problem solve on the pair, and ``in_dims=(0, 0)`` (which
    would read the pair as two problems) raises."""
    As, X = _problems("real", seed=5)
    A = torch.from_numpy(As[0])
    pair = (lambda x: A @ x, lambda y: A.T @ y)
    Xt = torch.from_numpy(X[:2])
    alg = kt.GKL(krylovdim=8, tol=1e-10, maxiter=40)
    S, U, W, it = kt.svdsolve_gkl_batched(pair, Xt, 2, "LR", alg, in_dims=(None, 0))
    assert S.shape == (2, 2) and it.numops.shape == (2,)
    for p in range(2):
        S1, U1, W1, i1 = t_svdsolve_gkl(as_operator(pair), Xt[p], 2, "LR", alg)
        assert torch.equal(S[p], S1) and torch.equal(U[p], U1) and torch.equal(W[p], W1)
        assert [it.numops[p].item(), it.numiter[p].item()] == [i1.numops, i1.numiter]
    with pytest.raises(ValueError, match="one shared operator"):
        kt.svdsolve_gkl_batched(pair, Xt, 2, "LR", alg, in_dims=(0, 0))
    with pytest.raises(ValueError, match="one shared operator"):
        kt.lssolve_lsmr_batched(pair, Xt, kt.LSMR(), in_dims=(0, 0))


def test_custom_inner_product_space_is_each_problems_one_problem_solve():
    """A space with its own inner product (``VectorSpace(inner_fn=...)``,
    twice the Euclidean one, so ``Aᴴ`` stays the adjoint and the singular
    values are ``A``'s): each start is normalised in that space, and every
    problem is bit-identical to its one-problem ``svdsolve_gkl`` in the same
    space (values, vectors, counts), on a shared matrix and on a
    ``(f, fadjoint)`` pair; the values within 1e-10 of numpy's SVD."""
    As, X = _problems("real", seed=12)
    A = torch.from_numpy(As[0])
    space = kt.VectorSpace(inner_fn=lambda x, y: 2.0 * torch.vdot(x, y))
    alg = kt.GKL(krylovdim=10, tol=1e-10, maxiter=100)
    Xt = torch.from_numpy(X)
    want = np.linalg.svd(As[0], compute_uv=False)[:3]
    for op in (A, (lambda x: A @ x, lambda y: A.T @ y)):
        S, U, W, it = kt.svdsolve_gkl_batched(op, Xt, 3, "LR", alg, space)
        assert it.converged.tolist() == [3] * P
        np.testing.assert_allclose(S.numpy(), np.broadcast_to(want, (P, 3)), rtol=0, atol=1e-10)
        for p in range(P):
            S1, U1, W1, i1 = t_svdsolve_gkl(as_operator(op), Xt[p], 3, "LR", alg, space)
            assert torch.equal(S[p], S1) and torch.equal(U[p], U1) and torch.equal(W[p], W1)
            assert [c[p] for c in _counts(it)] == [i1.numops, i1.numiter, i1.converged]


def test_bare_callable_gets_its_adjoint_derived():
    """A bare callable (no adjoint) gets ``require_adjoint``'s derived
    adjoint, as the one-problem front-end gives it, and solves as the
    matrix does (values within 1e-12, counts equal)."""
    _, X = _problems("real", seed=6)
    # square: the derived adjoint takes the shape of x0
    A = torch.from_numpy(np.random.default_rng(6).standard_normal((M, M)))
    alg = kt.GKL(krylovdim=10, tol=1e-10, maxiter=40)
    Xt = torch.from_numpy(X)
    S, _, _, it = kt.svdsolve_gkl_batched(lambda x: A @ x, Xt, 2, "LR", alg)
    Sm, _, _, im = kt.svdsolve_gkl_batched(A, Xt, 2, "LR", alg)
    np.testing.assert_allclose(S.numpy(), Sm.numpy(), rtol=0, atol=1e-12)
    assert _counts(it) == _counts(im)


def _capture(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
        jax.effects_barrier()
    return [line for line in buf.getvalue().splitlines() if line.strip()]


def test_warn_lines_match_jax_vmap_and_one_problem_text():
    """At WARN, one "finished without convergence" line per unconverged
    problem (two of three here: the third converges), with the one-problem
    text, in problem order; the same lines as the JAX package's vmapped
    ``warn_if`` (compared sorted: its callbacks need not print in problem
    order)."""
    As, X = _problems("real", seed=8)
    x0 = X[0]
    jalg = JGKL(krylovdim=6, tol=1e-10, maxiter=2, verbosity=1)
    rng = np.random.default_rng(8)
    # rank 3: the third problem's Krylov space closes after three steps
    As[2] = rng.standard_normal((M, 3)) @ np.diag([3.0, 2.0, 1.0]) @ rng.standard_normal((3, N))
    x0 = np.ones(M)
    f = jax.jit(jax.vmap(lambda A: j_svdsolve_gkl(JMatrixOperator(A), jnp.asarray(x0), 1, "LR",
                                                  jalg)[3].converged))
    jlines = _capture(lambda: np.asarray(f(jnp.asarray(As))))
    talg = _talg(jalg)
    tlines = _capture(lambda: kt.svdsolve_gkl_batched(
        convert.matrices_from_numpy(As, "cpu"), torch.from_numpy(x0), 1, "LR", talg,
        in_dims=(0, None)))
    one = []
    for p in range(P):
        one += _capture(lambda p=p: t_svdsolve_gkl(as_operator(torch.from_numpy(As[p])),
                                                   torch.from_numpy(x0), 1, "LR", talg))
    assert len(tlines) == 2 and tlines == one, (tlines, one)
    assert sorted(tlines) == sorted(jlines), (tlines, jlines)
    assert all("GKL svdsolve finished without convergence: 0 of 1" in t for t in tlines)


def test_repr_of_batched_info():
    """``repr`` of the batched ``ConvergenceInfo`` prints the ``(P,)``
    counts as arrays."""
    As, X = _problems("real", seed=9)
    _, _, _, it = kt.svdsolve_gkl_batched(convert.matrices_from_numpy(As, "cpu"),
                                          torch.from_numpy(X), 1, "LR",
                                          kt.GKL(krylovdim=8, tol=1e-10, maxiter=30),
                                          in_dims=(0, 0))
    text = repr(it)
    counts = _counts(it)
    assert text.startswith(f"ConvergenceInfo: {np.asarray(counts[2])} converged value(s) after "
                           f"{np.asarray(counts[1])} iteration(s) and {np.asarray(counts[0])} "
                           "applications of the linear map"), text


def test_batched_svdsolve_refusals():
    """The argument checks raise ``ValueError`` with the driver's name.  A
    sharded space is batched: on a one-rank axis, the unsharded bits, a
    dict batch too, and the gradient by the Sylvester rule (the unsharded
    batched gradient, each problem its one-problem sharded one, bit for
    bit; the GMRES rule in ``test_torch_batched_eager.py``); so are pytree
    vectors: a dict batch gives each problem its one-problem dict solve,
    bit for bit; so does ``GKL(eager=True)``.  Unsharded, a start or an
    operator that requires grad is differentiated (``ad/batched.py``)."""
    As, X = _problems("real", seed=10)
    A = torch.from_numpy(As[0])
    Xt = torch.from_numpy(X)
    alg = kt.GKL(krylovdim=8)
    one = kt.VectorSpace(psum_axis=MeshAxis("vec", None, 1, 0))
    cases = [
        (lambda: kt.svdsolve_gkl_batched(A, Xt, 1, "LM", alg), "which"),
        (lambda: kt.svdsolve_gkl_batched(A, Xt, 9, "LR", alg), "krylovdim"),
        (lambda: kt.svdsolve_gkl_batched(A, Xt, 1, "LR", alg, in_dims=(None, None)), "in_dims"),
        (lambda: kt.svdsolve_gkl_batched([A], Xt, 1, "LR", alg, in_dims=(0, 0)), "disagree"),
    ]
    for call, word in cases:
        with pytest.raises(ValueError, match=word):
            call()
    check_one_rank_axis("svdsolve_gkl_batched", "arnoldi")
    # a sharded space is batched: on a one-rank axis (no collective) each
    # problem solves as on the unsharded space, bit for bit
    eager = kt.GKL(krylovdim=8, eager=True)
    S, U, V, info = kt.svdsolve_gkl_batched(A, Xt, 1, "LR", eager)
    for p in range(Xt.shape[0]):
        S1, U1, V1, i1 = t_svdsolve_gkl(as_operator(A), Xt[p], 1, "LR", eager)
        assert torch.equal(S[p], S1) and torch.equal(U[p], U1) and torch.equal(V[p], V1)
        assert int(info.numops[p]) == i1.numops
    got = kt.svdsolve_gkl_batched(A, Xt, 1, "LR", alg, space=kt.VectorSpace(psum_axis=MeshAxis("vec", None, 1, 0)))
    want = kt.svdsolve_gkl_batched(A, Xt, 1, "LR", alg)
    assert all(torch.equal(g, w) for g, w in zip(got[:3], want[:3]))
    assert torch.equal(got[3].numops, want[3].numops)
    dpair = (lambda v: {"u": A @ v["v"]}, lambda u: {"v": A.T @ u["u"]})
    S, U, V, info = kt.svdsolve_gkl_batched(dpair, {"u": Xt}, 1, "LR", alg)
    for p in range(Xt.shape[0]):
        S1, U1, V1, i1 = t_svdsolve_gkl(as_operator(dpair), {"u": Xt[p]}, 1, "LR", alg)
        assert torch.equal(S[p], S1) and torch.equal(U["u"][p], U1["u"])
        assert torch.equal(V["v"][p], V1["v"]) and int(info.numops[p]) == i1.numops
    got = kt.svdsolve_gkl_batched(dpair, {"u": Xt}, 1, "LR", alg, one)
    assert torch.equal(got[0], S) and torch.equal(got[1]["u"], U["u"])
    assert torch.equal(got[2]["v"], V["v"]) and torch.equal(got[3].numops, info.numops)
    # unsharded, a start and an operator that require grad are differentiated:
    # the start gets no gradient, the operator its one
    Ag, Xg = A.clone().requires_grad_(True), Xt.clone().requires_grad_(True)
    Sg = kt.svdsolve_gkl_batched(Ag, Xg, 1, "LR", alg)[0]
    Sg.sum().backward()
    assert torch.equal(Sg.detach(), kt.svdsolve_gkl_batched(A, Xt, 1, "LR", alg)[0])
    assert Xg.grad is None and bool(torch.isfinite(Ag.grad).all())
