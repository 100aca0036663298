"""PyTorch port: batched Block Lanczos ``eigsolve``
(``solvers/batched_blocklanczos.py``) against ``jax.jit(jax.vmap(...))`` of
the JAX package's ``eigsolve_blocklanczos`` on numpy-seeded inputs: three
float64 symmetric matrices with one shared start block, then one start
block per problem with a rank-deficient block; then a shared float64
banded operator (the plain twin of K3), one plane set per problem, the WARN
lines and the refusals.  ``tests/test_torch_batched_blocklanczos_routes.py``
holds the complex, custom-space, ``eager`` and projection-flag routes.

Tolerances, stated per test: counts exactly equal to the JAX package's,
values within 1e-10 of its values; against the port's one-problem
``eigsolve_blocklanczos`` each problem is bit-identical (``torch.equal``)
where its operator applies each row as the one-problem apply does (banded
operators, a shared operator), and within 1e-12 on a matrix stack (one
batched product).
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import ApplyRecorder, poisson_coo
from krylovkit_tpu import BlockLanczos as JBlockLanczos
from krylovkit_tpu.ops.operator import MatrixOperator as JMatrixOperator
from krylovkit_tpu.solvers.blocklanczos import eigsolve_blocklanczos as j_blocklanczos
import krylovkit_tpu_torch as kt
from krylovkit_tpu_torch import convert
from krylovkit_tpu_torch.ops import banded as bd
from krylovkit_tpu_torch.ops.collectives import MeshAxis
from krylovkit_tpu_torch.ops.operator import as_operator
from krylovkit_tpu_torch.solvers import batched as batched_mod
from krylovkit_tpu_torch.solvers.blocklanczos import eigsolve_blocklanczos as t_blocklanczos

torch.set_num_threads(2)

N, P, B = 24, 3, 2
KW = dict(krylovdim=12, tol=1e-10, maxiter=40)


def _problems(seed=7):
    """Three symmetric matrices ``a + aᵀ``, then a shared ``(2, 24)`` start
    block, then three more blocks, problem 1's second row twice its first
    (a rank-1 block)."""
    rng = np.random.default_rng(seed)
    As = []
    for _ in range(P):
        a = rng.standard_normal((N, N))
        As.append(a + a.T)
    X0 = rng.standard_normal((B, N))
    Xs = np.stack([rng.standard_normal((B, N)) for _ in range(P)])
    Xs[1, 1] = 2 * Xs[1, 0]
    return np.stack(As), X0, Xs


def _jax(As, X, in_axes):
    alg = JBlockLanczos(**KW)
    solve = jax.jit(jax.vmap(lambda A, X: j_blocklanczos(JMatrixOperator(A), X, 2, "LR", alg),
                             in_axes=in_axes))
    return solve(jnp.asarray(As), jnp.asarray(X))


def _counts(info):
    return [np.asarray(info.numops).tolist(), np.asarray(info.numiter).tolist(),
            np.asarray(info.converged).tolist()]


def _one_problem_within(As, X0s, vals, info, atol):
    """Each problem against the port's one-problem solve on its matrix:
    counts equal, values within ``atol``."""
    for p in range(P):
        v1, _, i1 = t_blocklanczos(as_operator(torch.from_numpy(As[p])),
                                   torch.from_numpy(X0s[p]), 2, "LR", kt.BlockLanczos(**KW))
        assert [i1.numops, i1.numiter, i1.converged] == [c[p] for c in _counts(info)]
        np.testing.assert_allclose(vals[p].numpy(), v1.numpy(), rtol=0, atol=atol)


def test_stack_of_matrices_with_a_shared_start_block_matches_jax():
    """Three float64 24 × 24 symmetric matrices, one shared start block of
    2 (``in_dims=(0, None)``), 2 "LR": 76 / 64 / 72 applies and 17 / 14 /
    16 iterations, as ``jax.vmap`` gives them; values within 1e-10 of the
    JAX package's and of ``numpy.linalg.eigvalsh``; each problem within
    1e-12 of its one-problem solve, counts equal."""
    As, X0, _ = _problems()
    vj, _, ij = _jax(As, X0, (0, None))
    vals, vecs, info = kt.eigsolve_blocklanczos_batched(
        convert.matrices_from_numpy(As, "cpu"), torch.from_numpy(X0), 2, "LR",
        kt.BlockLanczos(**KW), in_dims=(0, None))
    assert _counts(info) == _counts(ij) == [[76, 64, 72], [17, 14, 16], [2, 2, 2]]
    assert info.numops.dtype == torch.int64 and vals.shape == (P, 2) and vecs.shape == (P, 2, N)
    assert info.normres.shape == (P, 2) and info.residual.shape == (P, 2, N)
    np.testing.assert_allclose(vals.numpy(), np.asarray(vj), rtol=0, atol=1e-10)
    for p in range(P):
        np.testing.assert_allclose(vals[p].numpy(), np.linalg.eigvalsh(As[p])[::-1][:2], rtol=0,
                                   atol=1e-10)
    _one_problem_within(As, [X0] * P, vals, info, 1e-12)


def test_rank_deficient_start_block_per_problem_matches_jax():
    """One start block per problem (``in_dims=(0, 0)``), problem 1's a
    rank-1 block: 88 / 74 / 64 applies and 20 / 6 / 14 iterations, as
    ``jax.vmap`` gives them (each problem compacts its own rank); values
    within 1e-10 of the JAX package's; each problem within 1e-12 of its
    one-problem solve, counts equal."""
    As, _, Xs = _problems()
    vj, _, ij = _jax(As, Xs, (0, 0))
    vals, _, info = kt.eigsolve_blocklanczos_batched(
        convert.matrices_from_numpy(As, "cpu"), torch.from_numpy(Xs), 2, "LR",
        kt.BlockLanczos(**KW), in_dims=(0, 0))
    assert _counts(info) == _counts(ij)
    assert _counts(info)[:2] == [[88, 74, 64], [20, 6, 14]]
    np.testing.assert_allclose(vals.numpy(), np.asarray(vj), rtol=0, atol=1e-10)
    _one_problem_within(As, list(Xs), vals, info, 1e-12)


def _counting(monkeypatch, module, names):
    """Count the calls of ``module.<name>`` for each name, for the test."""
    calls = {name: 0 for name in names}
    for name in names:
        inner = getattr(module, name)

        def counting(*a, _inner=inner, _name=name, **kw):
            calls[_name] += 1
            return _inner(*a, **kw)

        monkeypatch.setattr(module, name, counting)
    return calls


def _poisson(nx):
    return kt.banded_from_coo(*poisson_coo(np, nx, np.float64), nx * nx, device="cpu")


def _assert_bit_identical(ops, X, vals, vecs, info, alg, howmany):
    for p in range(X.shape[0]):
        v1, w1, i1 = t_blocklanczos(ops[p], X[p], howmany, "LR", alg)
        assert torch.equal(vals[p], v1) and torch.equal(vecs[p], w1)
        assert torch.equal(info.residual[p], i1.residual)
        assert torch.equal(info.normres[p], i1.normres)
        assert [i1.numops, i1.numiter, i1.converged] == [c[p] for c in _counts(info)]


def test_shared_banded_operator_is_bit_identical_and_batches_k3(monkeypatch):
    """The 5-point Poisson matrix of the 16 × 16 grid (repeated eigenvalues)
    as one shared float64 ``BandedOperator``, three start blocks of 3
    (``(P, 3, 2, 128)``), 3 "LR": each problem bit-identical to its
    one-problem solve; every lock-step is one batched apply of all the
    stepping problems' rows (each problem's batched rows equal to its
    ``numops``), the K3 wrapper's batched entry runs once per batched apply
    and its one-problem entry never; values within 1e-10 of
    ``numpy.linalg.eigvalsh``."""
    op = _poisson(16)
    X = torch.from_numpy(np.random.default_rng(15).standard_normal((P, 3, 2, 128)))
    alg = kt.BlockLanczos(krylovdim=30, tol=1e-10, maxiter=50)
    calls = _counting(monkeypatch, bd, ("banded_spmv", "banded_spmv_batched"))
    with ApplyRecorder(batched_mod) as rec:
        vals, vecs, info = kt.eigsolve_blocklanczos_batched(op, X, 3, "LR", alg)
    assert calls == {"banded_spmv": 0, "banded_spmv_batched": rec.calls}
    assert rec.per_problem == {p: info.numops[p].item() for p in range(P)}
    assert info.converged.tolist() == [3] * P and vecs.shape == (P, 3, 2, 128)
    D = np.zeros((256, 256))
    rows, cols, v = poisson_coo(np, 16, np.float64)
    D[rows, cols] = v
    want = np.linalg.eigvalsh(D)[::-1][:3]
    np.testing.assert_allclose(vals.numpy(), np.broadcast_to(want, (P, 3)), rtol=0, atol=1e-10)
    _assert_bit_identical([op] * P, X, vals, vecs, info, alg, 3)


def test_plane_set_per_problem_is_bit_identical_and_batches_k3(monkeypatch):
    """Three banded operators whose planes are the 12 × 12 Poisson matrix's
    scaled by ``1 + 0.1·p`` (``convert.banded_batch_from_arrays``;
    ``in_dims=(0, 0)``), block 2, 2 "LR": one batched K3 call a lock-step,
    each row taking its problem's planes, none one-problem; each problem
    bit-identical to its one-problem solve on its own operator, and its
    values ``1 + 0.1·p`` times the first problem's (1e-10)."""
    base = _poisson(12)
    D = np.stack([base.diags.numpy() * (1 + 0.1 * p) for p in range(P)])
    ops = convert.banded_batch_from_arrays(base.offsets, D, base.n, device="cpu")
    X = torch.from_numpy(np.random.default_rng(16).standard_normal((P, 2, 144)))
    alg = kt.BlockLanczos(krylovdim=16, tol=1e-10, maxiter=60)
    calls = _counting(monkeypatch, bd, ("banded_spmv", "banded_spmv_batched"))
    with ApplyRecorder(batched_mod) as rec:
        vals, vecs, info = kt.eigsolve_blocklanczos_batched(ops, X, 2, "LR", alg, in_dims=(0, 0))
    assert calls == {"banded_spmv": 0, "banded_spmv_batched": rec.calls}
    assert rec.per_problem == {p: info.numops[p].item() for p in range(P)}
    assert info.converged.tolist() == [2] * P
    for p in range(P):
        np.testing.assert_allclose(vals[p].numpy(), (1 + 0.1 * p) * vals[0].numpy(), rtol=0,
                                   atol=1e-10)
    _assert_bit_identical(ops, X, vals, vecs, info, alg, 2)


def _capture(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return [line for line in buf.getvalue().splitlines() if line.strip()]


def test_warn_lines_are_the_one_problem_lines_in_problem_order():
    """At WARN, one "stopped without convergence" line per unconverged
    problem, with its one-problem text, in problem order (the matrices of
    the first test, one shared matrix and three start blocks, cut to 3
    iterations)."""
    As, _, Xs = _problems()
    A = torch.from_numpy(As[0])
    X = torch.from_numpy(Xs)
    X[1, 1] = X[1, 0] + 1  # every block full rank
    alg = kt.BlockLanczos(**{**KW, "maxiter": 3, "verbosity": 1})
    lines = _capture(lambda: kt.eigsolve_blocklanczos_batched(A, X, 2, "LR", alg))
    one = []
    for p in range(P):
        one += _capture(lambda p=p: t_blocklanczos(as_operator(A), X[p], 2, "LR", alg))
    assert lines == one and len(lines) == P, (lines, one)
    assert all("BlockLanczos eigsolve stopped without convergence" in t for t in lines)


def test_batched_blocklanczos_refusals():
    """Each piece this slice does not batch raises ``ValueError`` with its
    name: a start or an operator tensor that requires grad (a Block start
    has no rule), ``in_dims`` other than 0 or None, an ``(f, fadjoint)``
    tuple given as a batch, a ``Block`` given as a batch; and the argument
    checks.  A sharded space is batched: on a one-rank axis, the unsharded
    bits, a dict batch too; so are pytree vectors (a dict block per
    problem, a shared ``Block`` of dicts): each problem its one-problem dict
    solve, bit for bit."""
    As, X0, Xs = _problems()
    A = torch.from_numpy(As[0])
    X = torch.from_numpy(Xs)
    alg = kt.BlockLanczos(**KW)
    solve = kt.eigsolve_blocklanczos_batched
    block = kt.Block([torch.from_numpy(x) for x in X0])
    cases = [
        (lambda: solve(A, X.clone().requires_grad_(True), 1, "LR", alg),
         "eigsolve_blocklanczos_batched: differentiation has no rule"),
        (lambda: solve(A.clone().requires_grad_(True), X, 1, "LR", alg), "differentiation"),
        (lambda: solve(A, X, 1, "LR", alg, in_dims=(None, 1)), "in_dims"),
        (lambda: solve((lambda x: A @ x, lambda x: A @ x), X[:2], 1, "LR", alg, in_dims=(0, 0)),
         "one shared operator"),
        (lambda: solve([A] * P, block, 1, "LR", alg, in_dims=(0, 0)), "one shared start block"),
        (lambda: solve(A, X, 13, "LR", alg), "exceeds krylovdim"),
        (lambda: solve([A, A], X, 1, "LR", alg, in_dims=(0, 0)), "disagree"),
    ]
    for call, match in cases:
        with pytest.raises(ValueError, match=match):
            call()
    # a sharded space is batched: on a one-rank axis (no collective) each
    # problem solves as on the unsharded space, bit for bit
    got = solve(A, X, 2, "LR", alg, space=kt.VectorSpace(psum_axis=MeshAxis("vec", None, 1, 0)))
    want = solve(A, X, 2, "LR", alg)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert _counts(got[2]) == _counts(want[2])
    # a (P, b, ...) dict batch, and a shared Block of dicts under P
    # operators: each problem is its one-problem dict solve, bit for bit
    dops = [as_operator(lambda x, A=torch.from_numpy(a): {"a": A @ x["a"]}) for a in As[:P]]
    short = kt.BlockLanczos(**{**KW, "maxiter": 2})
    for ops_, X0_, dims in ((dops[0], {"a": X}, (None, 0)),
                            (dops, kt.Block([{"a": x} for x in X[0]]), (0, None))):
        vals, vecs, info = solve(ops_, X0_, 2, "LR", short, in_dims=dims)
        for p in range(P):
            op1 = ops_[p] if dims[0] == 0 else ops_
            X1 = X[0 if dims[1] is None else p]
            v1, w1, i1 = t_blocklanczos(op1, {"a": X1}, 2, "LR", short)
            assert torch.equal(vals[p], v1) and torch.equal(vecs["a"][p], w1["a"])
            assert int(info.numops[p]) == i1.numops
        got = solve(ops_, X0_, 2, "LR", short, kt.VectorSpace(
            psum_axis=MeshAxis("vec", None, 1, 0)), in_dims=dims)
        assert torch.equal(got[0], vals) and torch.equal(got[1]["a"], vecs["a"])
        assert torch.equal(got[2].numops, info.numops)
    # a shared Block start is taken as its stacked tensor
    vals, _, info = solve(convert.matrices_from_numpy(As, "cpu"), block, 2, "LR", alg,
                          in_dims=(0, None))
    assert _counts(info)[0] == [76, 64, 72]
