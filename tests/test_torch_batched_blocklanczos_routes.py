"""PyTorch port: the remaining routes of the batched Block Lanczos
``eigsolve`` (``solvers/batched_blocklanczos.py``): complex128 Hermitian
matrices and ``BlockLanczos(eager=True)`` against ``jax.jit(jax.vmap(...))``
of the JAX package's ``eigsolve_blocklanczos``, a space with its own inner
product and the projection flag (the plain twin of K5) against the port's
one-problem solve.

Tolerances, stated per test: counts exactly equal to the JAX package's,
values within 1e-10 of its values and of ``numpy.linalg.eigvalsh``; against
the one-problem solve each problem bit-identical (``torch.equal``) on a
shared operator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from chip_smoke import poisson_coo
from krylovkit_tpu import BlockLanczos as JBlockLanczos
from krylovkit_tpu.ops.operator import MatrixOperator as JMatrixOperator
from krylovkit_tpu.solvers.blocklanczos import eigsolve_blocklanczos as j_blocklanczos
import krylovkit_tpu_torch as kt
from krylovkit_tpu_torch import convert
from krylovkit_tpu_torch.ops import basis as tbs
from krylovkit_tpu_torch.ops import projections as pb
from krylovkit_tpu_torch.ops.operator import as_operator
from krylovkit_tpu_torch.solvers.blocklanczos import eigsolve_blocklanczos as t_blocklanczos

torch.set_num_threads(2)

N, P, B = 24, 3, 2
KW = dict(krylovdim=12, tol=1e-10, maxiter=40)


def _counts(info):
    return [np.asarray(info.numops).tolist(), np.asarray(info.numiter).tolist(),
            np.asarray(info.converged).tolist()]


def _matrices(seed, complex_=False):
    """Three Hermitian matrices ``a + aᴴ`` and three start blocks of 2."""
    rng = np.random.default_rng(seed)

    def draw(shape):
        x = rng.standard_normal(shape)
        return x + 1j * rng.standard_normal(shape) if complex_ else x

    As = []
    for _ in range(P):
        a = draw((N, N))
        As.append(a + a.conj().T)
    return np.stack(As), np.stack([draw((B, N)) for _ in range(P)])


def _jax(As, X, alg, in_axes):
    solve = jax.jit(jax.vmap(lambda A, X: j_blocklanczos(JMatrixOperator(A), X, 2, "LR", alg),
                             in_axes=in_axes))
    return solve(jnp.asarray(As), jnp.asarray(X))


def test_complex_hermitian_stack_matches_jax():
    """Three complex128 Hermitian 24 × 24 matrices, a start block each
    (``in_dims=(0, 0)``), 2 "LR": counts equal to ``jax.vmap``'s, values
    within 1e-10 of the JAX package's and of ``numpy.linalg.eigvalsh``,
    complex128 vectors."""
    As, Xs = _matrices(21, complex_=True)
    vj, _, ij = _jax(As, Xs, JBlockLanczos(**KW), (0, 0))
    vals, vecs, info = kt.eigsolve_blocklanczos_batched(
        convert.matrices_from_numpy(As, "cpu"), torch.from_numpy(Xs), 2, "LR",
        kt.BlockLanczos(**KW), in_dims=(0, 0))
    assert _counts(info) == _counts(ij) and info.converged.tolist() == [2] * P
    assert vecs.dtype == torch.complex128 and vals.dtype == torch.float64
    np.testing.assert_allclose(vals.numpy(), np.asarray(vj), rtol=0, atol=1e-10)
    for p in range(P):
        np.testing.assert_allclose(vals[p].numpy(), np.linalg.eigvalsh(As[p])[::-1][:2], rtol=0,
                                   atol=1e-10)


def test_eager_matches_jax():
    """``BlockLanczos(eager=True)``: a round after every block step once
    ``k >= howmany``, as in the JAX package, where ``jax.vmap`` batches the
    loop condition.  The three float64 matrices of
    ``test_torch_batched_blocklanczos.py`` with one shared start block:
    counts equal to ``jax.vmap``'s (74 / 64 / 72), values within 1e-10, and
    each problem's counts equal to its one-problem eager solve's."""
    rng = np.random.default_rng(7)
    As = []
    for _ in range(P):
        a = rng.standard_normal((N, N))
        As.append(a + a.T)
    As, X0 = np.stack(As), rng.standard_normal((B, N))
    vj, _, ij = _jax(As, X0, JBlockLanczos(**KW, eager=True), (0, None))
    alg = kt.BlockLanczos(**KW, eager=True)
    vals, _, info = kt.eigsolve_blocklanczos_batched(
        convert.matrices_from_numpy(As, "cpu"), torch.from_numpy(X0), 2, "LR", alg,
        in_dims=(0, None))
    assert _counts(info) == _counts(ij)
    assert _counts(info)[0] == [74, 64, 72]
    np.testing.assert_allclose(vals.numpy(), np.asarray(vj), rtol=0, atol=1e-10)
    for p in range(P):
        _, _, i1 = t_blocklanczos(as_operator(torch.from_numpy(As[p])), torch.from_numpy(X0), 2,
                                  "LR", alg)
        assert [i1.numops, i1.numiter, i1.converged] == [c[p] for c in _counts(info)]


def test_custom_inner_product_space_is_each_problems_one_problem_solve():
    """A space with its own inner product (``VectorSpace(inner_fn=...)``,
    twice the Euclidean one: the block QR, the Gram products and the norms
    run in it), one shared float64 matrix and three start blocks, 2 "LR":
    every problem bit-identical to its one-problem solve in the same space
    (values, vectors, residuals, residual norms, counts); values within
    1e-10 of ``numpy.linalg.eigvalsh``."""
    As, Xs = _matrices(22)
    A, X = torch.from_numpy(As[0]), torch.from_numpy(Xs)
    space = kt.VectorSpace(inner_fn=lambda x, y: 2.0 * torch.vdot(x, y))
    alg = kt.BlockLanczos(**KW)
    vals, vecs, info = kt.eigsolve_blocklanczos_batched(A, X, 2, "LR", alg, space)
    assert info.converged.tolist() == [2] * P
    np.testing.assert_allclose(vals.numpy(), np.broadcast_to(np.linalg.eigvalsh(As[0])[::-1][:2],
                                                             (P, 2)), rtol=0, atol=1e-10)
    for p in range(P):
        v1, w1, i1 = t_blocklanczos(as_operator(A), X[p], 2, "LR", alg, space)
        assert torch.equal(vals[p], v1) and torch.equal(vecs[p], w1)
        assert torch.equal(info.residual[p], i1.residual)
        assert torch.equal(info.normres[p], i1.normres)
        assert [i1.numops, i1.numiter, i1.converged] == [c[p] for c in _counts(info)]


def test_projection_flag_batches_k5_bit_for_bit(monkeypatch):
    """The float32 Poisson matrix of the 32 × 32 grid (``(8, 128)``
    vectors) as one shared banded operator, three start blocks of 4, fixed
    work (tol 1e-30, krylovdim 16, maxiter 3), with the projection flag on:
    each problem bit-identical to its one-problem solve with the flag on;
    every block QR column pass is one batched call of the plain K5 twin for
    the problems that step (2·b a QR: the start's and each block step's),
    none a one-problem call, and no K6 (the QR subtracts by
    ``tensordot``)."""
    op = kt.banded_from_coo(*poisson_coo(np, 32, np.float32), 1024, device="cpu")
    X = torch.from_numpy(np.random.default_rng(23).standard_normal((P, 4, 8, 128))
                         .astype(np.float32))
    alg = kt.BlockLanczos(krylovdim=16, tol=1e-30, maxiter=3)
    names = ("project_pallas", "unproject_pallas", "project_pallas_batched",
             "unproject_pallas_batched")
    calls = dict.fromkeys(names, 0)
    for name in names:
        def counting(*a, _inner=getattr(pb, name), _name=name, **kw):
            calls[_name] += 1
            return _inner(*a, **kw)

        monkeypatch.setattr(pb, name, counting)
    monkeypatch.setattr(tbs, "use_pallas_projections", True)
    vals, vecs, info = kt.eigsolve_blocklanczos_batched(op, X, 4, "LR", alg)
    batched = dict(calls)
    numops = info.numops.tolist()
    assert numops == [numops[0]] * P and info.numiter.tolist() == [3] * P
    qrs = 1 + numops[0] // 4
    assert batched == {"project_pallas": 0, "unproject_pallas": 0,
                       "project_pallas_batched": 2 * 4 * qrs, "unproject_pallas_batched": 0}
    for p in range(P):
        v1, w1, i1 = t_blocklanczos(op, X[p], 4, "LR", alg)
        assert torch.equal(vals[p], v1) and torch.equal(vecs[p], w1)
        assert torch.equal(info.normres[p], i1.normres)
        assert [i1.numops, i1.numiter] == [numops[p], 3]
    assert calls["project_pallas"] == P * 2 * 4 * qrs
