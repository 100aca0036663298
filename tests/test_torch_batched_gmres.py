"""PyTorch port: batched GMRES (``solvers/batched.py:linsolve_gmres_batched``)
against ``jax.jit(jax.vmap(...))`` of the JAX package's ``linsolve_gmres``
on the same numpy-seeded inputs, and each problem against the port's own
one-problem solve.

Tolerances: float64 ``x`` within 1e-10 of the JAX package's and 1e-12 of
the port's one-problem solves; the fused float32 cycle's ``x`` within 1e-5
of its largest entry (float32 rounding of two differently ordered sums);
counts always exactly equal.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from batched_grad_specs import check_one_rank_axis
from krylovkit_tpu import GMRES as JGMRES
from krylovkit_tpu.factorizations import krylov as jkf
from krylovkit_tpu.ops.operator import MatrixOperator as JMatrixOperator
from krylovkit_tpu.parallel import poisson_2d as j_poisson_2d
from krylovkit_tpu.solvers.gmres import linsolve_gmres as j_linsolve_gmres
import krylovkit_tpu_torch as kt
from krylovkit_tpu_torch import convert
from krylovkit_tpu_torch.solvers.gmres import linsolve_gmres as t_linsolve_gmres
from testsetup import rand_mat, rand_vec

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _interpret_mode():
    old = jkf.fused_interpret
    jkf.fused_interpret = True
    yield
    jkf.fused_interpret = old


def _counts(info):
    return [np.asarray(info.numops).tolist(), np.asarray(info.numiter).tolist(),
            np.asarray(info.converged).tolist()]


def _jax_vmap(op, Bs, a0, alg):
    dt = Bs.dtype

    def solve_one(b):
        return j_linsolve_gmres(op, b, jnp.zeros_like(b), jnp.asarray(a0, dt), jnp.asarray(1, dt),
                                alg)

    return jax.jit(jax.vmap(solve_one))(jnp.asarray(Bs))


def test_vmap_of_matrix_gmres_matches_jax():
    """(b) ``tests/test_modes.py:135-156``: four float64 right-hand sides,
    one shared matrix; ``x`` within 1e-10, counts equal."""
    rng = np.random.default_rng(118)
    A = rand_mat(rng, 20, 20, np.float64) + 2 * np.eye(20)
    Bs = np.stack([rand_vec(rng, 20, np.float64) for _ in range(4)])
    jalg = JGMRES(krylovdim=20, tol=1e-10, maxiter=10)
    jx, jinfo = _jax_vmap(JMatrixOperator(jnp.asarray(A)), Bs, 0.0, jalg)
    tx, tinfo = kt.linsolve_gmres_batched(
        convert.matrix_from_numpy(A, "cpu"), torch.from_numpy(Bs), torch.zeros(4, 20,
                                                                               dtype=torch.float64),
        0.0, 1.0, kt.GMRES(krylovdim=20, tol=1e-10, maxiter=10))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-10)
    np.testing.assert_allclose(tx.numpy(), np.linalg.solve(A, Bs.T).T, atol=1e-8)
    assert _counts(tinfo) == _counts(jinfo)
    assert tinfo.numops.dtype == torch.int64 and tinfo.normres.shape == (4,)
    assert tinfo.residual.shape == (4, 20)


def test_vmap_of_fused_gmres_matches_jax():
    """(d) fused float32 GMRES on ``poisson_2d(128, 128)`` with ``a0 =
    0.5``, three right-hand sides, ``GMRES(krylovdim=16, tol=1e-4,
    maxiter=10)`` (the JAX side's K1 in Pallas interpret mode): counts
    equal, ``x`` within 1e-5 of its largest entry.  The right-hand sides
    have norms 1, 2 and 3, so the problems stop at different steps (22, 23
    and 24 applies) and ``tol`` stays well above the float32 floor of
    ``‖b‖``, where the two packages' counts may differ by a restart."""
    Bs = np.stack([(np.random.default_rng(30 + i).standard_normal((128, 128)) / 128 * (1 + i))
                   .astype(np.float32) for i in range(3)])
    jalg = JGMRES(krylovdim=16, tol=1e-4, maxiter=10)
    jx, jinfo = _jax_vmap(j_poisson_2d(128, 128, jnp.float32), Bs, 0.5, jalg)
    top = kt.poisson_2d(128, 128, device="cpu")
    assert kt.factorizations.krylov.fused_available(top, torch.from_numpy(Bs[0]), kt.STANDARD,
                                                    kmax=17)
    tx, tinfo = kt.linsolve_gmres_batched(top, torch.from_numpy(Bs), torch.zeros(3, 128, 128),
                                          0.5, 1.0, kt.GMRES(krylovdim=16, tol=1e-4, maxiter=10))
    assert _counts(tinfo) == _counts(jinfo)
    assert len(set(tinfo.numops.tolist())) == 3, tinfo.numops
    jxn = np.asarray(jx)
    assert np.max(np.abs(tx.numpy() - jxn)) <= 1e-5 * np.max(np.abs(jxn))


@pytest.mark.parametrize("fused", [False, True])
def test_batched_gmres_equals_one_problem_solves(fused):
    """(e) each problem of a batched solve against the port's one-problem
    solve: float64 matrices (one per problem, a (P, n, n) stack) with
    restarts, ``x`` within 1e-12, counts equal; and the fused float32 cycle,
    whose CPU plain versions run the same arithmetic per problem (bit-equal
    ``x``, counts equal)."""
    if fused:
        rngs = [np.random.default_rng(60 + i) for i in range(3)]
        Bs = np.stack([r.standard_normal((64, 128)).astype(np.float32) for r in rngs])
        ops = kt.poisson_2d(64, 128, device="cpu")
        in_dims, a0 = (None, 0, 0), 0.25
        alg = kt.GMRES(krylovdim=12, tol=1e-5, maxiter=20)
    else:
        rng = np.random.default_rng(61)
        As = np.stack([rand_mat(rng, 60, 60, np.float64) + 1.2 * np.eye(60) for _ in range(3)])
        Bs = np.stack([rand_vec(rng, 60, np.float64) for _ in range(3)])
        ops = convert.matrices_from_numpy(As, "cpu")
        in_dims, a0 = (0, 0, 0), 0.0
        alg = kt.GMRES(krylovdim=8, tol=1e-10, maxiter=40)
    X0 = torch.zeros(Bs.shape, dtype=torch.from_numpy(Bs).dtype)
    x, info = kt.linsolve_gmres_batched(ops, torch.from_numpy(Bs), X0, a0, 1.0, alg,
                                        in_dims=in_dims)
    assert min(info.numiter.tolist()) > 1  # restarts happen
    for p in range(3):
        op = ops if in_dims[0] is None else ops[p]
        x1, i1 = t_linsolve_gmres(op, torch.from_numpy(Bs[p]), X0[p], a0, 1.0, alg)
        assert [i1.numops, i1.numiter, i1.converged] == [int(info.numops[p]),
                                                         int(info.numiter[p]),
                                                         int(info.converged[p])]
        if fused:
            assert torch.equal(x[p], x1)
        else:
            np.testing.assert_allclose(x[p].numpy(), x1.numpy(), rtol=0, atol=1e-12)


def test_batched_gmres_warn_lines_match_jax_vmap():
    """(g) at WARN, one line per unconverged problem, with the one-problem
    text (the residual norms compared to 1e-6 relative).  The port prints
    them in problem order; the JAX package's vmapped callbacks need not,
    so the lines are compared in the order of their residual norms."""
    rng = np.random.default_rng(120)
    A = rand_mat(rng, 20, 20, np.float64) + 2 * np.eye(20)
    Bs = np.stack([np.zeros(20)] + [rand_vec(rng, 20, np.float64) for _ in range(2)])
    Bs[0, 0] = 1e-12  # within tolerance at the start: converged

    def capture(fn):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            fn()
            jax.effects_barrier()
        return [line for line in buf.getvalue().splitlines() if line.strip()]

    jalg = JGMRES(krylovdim=3, tol=1e-10, maxiter=2, verbosity=1)
    jlines = capture(lambda: np.asarray(_jax_vmap(JMatrixOperator(jnp.asarray(A)), Bs, 0.0,
                                                  jalg)[0]))
    tlines = capture(lambda: kt.linsolve_gmres_batched(
        convert.matrix_from_numpy(A, "cpu"), torch.from_numpy(Bs), torch.zeros(3, 20,
                                                                               dtype=torch.float64),
        0.0, 1.0, kt.GMRES(krylovdim=3, tol=1e-10, maxiter=2, verbosity=1)))
    assert len(tlines) == len(jlines) == 2

    def parts(lines):
        return sorted((float(line.split("normres = ")[1]), line.split("normres = ")[0])
                      for line in lines)

    tparts, jparts = parts(tlines), parts(jlines)
    assert [t for _, t in tparts] == [j for _, j in jparts]
    np.testing.assert_allclose([v for v, _ in tparts], [v for v, _ in jparts], rtol=1e-6)
    # problem order: problem 1's line, then problem 2's
    want = [kt.linsolve_gmres_batched(
        convert.matrix_from_numpy(A, "cpu"), torch.from_numpy(Bs[p:p + 1]),
        torch.zeros(1, 20, dtype=torch.float64), 0.0, 1.0,
        kt.GMRES(krylovdim=3, tol=1e-10, maxiter=2))[1].normres.item() for p in (1, 2)]
    np.testing.assert_allclose([float(line.split("normres = ")[1]) for line in tlines], want,
                               rtol=1e-12)


def test_batched_gmres_refusals():
    """(h) an operator given no problem axis and problem counts that
    disagree raise ``ValueError``; pytree vectors are batched: each problem
    of a dict batch is its one-problem dict solve, bit for bit, and so on a
    one-rank sharded axis.  Unsharded, the shift's gradient is the sum of
    the one-problem gradients; on a one-rank sharded axis the gradients of
    the shift, ``b`` and the operators are the unsharded batch's, each
    problem's its one-problem sharded solve's, bit for bit."""
    A = torch.eye(8, dtype=torch.float64) * 2
    B = torch.ones(2, 8, dtype=torch.float64)
    alg = kt.GMRES(krylovdim=4)
    from krylovkit_tpu_torch.ops.collectives import MeshAxis
    one = kt.VectorSpace(psum_axis=MeshAxis("vec", None, 1, 0))
    dict_op = kt.as_operator(lambda x: {"b": (A + torch.ones(8, 8, dtype=A.dtype)) @ x["b"]})
    Bd = B * torch.arange(1, 3, dtype=B.dtype)[:, None]
    x, info = kt.linsolve_gmres_batched(dict_op, {"b": Bd}, {"b": torch.zeros_like(B)}, 0.5,
                                        1.0, alg)
    for p in range(2):
        x1, i1 = t_linsolve_gmres(dict_op, {"b": Bd[p]}, {"b": torch.zeros(8, dtype=B.dtype)},
                                  0.5, 1.0, alg)
        assert torch.equal(x["b"][p], x1["b"]) and int(info.numops[p]) == i1.numops
    xs, infos = kt.linsolve_gmres_batched(dict_op, {"b": Bd}, {"b": torch.zeros_like(B)}, 0.5,
                                          1.0, alg, one)
    assert torch.equal(xs["b"], x["b"]) and torch.equal(infos.numops, info.numops)
    check_one_rank_axis("linsolve_gmres_batched")
    a0 = torch.tensor(0.5, dtype=torch.float64, requires_grad=True)
    kt.linsolve_gmres_batched(A, B, torch.zeros_like(B), a0, 1.0, alg)[0].sum().backward()
    want = 0.0
    for p in range(2):
        a01 = torch.tensor(0.5, dtype=torch.float64, requires_grad=True)
        kt.linsolve(A, B[p], torch.zeros_like(B[p]), a01, 1.0, alg=alg)[0].sum().backward()
        want = want + a01.grad
    assert torch.allclose(a0.grad, want, rtol=1e-14, atol=0)
    with pytest.raises(ValueError, match="no leading problem axis"):
        kt.linsolve_gmres_batched(kt.MatrixOperator(A), B, torch.zeros_like(B), 0.0, 1.0, alg,
                                  in_dims=(0, 0, 0))
    with pytest.raises(ValueError, match="disagree"):
        kt.linsolve_gmres_batched([A], B, torch.zeros_like(B), 0.0, 1.0, alg, in_dims=(0, 0, 0))
