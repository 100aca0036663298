"""PyTorch port: batched Lanczos eigensolves (``solvers/batched.py``) against
``jax.jit(jax.vmap(...))`` of the JAX package's ``eigsolve_lanczos`` on the
same numpy-seeded inputs, each problem against the port's own one-problem
solve, the plain batched K1/K2 against looped one-problem calls, the WARN
lines, the refusals, and the dtype probe of a ``ParametricOperator`` (no
data apply).  The batched GMRES tests are in
``tests/test_torch_batched_gmres.py``.

Tolerances, stated per test: float64 values 1e-10 against the JAX package
and 1e-12 against the port's one-problem solves (the same arithmetic; the
matrix stack applies as one batched product), float32 fused values 1e-5
relative (float32 rounding of two differently ordered sums), counts always
exactly equal.
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
from krylovkit_tpu import Lanczos as JLanczos
from krylovkit_tpu.factorizations import krylov as jkf
from krylovkit_tpu.ops.operator import MatrixOperator as JMatrixOperator
from krylovkit_tpu.parallel import laplacian_1d as j_laplacian_1d
from krylovkit_tpu.solvers.lanczos import eigsolve_lanczos as j_eigsolve_lanczos
import krylovkit_tpu_torch as kt
from krylovkit_tpu_torch import convert
from krylovkit_tpu_torch.ops import basis as tbs
from krylovkit_tpu_torch.ops import fused_lanczos as tfl
from krylovkit_tpu_torch.ops.collectives import MeshAxis
from krylovkit_tpu_torch.ops.operator import probe_dtype
from krylovkit_tpu_torch.solvers.lanczos import eigsolve_lanczos as t_eigsolve_lanczos
from testsetup import hermitize, rand_mat, rand_vec

torch.set_num_threads(2)

N = 2048  # laplacian_1d(2048): (16, 128) float32 vectors, the fused path


@pytest.fixture(autouse=True)
def _interpret_mode():
    old = jkf.fused_interpret
    jkf.fused_interpret = True
    yield
    jkf.fused_interpret = old


def _talg(jalg):
    return convert.lanczos_from_dict({**dataclasses.asdict(jalg), "orth": type(jalg.orth).__name__})


def _counts(info):
    return [np.asarray(info.numops).tolist(), np.asarray(info.numiter).tolist(),
            np.asarray(info.converged).tolist()]


def _matrix_problems():
    """The problems of ``tests/test_modes.py::test_vmap_batched_eigsolve``."""
    rng = np.random.default_rng(117)
    As = np.stack([hermitize(rand_mat(rng, 20, 20, np.float64)) for _ in range(3)])
    x0 = rand_vec(rng, 20, np.float64)
    return As, x0


def test_vmap_of_matrix_lanczos_matches_jax():
    """(a) ``tests/test_modes.py:113-132``: three 20×20 float64 Hermitian
    matrices, one shared start; values within 1e-10, counts equal."""
    As, x0 = _matrix_problems()
    jalg = JLanczos(krylovdim=20, tol=1e-10, maxiter=10)

    def solve_one(A):
        vals, _, info = j_eigsolve_lanczos(JMatrixOperator(A), jnp.asarray(x0), 2, "LR", jalg)
        return vals, info

    jvals, jinfo = jax.jit(jax.vmap(solve_one))(jnp.asarray(As))
    tvals, tvecs, tinfo = kt.eigsolve_lanczos_batched(
        convert.matrices_from_numpy(As, "cpu"), torch.from_numpy(x0), 2, "LR", _talg(jalg),
        in_dims=(0, None))
    np.testing.assert_allclose(tvals.numpy(), np.asarray(jvals), rtol=0, atol=1e-10)
    assert _counts(tinfo) == _counts(jinfo)
    assert tinfo.numops.dtype == torch.int64 and tinfo.numops.shape == (3,)
    assert tinfo.normres.shape == (3, 2) and tvecs.shape == (3, 2, 20)
    for b in range(3):
        want = np.linalg.eigvalsh(As[b])[::-1][:2]
        np.testing.assert_allclose(tvals[b].numpy(), want, atol=1e-8)
        # the eigenvector equation of each problem's own matrix
        V = tvecs[b].numpy()
        assert np.max(np.abs(As[b] @ V.T - V.T * tvals[b].numpy())) < 1e-8


def _lanczos_fused_both(X, howmany, jalg):
    jop = j_laplacian_1d(N, jnp.float32)
    top = convert.stencil_from_arrays(jop.offsets, jop.coeffs, "cpu")
    f = jax.jit(jax.vmap(lambda x: j_eigsolve_lanczos(jop, x, howmany, "LM", jalg)))
    jvals, _, jinfo = f(jnp.asarray(X))
    tvals, tvecs, tinfo = kt.eigsolve_lanczos_batched(top, torch.from_numpy(X), howmany, "LM",
                                                      _talg(jalg))
    assert kt.factorizations.krylov.fused_available(top, torch.from_numpy(X[0]), kt.STANDARD,
                                                    kmax=jalg.krylovdim + 1)
    return (jvals, jinfo), (tvals, tvecs, tinfo), top


def _starts(P, seed=10):
    return np.stack([np.random.default_rng(seed + i).standard_normal((N // 128, 128))
                     .astype(np.float32) for i in range(P)])


@pytest.mark.parametrize("howmany, tol, maxiter, apart", [
    (3, 1e-4, 3, False),   # every problem runs to maxiter: 36 / 3 each
    (1, 1e-3, 30, True),   # the problems converge at restarts 21, 25 and 22
])
def test_vmap_of_fused_lanczos_matches_jax(howmany, tol, maxiter, apart):
    """(c) fused float32 Lanczos on ``laplacian_1d(2048)``, P = 3,
    ``krylovdim=20`` (the JAX side's K1/K2 in Pallas interpret mode, the
    port's plain versions): counts equal, values within 1e-5 relative; in
    the second case the problems stop at different restarts, so the
    batched step carries a different ``kp1``/``B`` per problem."""
    X = _starts(3)
    jalg = JLanczos(krylovdim=20, tol=tol, maxiter=maxiter)
    (jvals, jinfo), (tvals, _, tinfo), _ = _lanczos_fused_both(X, howmany, jalg)
    assert _counts(tinfo) == _counts(jinfo)
    np.testing.assert_allclose(tvals.numpy(), np.asarray(jvals), rtol=1e-5)
    if apart:
        assert len(set(tinfo.numiter.tolist())) >= 2, tinfo.numiter
    else:
        assert tinfo.numops.tolist() == [36, 36, 36] and tinfo.numiter.tolist() == [3, 3, 3]


def test_batched_lanczos_equals_one_problem_solves():
    """(e) each problem of a batched solve against the port's one-problem
    solve of it: float64 matrices with restarts (values 1e-12, counts
    equal), and the fused float32 path, whose CPU plain versions run the
    same arithmetic per problem (bit-equal values, counts equal)."""
    rng = np.random.default_rng(5)
    As = np.stack([hermitize(rand_mat(rng, 100, 100, np.float64)) for _ in range(3)])
    X0 = np.stack([rand_vec(rng, 100, np.float64) for _ in range(3)])
    alg = kt.Lanczos(krylovdim=20, tol=1e-10, maxiter=50)
    ops = convert.matrices_from_numpy(As, "cpu")
    vals, vecs, info = kt.eigsolve_lanczos_batched(ops, torch.from_numpy(X0), 3, "SR", alg,
                                                   in_dims=(0, 0))
    assert min(info.numiter.tolist()) > 1  # restarts happen
    for p in range(3):
        v1, w1, i1 = t_eigsolve_lanczos(ops[p], torch.from_numpy(X0[p]), 3, "SR", alg)
        assert [i1.numops, i1.numiter, i1.converged] == [int(info.numops[p]),
                                                         int(info.numiter[p]),
                                                         int(info.converged[p])]
        np.testing.assert_allclose(vals[p].numpy(), v1.numpy(), rtol=0, atol=1e-12)
        np.testing.assert_allclose(info.normres[p].numpy(), i1.normres.numpy(), atol=1e-12)
        overlap = np.abs(np.sum(vecs[p].numpy() * w1.numpy(), axis=1))
        np.testing.assert_allclose(overlap, 1, atol=1e-10)

    X = _starts(3, seed=40)
    top = kt.laplacian_1d(N, device="cpu")
    alg = kt.Lanczos(krylovdim=20, tol=1e-3, maxiter=30)
    vals, vecs, info = kt.eigsolve_lanczos_batched(top, torch.from_numpy(X), 1, "LM", alg)
    for p in range(3):
        v1, w1, i1 = t_eigsolve_lanczos(top, torch.from_numpy(X[p]), 1, "LM", alg)
        assert [i1.numops, i1.numiter, i1.converged] == [int(info.numops[p]),
                                                         int(info.numiter[p]),
                                                         int(info.converged[p])]
        assert torch.equal(vals[p], v1) and torch.equal(vecs[p], w1)


@pytest.mark.parametrize("drift", [False, True])
def test_plain_batched_fused_step_is_the_looped_one_problem_step(drift):
    """(f) K1's plain batched version against one-problem plain calls, per
    problem ``kp1``/``B`` (one at ``B = 0``): bit-identical; an inactive
    problem's basis untouched and its rows of the outputs zero, each
    problem's ``raw`` zero beyond its own length."""
    op = kt.poisson_2d(16, 128, device="cpu")
    spec = tfl.spec_for(op)
    gen = torch.Generator().manual_seed(3)
    P, kmax, R = 4, 12, 16
    V = torch.randn((P, kmax, R, 128), generator=gen)
    y = torch.randn((P, R, 128), generator=gen)
    g = torch.randn((P, kmax + 1), generator=gen)
    B, kp1, active = [5, 0, 9, 3], [5, 2, 11, 3], [0, 1, 2]
    Vb = V.clone()
    yn, raw = tfl.fused_step_batched(Vb, y, g, kp1, B, spec, drift, active)
    assert raw.shape == (P, (2 * 9 if drift else 9) + 2)
    for p in active:
        V1 = V[p].clone()
        y1, r1 = tfl.fused_step_reference(V1, y[p], g[p], kp1[p], B[p], spec, drift)
        assert torch.equal(Vb[p], V1) and torch.equal(yn[p], y1)
        assert torch.equal(raw[p, :r1.numel()], r1) and not raw[p, r1.numel():].any()
    assert torch.equal(Vb[3], V[3]) and not yn[3].any() and not raw[3].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_batched_transform_is_the_looped_one_problem_transform(dtype):
    """(f) K2's plain batched version against one-problem plain calls:
    bit-identical rows ``< m_out``, rows ``>= m_out`` and an inactive
    problem untouched, an identity ``U`` leaves its basis bit-identical."""
    gen = torch.Generator().manual_seed(4)
    P, kmax, R, m_out = 4, 31, 16, 20
    V = torch.randn((P, kmax, R, 128), generator=gen).to(dtype)
    U = torch.randn((P, kmax, kmax), generator=gen) / kmax ** 0.5
    U[2] = torch.eye(kmax)
    Vb = tbs.transform_partial_inplace_batched(V.clone(), U, m_out, active=[0, 1, 2])
    for p in (0, 1):
        want = tbs.transform_partial_inplace_reference(V[p].clone(), U[p], m_out)
        assert torch.equal(Vb[p], want)
        assert torch.equal(Vb[p, m_out:], V[p, m_out:])
    assert torch.equal(Vb[2], V[2]) and torch.equal(Vb[3], V[3])


def _warn_problems():
    """Three float64 problems, the first with three distinct eigenvalues
    (an invariant subspace: it converges), the others random: with
    ``krylovdim=6, maxiter=2`` two stop unconverged."""
    rng = np.random.default_rng(119)
    As = np.stack([np.diag(np.repeat([3.0, 2.0, 1.0], 7)[:20])]
                  + [hermitize(rand_mat(rng, 20, 20, np.float64)) for _ in range(2)])
    return As, rand_vec(rng, 20, np.float64)


def _capture(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
        jax.effects_barrier()
    return [line for line in buf.getvalue().splitlines() if line.strip()]


def test_warn_lines_of_a_batched_solve_match_jax_vmap():
    """(g) at WARN, one line per unconverged problem with the one-problem
    text, as the JAX package's batched ``warn_if`` callback prints them."""
    As, x0 = _warn_problems()
    jalg = JLanczos(krylovdim=6, tol=1e-10, maxiter=2, verbosity=1)

    def jax_run():
        f = jax.jit(jax.vmap(lambda A: j_eigsolve_lanczos(JMatrixOperator(A), jnp.asarray(x0), 2,
                                                          "LR", jalg)[2].converged))
        np.asarray(f(jnp.asarray(As)))

    jlines = _capture(jax_run)
    tlines = _capture(lambda: kt.eigsolve_lanczos_batched(
        convert.matrices_from_numpy(As, "cpu"), torch.from_numpy(x0), 2, "LR", _talg(jalg),
        in_dims=(0, None)))
    assert len(tlines) == 2 and tlines == jlines, (tlines, jlines)


def test_batched_lanczos_refusals():
    """(h) each piece this slice does not batch raises ``ValueError`` with
    its name: selective with eager, as the one-problem driver refuses it.
    A sharded space is batched: on a one-rank axis, the unsharded bits,
    pytree vectors too, and so is differentiation there (the Lanczos
    eigsolve by the GMRES rule, Arnoldi by the Sylvester rule: the
    unsharded batched gradient, each problem its one-problem sharded
    gradient, bit for bit).  Pytree vectors
    are batched: each problem of a dict batch is its one-problem dict solve,
    bit for bit; so are ``eager=True`` and selective reorthogonalization.
    A start that requires grad is differentiated (``ad/batched.py``): it
    gets no gradient, as ``eigsolve``'s ``x0`` gets none."""
    top = kt.laplacian_1d(N, device="cpu")
    X = torch.from_numpy(_starts(2))
    alg = kt.Lanczos(krylovdim=10)
    one = kt.VectorSpace(psum_axis=MeshAxis("vec", None, 1, 0))
    cases = [
        (lambda: kt.eigsolve_lanczos_batched(
            top, X, 1, "LM", kt.Lanczos(krylovdim=10, eager=True, reorth="selective")),
         "selective.*incompatible with eager"),
        (lambda: kt.eigsolve_lanczos_batched(top, X, 1, "LM", alg, in_dims=(None, None)),
         "in_dims"),
        (lambda: kt.eigsolve_lanczos_batched([top], X, 1, "LM", alg, in_dims=(0, 0)),
         "disagree"),
    ]
    for call, word in cases:
        with pytest.raises(ValueError, match=word):
            call()
    # differentiation on a sharded space: on a one-rank axis the unsharded
    # batched gradient, each problem its one-problem sharded one (the GMRES
    # rule of Lanczos, the general Sylvester rule of Arnoldi)
    check_one_rank_axis("eigsolve_lanczos_batched")
    check_one_rank_axis("eigsolve_arnoldi_batched", "arnoldi")
    # a sharded space is batched: on a one-rank axis (no collective) each
    # problem solves as on the unsharded space, bit for bit
    short = kt.Lanczos(krylovdim=10, maxiter=2)
    dict_op = kt.as_operator(lambda x: {"a": top.normal(x["a"])})
    vals, vecs, info = kt.eigsolve_lanczos_batched(dict_op, {"a": X}, 1, "LM", short)
    for p in range(2):
        v1, w1, i1 = t_eigsolve_lanczos(dict_op, {"a": X[p]}, 1, "LM", short)
        assert torch.equal(vals[p], v1) and torch.equal(vecs["a"][p], w1["a"])
        assert int(info.numops[p]) == i1.numops and list(vecs) == ["a"]
    # the dict batch on a one-rank sharded space: the unsharded bits
    vals1, vecs1, info1 = kt.eigsolve_lanczos_batched(dict_op, {"a": X}, 1, "LM", short, one)
    assert torch.equal(vals1, vals) and torch.equal(vecs1["a"], vecs["a"])
    assert torch.equal(info1.numops, info.numops)
    # a start that requires grad: the solve's bits, no gradient to the start
    Xg = X.clone().requires_grad_(True)
    vals_g, _, _ = kt.eigsolve_lanczos_batched(top, Xg, 1, "LM", short)
    vals_g.sum().backward()
    assert vals_g.requires_grad and Xg.grad is None
    assert torch.equal(vals_g.detach(), kt.eigsolve_lanczos_batched(top, X, 1, "LM", short)[0])
    got = kt.eigsolve_lanczos_batched(top, X, 1, "LM", short, space=one)
    want = kt.eigsolve_lanczos_batched(top, X, 1, "LM", short)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[2].numops, want[2].numops)
    # eager and selective batches run: each problem its one-problem solve
    for alg in (kt.Lanczos(krylovdim=10, maxiter=2, eager=True),
                kt.Lanczos(krylovdim=10, maxiter=2, reorth="selective")):
        vals, vecs, info = kt.eigsolve_lanczos_batched(top, X, 1, "LM", alg)
        for p in range(2):
            v1, w1, i1 = t_eigsolve_lanczos(top, X[p], 1, "LM", alg)
            assert torch.equal(vals[p], v1) and torch.equal(vecs[p], w1)
            assert int(info.numops[p]) == i1.numops


def test_parametric_probe_makes_no_data_apply():
    """(i) ``probe_dtype`` of a ``ParametricOperator`` around a
    ``BandedOperator`` with a CPU parameter tensor runs ``apply_fn`` on
    meta tensors only; so does one around an ELL operator."""
    n = 1024
    A = 4 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)
    P = kt.banded_from_dense(A, device="cpu")
    E = kt.sparse.from_dense(A, device="cpu")
    g = torch.from_numpy(np.random.default_rng(2).standard_normal((n // 128, 128)))
    x0 = torch.zeros((n // 128, 128), dtype=torch.float32)
    seen = []

    def banded(g, x):
        seen.append(x.device.type)
        return P(x) + g * x

    def ell(g, x):
        seen.append(x.device.type)
        return E(x.reshape(-1)).reshape(x.shape) + g * x

    for fn in (banded, ell):
        seen.clear()
        assert probe_dtype(kt.ParametricOperator(fn, g), x0) == torch.float64
        assert seen == ["meta"], seen
