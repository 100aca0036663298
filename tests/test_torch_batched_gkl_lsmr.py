"""PyTorch port: batched LSMR ``lssolve`` (``solvers/batched_gkl.py:
lssolve_lsmr_batched``) against ``jax.jit(jax.vmap(...))`` of the JAX
package's ``lssolve_lsmr`` on numpy-seeded float64 inputs (one shared 40 ×
25 matrix with four right-hand sides, and a stack of four matrices; ``lam``
0 and 0.5), banded operators with their adjoints (shared, and one per
problem from ``convert.banded_batch_from_arrays``' adjoint stacks against
the JAX package's vmapped ``BandedOperator``), a space with its own inner
product, the WARN lines and the refusals.

Tolerances: counts exactly equal; ``x`` within 1e-10 of its largest entry
and ``normres`` within 1e-10·‖b‖ of the JAX package's.  Against the port's
one-problem solve each problem is bit-identical on a shared matrix and on
banded operators (elementwise scalars, per-row inner products, the batched
applies row by row the one-vector applies; one ``hypot`` a row on the
CPU), within 1e-12 on a matrix stack (one batched product).  On banded
operators each problem's batched applies (normal and adjoint) equal its
``numops``.
"""

import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krylovkit_tpu import LSMR as JLSMR
from krylovkit_tpu.ops.operator import MatrixOperator as JMatrixOperator
from krylovkit_tpu.ops.pallas_spmv import BandedOperator as JBandedOperator
from krylovkit_tpu.ops.pallas_spmv import banded_from_coo as j_banded_from_coo
from krylovkit_tpu.solvers.lssolve import lssolve_lsmr as j_lsmr
import chip_smoke
import krylovkit_tpu_torch as kt
from krylovkit_tpu_torch import convert
from krylovkit_tpu_torch.ops.collectives import MeshAxis
from krylovkit_tpu_torch.ops.operator import as_operator
from krylovkit_tpu_torch.solvers import batched as batched_mod
from krylovkit_tpu_torch.solvers.lssolve import lssolve_lsmr as t_lsmr

torch.set_num_threads(2)

M, N, P = 40, 25, 4
NB = 256  # banded operators: n = 256


def _talg(jalg):
    return convert.lsmr_from_dict({**dataclasses.asdict(jalg), "orth": type(jalg.orth).__name__})


def _counts(info):
    return [np.asarray(info.numops).tolist(), np.asarray(info.numiter).tolist(),
            np.asarray(info.converged).tolist()]


def _close(x, xj, info, infoj, B):
    x, xj = np.asarray(x), np.asarray(xj)
    for p in range(x.shape[0]):
        assert np.max(np.abs(x[p] - xj[p])) <= 1e-10 * np.max(np.abs(xj[p])), p
        assert abs(float(info.normres[p]) - float(infoj.normres[p])) <= \
            1e-10 * np.linalg.norm(B[p])


@pytest.mark.parametrize("lam", [0.0, 0.5])
@pytest.mark.parametrize("kind", ["shared_matrix", "matrix_stack"])
def test_vmap_of_lssolve_lsmr_matches_jax(kind, lam):
    """Over right-hand sides with a shared matrix (``in_dims=(None, 0)``)
    and over a stack of matrices (``(0, 0)``), ``lam`` 0 and 0.5: counts
    equal, ``x`` and ``normres`` within 1e-10; each problem bit-identical to
    the port's one-problem LSMR on the shared matrix, 1e-12 on the stack."""
    rng = np.random.default_rng(7)
    As = rng.standard_normal((P, M, N))
    B = np.stack([(1 + p) * rng.standard_normal(M) for p in range(P)])
    jalg = JLSMR(tol=1e-9, maxiter=300)
    op_dim = None if kind == "shared_matrix" else 0
    Aj = jnp.asarray(As[0]) if op_dim is None else jnp.asarray(As)
    f = jax.jit(jax.vmap(lambda A, b: j_lsmr(JMatrixOperator(A), b, jalg, lam),
                         in_axes=(op_dim, 0)))
    xj, ij = f(Aj, jnp.asarray(B))
    op = torch.from_numpy(As[0]) if op_dim is None else convert.matrices_from_numpy(As, "cpu")
    Bt = torch.from_numpy(B)
    x, it = kt.lssolve_lsmr_batched(op, Bt, _talg(jalg), lam, in_dims=(op_dim, 0))
    assert _counts(it) == _counts(ij), (_counts(it), _counts(ij))
    assert x.shape == (P, N) and it.residual.shape == (P, M) and it.numops.dtype == torch.int64
    _close(x, xj, it, ij, B)
    for p in range(P):
        A = torch.from_numpy(As[0] if op_dim is None else As[p])
        x1, i1 = t_lsmr(as_operator(A), Bt[p], _talg(jalg), lam)
        assert [i1.numops, i1.numiter, i1.converged] == [c[p] for c in _counts(it)]
        if op_dim is None:
            assert torch.equal(x[p], x1) and torch.equal(it.residual[p], i1.residual)
        else:
            np.testing.assert_allclose(x[p].numpy(), x1.numpy(), rtol=0, atol=1e-12)


def _tridiagonals():
    """``P`` non-symmetric tridiagonal ``NB × NB`` matrices (lower band
    scaled by ``1 + 0.1·p``) as COO: one set of offsets, adjoints that
    differ from the operators."""
    return [chip_smoke.tridiagonal_coo(np, NB, -1.3 * (1 + 0.1 * p), 2.0, -0.7, np.float64)
            for p in range(P)]


def test_banded_batch_from_arrays_with_adjoint_stacks_matches_jax():
    """``convert.banded_batch_from_arrays`` with ``adj_offsets``/``adj_diags``
    builds each operator with its adjoint: its planes are the stacks' (the
    JAX operators' ``diags``/``adj.diags``), its applies agree with the JAX
    package's vmapped ``BandedOperator`` (1e-13), and batched LSMR on it
    (``in_dims=(0, 0)``) matches the JAX package's vmapped LSMR on the same
    planes: counts equal, ``x`` within 1e-10."""
    jops = [j_banded_from_coo(*coo, NB) for coo in _tridiagonals()]
    offs, aoffs = jops[0].offsets, jops[0].adj.offsets
    assert all(o.offsets == offs and o.adj.offsets == aoffs for o in jops)
    D = np.stack([np.asarray(o.diags) for o in jops])
    Da = np.stack([np.asarray(o.adj.diags) for o in jops])
    ops = convert.banded_batch_from_arrays(offs, D, NB, "cpu", adj_offsets=aoffs, adj_diags=Da)
    assert len(ops) == P and all(o.adj is not None for o in ops)
    rng = np.random.default_rng(12)
    X = rng.standard_normal((P, NB))
    B = rng.standard_normal((P, NB))

    def jop(D, Da):
        return JBandedOperator(offs, D, NB, adj=JBandedOperator(aoffs, Da, NB))

    yj, zj = jax.jit(jax.vmap(lambda D, Da, x: (jop(D, Da).normal(x),
                                                jop(D, Da).apply_adjoint(x))))(
        jnp.asarray(D), jnp.asarray(Da), jnp.asarray(X))
    for p, o in enumerate(ops):
        assert np.array_equal(o.diags.numpy(), D[p]) and np.array_equal(o.adj.diags.numpy(), Da[p])
        np.testing.assert_allclose(o.normal(torch.from_numpy(X[p])).numpy(), np.asarray(yj[p]),
                                   atol=1e-13)
        np.testing.assert_allclose(o.apply_adjoint(torch.from_numpy(X[p])).numpy(),
                                   np.asarray(zj[p]), atol=1e-13)
    jalg = JLSMR(tol=1e-10, maxiter=400)
    xj, ij = jax.jit(jax.vmap(lambda D, Da, b: j_lsmr(jop(D, Da), b, jalg, 0.5)))(
        jnp.asarray(D), jnp.asarray(Da), jnp.asarray(B))
    x, it = kt.lssolve_lsmr_batched(ops, torch.from_numpy(B), _talg(jalg), 0.5, in_dims=(0, 0))
    assert _counts(it) == _counts(ij)
    _close(x, xj, it, ij, B)
    with pytest.raises(ValueError, match="adjoint plane sets"):
        convert.banded_batch_from_arrays(offs, D, NB, "cpu", adj_offsets=aoffs, adj_diags=Da[:2])


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_problem"])
def test_banded_lsmr_is_bit_identical_and_applies_equal_numops(shared):
    """A shared banded operator with its adjoint, and a list of them built
    by ``convert.banded_batch_from_arrays`` with adjoint stacks: each
    problem bit-identical to its one-problem LSMR (``x``, residual,
    ``normres``, counts), and each problem's batched applies (normal and
    adjoint stacks, ``chip_smoke.ApplyRecorder``) equal its ``numops``."""
    coos = _tridiagonals()
    if shared:
        op = kt.banded_from_coo(*coos[0], NB, device="cpu")
        ops = [op] * P
    else:
        jops = [j_banded_from_coo(*coo, NB) for coo in coos]
        op = ops = convert.banded_batch_from_arrays(
            jops[0].offsets, np.stack([np.asarray(o.diags) for o in jops]), NB, "cpu",
            adj_offsets=jops[0].adj.offsets,
            adj_diags=np.stack([np.asarray(o.adj.diags) for o in jops]))
    B = torch.from_numpy(np.random.default_rng(13).standard_normal((P, NB)) *
                         np.arange(1, P + 1)[:, None])
    alg = kt.LSMR(tol=1e-9, maxiter=300)
    with chip_smoke.ApplyRecorder(batched_mod) as rec:
        x, it = kt.lssolve_lsmr_batched(op, B, alg, 0.5, in_dims=(None if shared else 0, 0))
    numops = it.numops.tolist()
    assert len(set(numops)) > 1 and it.converged.tolist() == [1] * P
    assert rec.per_problem == {p: numops[p] for p in range(P)}
    for p in range(P):
        x1, i1 = t_lsmr(ops[p], B[p], alg, 0.5)
        assert [i1.numops, i1.numiter, i1.converged] == [c[p] for c in _counts(it)]
        assert torch.equal(x[p], x1) and torch.equal(it.residual[p], i1.residual)
        assert torch.equal(it.normres[p], i1.normres)


def test_custom_inner_product_space_is_each_problems_one_problem_solve():
    """``VectorSpace(inner_fn=...)`` (twice the Euclidean inner product):
    every problem bit-identical to its one-problem LSMR in the same space
    (``x``, residual, ``normres``, counts), on a shared matrix and on a
    ``(f, fadjoint)`` pair, whose adjoint guard runs in that space as the
    one-problem ``lssolve`` front-end runs it; a pair whose adjoint is not
    the map's (or not in a weighted space) is refused."""
    rng = np.random.default_rng(17)
    A = torch.from_numpy(rng.standard_normal((M, N)))
    B = torch.from_numpy(rng.standard_normal((P, M)))
    space = kt.VectorSpace(inner_fn=lambda x, y: 2.0 * torch.vdot(x, y))
    alg = kt.LSMR(tol=1e-10, maxiter=200)
    for op in (A, (lambda x: A @ x, lambda y: A.T @ y)):
        x, it = kt.lssolve_lsmr_batched(op, B, alg, 0.5, space)
        for p in range(P):
            x1, i1 = t_lsmr(as_operator(op), B[p], alg, 0.5, space)
            assert torch.equal(x[p], x1) and torch.equal(it.residual[p], i1.residual)
            assert torch.equal(it.normres[p], i1.normres)
            assert [c[p] for c in _counts(it)] == [i1.numops, i1.numiter, i1.converged]
    with pytest.raises(ValueError, match="not compatible"):
        kt.lssolve_lsmr_batched((lambda x: A @ x, lambda y: 2.0 * (A.T @ y)), B, alg, 0.5, space)
    # Aᵀ is not the adjoint in a weighted space: the guard runs in the space
    weighted = kt.VectorSpace(
        inner_fn=lambda x, y: torch.vdot(x, torch.arange(1, x.numel() + 1) * y))
    pair = (lambda x: A @ x, lambda y: A.T @ y)
    with pytest.raises(ValueError, match="not compatible"):
        kt.lssolve(pair, B[0], space=weighted)
    with pytest.raises(ValueError, match="not compatible"):
        kt.lssolve_lsmr_batched(pair, B, alg, 0.5, weighted)


def _capture(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
        jax.effects_barrier()
    return [line for line in buf.getvalue().splitlines() if line.strip()]


def test_lsmr_warn_lines_match_one_problem_text_and_jax_vmap():
    """At WARN, one "finished without converging" line per unconverged
    problem (three of four: the first right-hand side is zero), the
    one-problem text in problem order; the same set of lines as the JAX
    package's vmapped ``warn_if``, the numbers within 1e-10 relative."""
    rng = np.random.default_rng(14)
    A = rng.standard_normal((M, N))
    B = rng.standard_normal((P, M))
    B[0] = 0.0
    jalg = JLSMR(tol=1e-12, maxiter=5, verbosity=1)
    jlines = _capture(lambda: np.asarray(jax.jit(jax.vmap(
        lambda b: j_lsmr(JMatrixOperator(jnp.asarray(A)), b, jalg)[1].converged))(
            jnp.asarray(B))))
    talg = _talg(jalg)
    At = torch.from_numpy(A)
    tlines = _capture(lambda: kt.lssolve_lsmr_batched(At, torch.from_numpy(B), talg))
    one = []
    for p in range(P):
        one += _capture(lambda p=p: t_lsmr(as_operator(At), torch.from_numpy(B[p]), talg))
    assert len(tlines) == 3 and tlines == one, (tlines, one)
    assert all("LSMR lssolve finished without converging after 5 iterations" in t
               for t in tlines)

    def value(line):
        return float(line.rsplit("=", 1)[1])

    np.testing.assert_allclose(sorted(map(value, tlines)), sorted(map(value, jlines)),
                               rtol=1e-10)


def test_batched_lssolve_refusals():
    """A right-hand side, an operator tensor or a ``lam`` that requires grad
    raise ``ValueError`` with the cause's name (``lssolve`` has no rule);
    so do the argument checks.  A sharded space is batched: on a one-rank
    axis, the unsharded bits, a dict batch too; so are pytree vectors: a
    dict batch gives each problem its one-problem dict solve, bit for
    bit."""
    A = torch.from_numpy(np.random.default_rng(15).standard_normal((M, N)))
    B = torch.from_numpy(np.random.default_rng(16).standard_normal((P, M)))
    alg = kt.LSMR(tol=1e-8)
    cases = [
        (lambda: kt.lssolve_lsmr_batched(A, B.clone().requires_grad_(True), alg),
         "lssolve_lsmr_batched: differentiation has no rule"),
        (lambda: kt.lssolve_lsmr_batched(A.clone().requires_grad_(True), B, alg),
         "differentiation"),
        (lambda: kt.lssolve_lsmr_batched(A, B, alg, torch.tensor(0.5, dtype=torch.float64,
                                                                 requires_grad=True)),
         "differentiation"),
        (lambda: kt.lssolve_lsmr_batched(A, B, alg, in_dims=(None, None)), "in_dims"),
        (lambda: kt.lssolve_lsmr_batched([A], B, alg, in_dims=(0, 0)), "disagree"),
    ]
    for call, word in cases:
        with pytest.raises(ValueError, match=word):
            call()
    # a sharded space is batched: on a one-rank axis (no collective) each
    # problem solves as on the unsharded space, bit for bit
    got = kt.lssolve_lsmr_batched(A, B, alg, space=kt.VectorSpace(psum_axis=MeshAxis("vec", None, 1, 0)))
    want = kt.lssolve_lsmr_batched(A, B, alg)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1].numops, want[1].numops)
    dpair = (lambda x: {"b": A @ x["x"]}, lambda y: {"x": A.T @ y["b"]})
    x, info = kt.lssolve_lsmr_batched(dpair, {"b": B}, alg)
    for p in range(P):
        x1, i1 = t_lsmr(as_operator(dpair), {"b": B[p]}, alg)
        assert torch.equal(x["x"][p], x1["x"]) and int(info.numops[p]) == i1.numops
    x1, info1 = kt.lssolve_lsmr_batched(dpair, {"b": B}, alg, space=kt.VectorSpace(
        psum_axis=MeshAxis("vec", None, 1, 0)))
    assert torch.equal(x1["x"], x["x"]) and torch.equal(info1.numops, info.numops)
