"""PyTorch port: batched BiArnoldi ``bieigsolve`` against
``jax.jit(jax.vmap(...))`` of the JAX package's ``bieigsolve_driver`` on
one shared complex128 24 × 24 matrix with three complex ``(v0, w0)`` pairs
(``in_dims=(None, 0, 0)``), 2 "LM"; then, against the port's one-problem
driver, a shared banded operator with its adjoint planes (the plain twin of
K3, float64), the projection flag (the plain twins of K5 and K6) on a
float32 banded operator, the WARN lines and the refusals.  The stack of
real matrices is in ``tests/test_torch_batched_biarnoldi.py``.

Tolerances: values within 1e-10 of the JAX package's, counts exactly equal,
each pair's two residuals within their ``normres`` + 1e-10, and each
problem bit-identical to the port's one-problem solve where its operator
applies each row as the one-problem apply does (shared operators).
"""

import contextlib
import io


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import ApplyRecorder, bieig_predicted_projections, tridiagonal_coo

from krylovkit_tpu import BiArnoldi as JBiArnoldi
from krylovkit_tpu.ops.operator import MatrixOperator as JMatrixOperator
from krylovkit_tpu.solvers.biarnoldi import bieigsolve_driver as j_bieig
import krylovkit_tpu_torch as kt
from krylovkit_tpu_torch import convert
from krylovkit_tpu_torch.ops import banded as bd
from krylovkit_tpu_torch.ops import basis as tbs
from krylovkit_tpu_torch.ops import projections as pb
from krylovkit_tpu_torch.ops.collectives import MeshAxis
from krylovkit_tpu_torch.ops.operator import as_operator
from krylovkit_tpu_torch.solvers import batched as batched_mod
from krylovkit_tpu_torch.solvers.biarnoldi import bieigsolve_driver as t_bieig
from test_torch_batched_biarnoldi import KW, N, P, _stack, check_pairs, counts, problem, same

torch.set_num_threads(2)


def test_shared_complex_matrix_with_three_start_pairs_matches_jax():
    """One shared complex128 matrix (a complex normal one scaled by
    ``1/√N`` plus ``diag(linspace(0, 10)²/10)``: its largest values well
    apart), three ``(v0, w0)`` pairs drawn after it: counts equal to
    ``jax.vmap``'s, values within 1e-10, both residuals of each pair within
    their ``normres`` + 1e-10, and each problem bit-identical to its
    one-problem solve (values, both vector sets, both infos' residuals and
    norms, counts)."""
    rng = np.random.default_rng(9)

    def draw(shape):
        return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)

    A = draw((N, N)) / np.sqrt(N) + np.diag(np.linspace(0, 10, N) ** 2 / 10)
    V, W = draw((P, N)), draw((P, N))
    jalg = JBiArnoldi(**KW)
    f = jax.jit(jax.vmap(lambda v, w: j_bieig(JMatrixOperator(jnp.asarray(A)), v, w, 2, "LM",
                                              jalg)))
    vj, _, (ij, _) = f(jnp.asarray(V), jnp.asarray(W))
    At = torch.from_numpy(A)
    out = kt.bieigsolve_batched(At, torch.from_numpy(V), torch.from_numpy(W), 2, "LM",
                                kt.BiArnoldi(**KW))
    vals, (Vt, Wt), (iV, iW) = out
    assert counts(iV) == counts(iW) == counts(ij)
    assert Vt.dtype == torch.complex128 and Vt.shape == (P, 2, N)
    np.testing.assert_allclose(vals.numpy(), np.asarray(vj), rtol=0, atol=1e-10)
    for p in range(P):
        check_pairs(A, vals, Vt, Wt, iV, iW, p)
        one = t_bieig(as_operator(At), torch.from_numpy(V[p]), torch.from_numpy(W[p]), 2,
                      "LM", kt.BiArnoldi(**KW))
        assert same(problem(out, p), one)
        assert [one[2][0].numops, one[2][0].numiter, one[2][0].converged] == [
            c[p] for c in counts(iV)]


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


def test_shared_banded_operator_with_adjoint_planes_batches_k3(monkeypatch):
    """A non-symmetric tridiagonal (−0.4, ``(1 + i/63)⁸``, −0.2) at n = 64
    as a shared float64 ``BandedOperator`` with its adjoint planes, three
    start pairs, 2 "LM" (krylovdim 20): each problem bit-identical to its
    one-problem solve; each lock-step is one batched apply on the normal
    planes and one on the adjoint's (each problem's batched applies equal
    its ``numops``), the K3 wrapper's batched entry runs once per batched
    apply and its one-problem entry never."""
    n = 64
    i = np.arange(n)
    coo = (np.concatenate([i[1:], i, i[:-1]]), np.concatenate([i[1:] - 1, i, i[:-1] + 1]),
           np.concatenate([np.full(n - 1, -0.4), (1 + i / (n - 1)) ** 8, np.full(n - 1, -0.2)]))
    op = kt.banded_from_coo(*coo, n, device="cpu")
    rng = np.random.default_rng(17)
    V, W = (torch.from_numpy(rng.standard_normal((P, n))) for _ in range(2))
    alg = kt.BiArnoldi(krylovdim=20, tol=1e-10, maxiter=100)
    calls = _counting(monkeypatch, bd, ("banded_spmv", "banded_spmv_batched"))
    with ApplyRecorder(batched_mod) as rec:
        out = kt.bieigsolve_batched(op, V, W, 2, "LM", alg)
    numops = out[2][0].numops.tolist()
    assert calls == {"banded_spmv": 0, "banded_spmv_batched": rec.calls}
    assert rec.calls >= max(numops) and rec.calls % 2 == 0
    assert rec.per_problem == dict(enumerate(numops))
    for p in range(P):
        one = t_bieig(op, V[p], W[p], 2, "LM", alg)
        assert same(problem(out, p), one)
        assert one[2][0].numops == numops[p] and one[2][0].converged == 2


def test_projection_flag_batches_k5_k6_bit_for_bit(monkeypatch):
    """The tridiagonal in float32 at n = 1024 (``(8, 128)`` vectors), three
    start pairs, fixed work (tol 1e-30, maxiter 2), the projection flag on:
    each problem bit-identical to its one-problem solve with the flag on;
    every ``_update_M``, oblique-correction and sweep projection is one
    batched call of the plain K5 twin, every sweep's unprojection one of
    K6's, as many as :func:`chip_smoke.bieig_predicted_projections` counts
    on the batch's lock-steps, and none a one-problem call."""
    n = 1024
    op = kt.banded_from_coo(*tridiagonal_coo(np, n, -1.3, 2.0, -0.7, np.float32), n,
                            device="cpu")
    rng = np.random.default_rng(18)
    V, W = (torch.from_numpy(rng.standard_normal((P, 8, 128)).astype(np.float32))
            for _ in range(2))
    alg = kt.BiArnoldi(krylovdim=12, tol=1e-30, maxiter=2)
    calls = _counting(monkeypatch, pb, ("project_pallas", "unproject_pallas",
                                        "project_pallas_batched", "unproject_pallas_batched"))
    monkeypatch.setattr(tbs, "use_pallas_projections", True)
    out = kt.bieigsolve_batched(op, V, W, 2, "LM", alg)
    batched = dict(calls)
    numops = out[2][0].numops.tolist()
    assert out[2][0].numiter.tolist() == [2] * P
    k5, k6 = bieig_predicted_projections(max(numops), 2)
    assert batched == {"project_pallas": 0, "unproject_pallas": 0,
                       "project_pallas_batched": k5, "unproject_pallas_batched": k6}
    for p in range(P):
        assert same(problem(out, p), t_bieig(op, V[p], W[p], 2, "LM", alg))


def _capture(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return [line for line in buf.getvalue().splitlines() if line.strip()]


def test_warn_lines_are_the_one_problem_lines_in_problem_order():
    """At WARN, one "stopped without convergence" line per unconverged
    problem, with its one-problem text, in problem order (the stack of the
    first test, cut to 2 iterations)."""
    As, v0, w0 = _stack()
    alg = kt.BiArnoldi(**{**KW, "maxiter": 2, "verbosity": 1})
    lines = _capture(lambda: kt.bieigsolve_batched(
        convert.matrices_from_numpy(As, "cpu"), torch.from_numpy(v0), torch.from_numpy(w0), 2,
        "LM", alg, in_dims=(0, None, None)))
    one = []
    for p in range(P):
        one += _capture(lambda p=p: t_bieig(as_operator(torch.from_numpy(As[p])),
                                            torch.from_numpy(v0), torch.from_numpy(w0), 2,
                                            "LM", alg))
    assert lines == one and lines, (lines, one)
    assert all("BiArnoldi bieigsolve stopped without convergence" in t for t in lines)


def test_batched_bieigsolve_refusals():
    """Each piece this slice does not batch raises ``ValueError`` with its
    name: an input or an operator tensor that requires grad (``bieigsolve``
    has no rule), ``in_dims`` other than 0 or None, an ``(f, fadjoint)``
    tuple given as a batch; and the argument checks.  A sharded space is
    batched: on a one-rank axis, the unsharded bits, a pair of dict batches
    too; so are pytree vectors: each problem of a pair of dict batches is
    its one-problem dict solve, bit for bit; so is
    ``BiArnoldi(eager=True)``."""
    As, _, _ = _stack(10)
    A = torch.from_numpy(As[0])
    Vt, Wt = torch.from_numpy(As[1, :P]), torch.from_numpy(As[2, :P])
    alg = kt.BiArnoldi(**{**KW, "maxiter": 3})
    solve = kt.bieigsolve_batched
    pair = (lambda x: A @ x, lambda y: A.T @ y)
    cases = [
        (lambda: solve(A, Vt.clone().requires_grad_(True), Wt, 1, "LM", alg),
         "bieigsolve_batched: differentiation has no rule"),
        (lambda: solve(A.clone().requires_grad_(True), Vt, Wt, 1, "LM", alg), "differentiation"),
        (lambda: solve(A, Vt, Wt, 1, "LM", alg, in_dims=(None, 0, 1)), "in_dims"),
        (lambda: solve(pair, Vt[:2], Wt[:2], 1, "LM", alg, in_dims=(0, 0, 0)),
         "one shared operator"),
        (lambda: solve(A, Vt, Wt, 13, "LM", alg), "exceeds krylovdim"),
        (lambda: solve(A, Vt, Wt[:2], 1, "LM", alg), "disagree"),
    ]
    for call, match in cases:
        with pytest.raises(ValueError, match=match):
            call()
    # an eager batch: each problem its one-problem eager solve, bit for bit
    eager = kt.BiArnoldi(krylovdim=8, maxiter=1, eager=True)
    vals, _, (iV, _) = solve(A, Vt[:2], Wt[:2], 1, "LM", eager)
    for p in range(2):
        v1, _, (i1, _) = t_bieig(as_operator(A), Vt[p], Wt[p], 1, "LM", eager)
        assert torch.equal(vals[p], v1) and int(iV.numops[p]) == i1.numops
    # a sharded space is batched: on a one-rank axis (no collective) each
    # problem solves as on the unsharded space, bit for bit
    got = solve(A, Vt, Wt, 2, "LM", alg, space=kt.VectorSpace(psum_axis=MeshAxis("vec", None, 1, 0)))
    want = solve(A, Vt, Wt, 2, "LM", alg)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1][0], want[1][0])
    assert counts(got[2][0]) == counts(want[2][0])
    # a (v0, w0) pair of dict batches: each problem is its one-problem dict
    # solve, bit for bit
    dpair = (lambda x: {"a": A @ x["a"]}, lambda y: {"a": A.T @ y["a"]})
    vals, (V, W), (iV, _) = solve(dpair, {"a": Vt}, {"a": Wt}, 2, "LM", alg)
    for p in range(P):
        v1, (V1, W1), (i1, _) = t_bieig(as_operator(dpair), {"a": Vt[p]}, {"a": Wt[p]}, 2, "LM",
                                        alg)
        assert torch.equal(vals[p], v1) and torch.equal(V["a"][p], V1["a"])
        assert torch.equal(W["a"][p], W1["a"]) and int(iV.numops[p]) == i1.numops
    got = solve(dpair, {"a": Vt}, {"a": Wt}, 2, "LM", alg,
                space=kt.VectorSpace(psum_axis=MeshAxis("vec", None, 1, 0)))
    assert torch.equal(got[0], vals) and torch.equal(got[1][0]["a"], V["a"])
    assert torch.equal(got[1][1]["a"], W["a"]) and counts(got[2][0]) == counts(iV)
    # a pair given as one shared operator solves as the matrix does
    got = solve(pair, Vt, Wt, 2, "LM", alg)
    want = solve(A, Vt, Wt, 2, "LM", alg)
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=0, atol=1e-12)
    assert counts(got[2][0]) == counts(want[2][0])
