"""PyTorch port: batched exponential integrators
(``solvers/batched_expintegrator.py``) against ``jax.jit(jax.vmap(...))`` of
the JAX package's ``expintegrator`` core on the same numpy-seeded inputs,
each problem against the port's own one-problem solve, ``t`` shared and per
problem, the fused stencil path, the projection flag, the WARN lines and
the refusals.

``t`` is a static argument of the JAX core, so ``jax.vmap`` batches it
only when shared; a per-problem ``t`` is held against the JAX core jitted
once for each problem's ``t``.

Tolerances, stated per test: float64 values 1e-10 against the JAX package,
bit-equal against the port's one-problem solves on a shared operator (the
same arithmetic per problem) and 1e-12 on a matrix stack (it applies as one
batched product); float32 fused values 1e-4 relative against the JAX
package; counts always exactly equal.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krylovkit_tpu import Arnoldi as JArnoldi
from krylovkit_tpu import Lanczos as JLanczos
from krylovkit_tpu import StencilOperator as JStencilOperator
from krylovkit_tpu.factorizations import krylov as jkf
from krylovkit_tpu.ops.operator import MatrixOperator as JMatrixOperator
from krylovkit_tpu.ops.vector import STANDARD as JSTANDARD
from krylovkit_tpu.solvers import expintegrator as je
import chip_smoke
import krylovkit_tpu_torch as kt
from krylovkit_tpu_torch import convert
from krylovkit_tpu_torch.ops import basis as tbs
from krylovkit_tpu_torch.ops import projections as tpb
from krylovkit_tpu_torch.ops.collectives import MeshAxis
from krylovkit_tpu_torch.solvers import expintegrator as te

torch.set_num_threads(2)

N = 32
NEG = ((-1, 0, 1), (1.0, -2.0, 1.0))


def _counts(info):
    return [np.asarray(info.numops).tolist(), np.asarray(info.numiter).tolist(),
            np.asarray(info.converged).tolist()]


def _stack(hermitian):
    rng = np.random.default_rng(41)
    As = rng.standard_normal((3, N, N)) / N ** 0.5
    if hermitian:
        As = (As + As.transpose(0, 2, 1)) / 2
    return As, rng.standard_normal((3, N))


def _algs(hermitian, **kw):
    kw = {"krylovdim": 10, "tol": 1e-10, "maxiter": 100, **kw}
    return (JLanczos if hermitian else JArnoldi)(**kw), (kt.Lanczos if hermitian
                                                        else kt.Arnoldi)(**kw)


@pytest.mark.parametrize("hermitian", [True, False])
def test_vmap_of_expintegrator_matches_jax(hermitian):
    """A stack of three float64 matrices (symmetric: Lanczos; general:
    Arnoldi) with per-problem starts, ``t = 2`` shared: counts equal per
    problem, ``y`` within 1e-10; each problem within 1e-12 of the port's
    one-problem solve, counts equal."""
    As, X = _stack(hermitian)
    jalg, talg = _algs(hermitian)
    f = jax.jit(jax.vmap(lambda A, x: je._expintegrator_core(JMatrixOperator(A), 2.0, (x,),
                                                             jalg, JSTANDARD)))
    yj, ij = f(jnp.asarray(As), jnp.asarray(X))
    ops = convert.matrices_from_numpy(As, "cpu")
    y, it = kt.exponentiate_batched(ops, 2.0, torch.from_numpy(X), talg, in_dims=(0, None, 0))
    assert _counts(it) == _counts(ij) and min(it.numiter.tolist()) > 1
    assert it.numops.dtype == torch.int64 and it.normres.shape == (3,)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=0, atol=1e-10)
    np.testing.assert_allclose(it.normres.numpy(), np.asarray(ij.normres), rtol=1e-6, atol=1e-16)
    for p in range(3):
        y1, i1 = te._expintegrator_core(ops[p], 2.0, (torch.from_numpy(X[p]),), talg, kt.STANDARD)
        assert [i1.numops, i1.numiter, i1.converged] == [int(it.numops[p]), int(it.numiter[p]),
                                                         int(it.converged[p])]
        np.testing.assert_allclose(y[p].numpy(), y1.numpy(), rtol=0, atol=1e-12)


def test_per_problem_t_and_two_vectors():
    """A shared symmetric matrix, ``t = (0.5, 1, 3)`` per problem and
    ``(u₀, u₁)`` with ``u₁`` shared (``in_dims=(None, 0, (0, None))``):
    each problem bit-equal to the port's one-problem solve and, counts equal
    and within 1e-10, to the JAX core jitted for its ``t``."""
    As, X = _stack(True)
    A = As[0]
    u1 = np.random.default_rng(42).standard_normal(N)
    ts = [0.5, 1.0, 3.0]
    jalg, talg = _algs(True)
    op = convert.matrix_from_numpy(A, "cpu")
    y, it = kt.expintegrator_batched(op, ts, (torch.from_numpy(X), torch.from_numpy(u1)), talg,
                                     in_dims=(None, 0, (0, None)))
    assert len(set(it.numops.tolist())) == 3
    for p, t in enumerate(ts):
        u = (torch.from_numpy(X[p]), torch.from_numpy(u1))
        y1, i1 = te._expintegrator_core(op, t, u, talg, kt.STANDARD)
        assert [i1.numops, i1.numiter, i1.converged] == [int(it.numops[p]), int(it.numiter[p]),
                                                         int(it.converged[p])]
        assert torch.equal(y[p], y1)
        yj, ij = je._expintegrator_core(JMatrixOperator(jnp.asarray(A)), t,
                                        (jnp.asarray(X[p]), jnp.asarray(u1)), jalg, JSTANDARD)
        assert [int(ij.numops), int(ij.numiter)] == [int(it.numops[p]), int(it.numiter[p])]
        np.testing.assert_allclose(y[p].numpy(), np.asarray(yj), rtol=0, atol=1e-10)


@pytest.fixture
def interpret_mode():
    old = jkf.fused_interpret
    jkf.fused_interpret = True
    try:
        yield
    finally:
        jkf.fused_interpret = old


def test_vmap_of_fused_exponentiate_matches_jax(interpret_mode):
    """``exp(0.1·A)x`` for the (1, −2, 1) chain at R = 16 (the smallest fused
    height in both packages), P = 2, krylovdim 30, tol 1e-4 (the JAX side's
    K1 in Pallas interpret mode, the port's plain version): counts equal,
    ``y`` within 1e-4 relative, each problem bit-equal to the port's
    one-problem fused solve."""
    X = chip_smoke.batched_starts(torch, np, 16, 2, "cpu")
    jalg = JLanczos(krylovdim=30, tol=1e-4)
    talg = kt.Lanczos(krylovdim=30, tol=1e-4)
    jop, top = JStencilOperator(*NEG), convert.stencil_from_arrays(*NEG, "cpu")
    assert kt.factorizations.krylov.fused_available(top, X[0], kt.STANDARD, kmax=31)
    f = jax.jit(jax.vmap(lambda x: je._expintegrator_core(jop, 0.1, (x,), jalg, JSTANDARD)))
    yj, ij = f(jnp.asarray(X.numpy()))
    y, it = kt.exponentiate_batched(top, 0.1, X, talg)
    assert _counts(it) == _counts(ij)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=1e-4, atol=1e-4 * float(X.abs().max()))
    for p in range(2):
        y1, i1 = te._expintegrator_core(top, 0.1, (X[p],), talg, kt.STANDARD)
        assert (i1.numops, i1.numiter) == (int(it.numops[p]), int(it.numiter[p]))
        assert torch.equal(y1, y[p])


def test_projection_flag_on_equals_flag_off(monkeypatch):
    """Arnoldi on config 4's banded matrix at n = 2048 with ``(16, 128)``
    float32 starts, ``t = 0.05``: the projection flag on (the plain batched
    K5 and K6) against off, counts equal and ``y`` within 1e-5 relative;
    flag on, each problem bit-equal to its one-problem flag-on solve."""
    n = 2048
    band = kt.banded_from_coo(*chip_smoke.tridiagonal_coo(np, n, -1.3, 2.0, -0.7, np.float32),
                              n, device="cpu")
    X = chip_smoke.batched_starts(torch, np, n // 128, 3, "cpu")
    alg = kt.Arnoldi(krylovdim=12, tol=1e-5)
    calls = []
    real = tpb.unproject_pallas_batched
    monkeypatch.setattr(tpb, "unproject_pallas_batched",
                        lambda *a: (calls.append(len(a[0])), real(*a))[1])
    y0, i0 = kt.exponentiate_batched(band, 0.05, X, alg)
    assert calls == []
    monkeypatch.setattr(tbs, "use_pallas_projections", True)
    y, it = kt.exponentiate_batched(band, 0.05, X, alg)
    assert _counts(it) == _counts(i0) and calls
    scale = float(y0.abs().max())
    np.testing.assert_allclose(y.numpy(), y0.numpy(), rtol=0, atol=1e-5 * scale)
    for p in range(3):
        y1, i1 = te._expintegrator_core(band, 0.05, (X[p],), alg, kt.STANDARD)
        assert i1.numops == int(it.numops[p]) and torch.equal(y1, y[p])


def _capture(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
        jax.effects_barrier()
    return [line for line in buf.getvalue().splitlines() if line.strip()]


def test_warn_lines_match_jax_vmap():
    """At WARN, with ``maxiter = 1`` and ``t = 8`` the last step takes the
    whole interval and misses the error bound: one line per problem that
    misses it, the texts equal to the JAX package's vmapped ``warn_if``
    after the numbers (compared to 1e-6 relative)."""
    As, X = _stack(True)
    As = As * np.array([1.0, 0.01, 1.0])[:, None, None]  # the second stays within tol
    jalg, talg = _algs(True, maxiter=1, krylovdim=6, tol=1e-8, verbosity=1)
    f = jax.jit(jax.vmap(lambda A, x: je._expintegrator_core(JMatrixOperator(A), 8.0, (x,),
                                                             jalg, JSTANDARD)[1].normres))
    jlines = _capture(lambda: np.asarray(f(jnp.asarray(As), jnp.asarray(X))))
    tlines = _capture(lambda: kt.exponentiate_batched(convert.matrices_from_numpy(As, "cpu"), 8.0,
                                                      torch.from_numpy(X), talg,
                                                      in_dims=(0, None, 0)))
    assert len(tlines) == 2 and len(jlines) == 2, (tlines, jlines)

    def split(line):
        head, err = line.rsplit("= ", 1)
        return head, float(err.strip("[]"))

    tk, jk = sorted(map(split, tlines)), sorted(map(split, jlines))
    assert [h for h, _ in tk] == [h for h, _ in jk]
    np.testing.assert_allclose([e for _, e in tk], [e for _, e in jk], rtol=1e-6)


def test_batched_expintegrator_refusals():
    """Each piece this slice does not batch raises ``ValueError`` with its
    name: differentiation (no rule in either package).  A sharded space is
    batched: on a one-rank axis, the unsharded bits, a dict batch too; so
    is ``eager=True``: each problem its one-problem eager integration, bit
    for bit."""
    top = convert.stencil_from_arrays(*NEG, "cpu")
    X = chip_smoke.batched_starts(torch, np, 16, 2, "cpu")
    alg = kt.Lanczos(krylovdim=10)
    one = kt.VectorSpace(psum_axis=MeshAxis("vec", None, 1, 0))
    cases = [
        (lambda: kt.exponentiate_batched(top, 0.1, X.clone().requires_grad_(True), alg),
         "expintegrator_batched: differentiation has no rule"),
        (lambda: kt.exponentiate_batched(top, torch.tensor([0.1, 0.2], requires_grad=True), X,
                                         alg, in_dims=(None, 0, 0)), "differentiation"),
        (lambda: kt.exponentiate_batched(top, 0.1, X, alg, in_dims=(None, None, None)),
         "in_dims"),
        (lambda: kt.expintegrator_batched(top, 0.1, (X, X), alg, in_dims=(None, None, (0,))),
         "in_dims"),
        (lambda: kt.exponentiate_batched(top, [0.1, 0.2, 0.3], X, alg, in_dims=(None, 0, 0)),
         "disagree"),
    ]
    for call, word in cases:
        with pytest.raises(ValueError, match=word):
            call()
    # a sharded space is batched: on a one-rank axis (no collective) each
    # problem integrates as on the unsharded space, bit for bit
    eager = kt.Lanczos(krylovdim=10, eager=True)
    y, info = kt.exponentiate_batched(top, 0.1, X, eager)
    for p in range(2):
        y1, i1 = te._expintegrator_core(top, 0.1, (X[p],), eager, kt.STANDARD)
        assert torch.equal(y[p], y1) and int(info.numops[p]) == i1.numops
    got = kt.exponentiate_batched(top, 0.1, X, alg, space=one)
    want = kt.exponentiate_batched(top, 0.1, X, alg)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1].numops, want[1].numops)
    # a dict batch: each problem is its one-problem dict integration, bit for bit
    dict_op = kt.as_operator(lambda x: {"a": top.normal(x["a"])})
    y, info = kt.exponentiate_batched(dict_op, 0.1, {"a": X}, alg)
    for p in range(2):
        y1, i1 = te._expintegrator_core(dict_op, 0.1, ({"a": X[p]},), alg, kt.STANDARD)
        assert torch.equal(y["a"][p], y1["a"]) and int(info.numops[p]) == i1.numops
    y1, info1 = kt.exponentiate_batched(dict_op, 0.1, {"a": X}, alg, space=one)
    assert torch.equal(y1["a"], y["a"]) and torch.equal(info1.numops, info.numops)
