"""PyTorch port: batched Golub-Ye ``geneigsolve``
(``solvers/batched_golubye.py``) against ``jax.jit(jax.vmap(...))`` of the
JAX package's ``geneigsolve_golubye`` on numpy-seeded inputs: a stack of
three float64 pencils with one shared start (``in_dims=(0, 0, None)``), one
shared pencil with three starts ("LR"), a stack of complex128 Hermitian
matrices with ``B = None``; then a shared float64 banded Q1 pencil (the
plain twin of K3), the projection flag (the plain twins of K5 and K6) on a
float32 Q1 pencil, the WARN lines and the refusals.

Tolerances, stated per test: values within 1e-10 of the JAX package's,
counts exactly equal, each returned pair's ``‖A x − λ B x‖`` within its
``normres`` + 1e-10.  Against the port's one-problem solve each problem is
bit-identical where its operators apply each row as the one-problem apply
does (shared operators), and within 1e-12 on a matrix stack (one batched
product).
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import ApplyRecorder, golubye_sweeps, q1_coo
from krylovkit_tpu import GolubYe as JGolubYe
from krylovkit_tpu.ops.operator import MatrixOperator as JMatrixOperator
from krylovkit_tpu.solvers.golubye import geneigsolve_golubye as j_golubye
import krylovkit_tpu_torch as kt
from krylovkit_tpu_torch import convert
from krylovkit_tpu_torch.ops import banded as bd
from krylovkit_tpu_torch.ops import basis as tbs
from krylovkit_tpu_torch.ops import projections as pb
from krylovkit_tpu_torch.ops.collectives import MeshAxis
from krylovkit_tpu_torch.ops.operator import as_operator
from krylovkit_tpu_torch.solvers import batched as batched_mod
from krylovkit_tpu_torch.solvers.golubye import geneigsolve_golubye as t_golubye

torch.set_num_threads(2)

N, P = 24, 3
KW = dict(krylovdim=8, tol=1e-10, maxiter=40)


def _pencils(seed=7, dtype=np.float64):
    """Three pencils ``A = a + aᴴ``, ``B = b bᴴ/N + I`` (``a``, ``b`` drawn
    per pencil) and a start drawn after them."""
    rng = np.random.default_rng(seed)
    As, Bs = [], []
    for _ in range(P):
        a, b = rng.standard_normal((N, N)), rng.standard_normal((N, N))
        if dtype == np.complex128:
            a, b = a + 1j * rng.standard_normal((N, N)), b + 1j * rng.standard_normal((N, N))
        As.append(a + a.conj().T)
        Bs.append(b @ b.conj().T / N + np.eye(N))
    x0 = rng.standard_normal(N)
    if dtype == np.complex128:
        x0 = x0 + 1j * rng.standard_normal(N)
    return np.stack(As), np.stack(Bs), x0


@pytest.fixture(scope="module")
def jax_vmapped():
    """``jax.jit(jax.vmap(geneigsolve_golubye))``, one per ``(which,
    in_axes, B given)``, built once for the module."""
    cache = {}

    def get(which, in_axes, with_b=True):
        key = (which, in_axes, with_b)
        if key not in cache:
            alg = JGolubYe(**KW)
            if with_b:
                def solve(A, B, x):
                    return j_golubye(JMatrixOperator(A), JMatrixOperator(B), x, 2, which, alg)
            else:
                in_axes = (in_axes[0], in_axes[2])

                def solve(A, x):
                    return j_golubye(JMatrixOperator(A), None, x, 2, which, alg)
            cache[key] = jax.jit(jax.vmap(solve, in_axes=in_axes))
        return cache[key]

    return get


def _counts(info):
    return [np.asarray(info.numops).tolist(), np.asarray(info.numiter).tolist(),
            np.asarray(info.converged).tolist()]


def _check_pairs(As, Bs, vals, vecs, info, p, op_dim, b_dim=None):
    """``‖A x − λ B x‖`` within ``normres`` + 1e-10 for the two pairs of
    problem ``p``."""
    A = As[p] if op_dim == 0 else As[0]
    for i in range(2):
        x = vecs[p, i].numpy()
        Bx = x if Bs is None else (Bs[p] if b_dim == 0 else Bs[0]) @ x
        res = np.linalg.norm(A @ x - float(vals[p, i]) * Bx)
        assert res <= float(info.normres[p, i]) + 1e-10, (p, i, res)


def test_stack_of_pencils_with_a_shared_start_matches_jax(jax_vmapped):
    """Three float64 pencils, one start (``in_dims=(0, 0, None)``), 2 "SR":
    the problems stop in different cycles (144/18, 168/21, 176/22 applies
    and cycles, as ``jax.vmap`` gives them), values within 1e-10 of the JAX
    package's, each pair's residual within its ``normres`` + 1e-10, and each
    problem within 1e-12 of its one-problem solve (counts equal)."""
    As, Bs, x0 = _pencils()
    vj, _, ij = jax_vmapped("SR", (0, 0, None))(jnp.asarray(As), jnp.asarray(Bs), jnp.asarray(x0))
    vals, vecs, info = kt.geneigsolve_golubye_batched(
        convert.matrices_from_numpy(As, "cpu"), convert.matrices_from_numpy(Bs, "cpu"),
        torch.from_numpy(x0), 2, "SR", kt.GolubYe(**KW), in_dims=(0, 0, None))
    assert _counts(info) == _counts(ij) == [[144, 168, 176], [18, 21, 22], [2, 2, 2]]
    assert info.numops.dtype == torch.int64 and vals.shape == (P, 2) and vecs.shape == (P, 2, N)
    assert info.normres.shape == (P, 2) and info.residual.shape == (P, 2, N)
    np.testing.assert_allclose(vals.numpy(), np.asarray(vj), rtol=0, atol=1e-10)
    for p in range(P):
        _check_pairs(As, Bs, vals, vecs, info, p, 0, 0)
        v1, _, i1 = t_golubye(as_operator(torch.from_numpy(As[p])),
                              as_operator(torch.from_numpy(Bs[p])), torch.from_numpy(x0), 2, "SR",
                              kt.GolubYe(**KW))
        assert [i1.numops, i1.numiter, i1.converged] == [c[p] for c in _counts(info)]
        np.testing.assert_allclose(vals[p].numpy(), v1.numpy(), rtol=0, atol=1e-12)


def test_shared_pencil_with_three_starts_is_each_one_problem_solve(jax_vmapped):
    """One shared pencil, three starts (``in_dims=(None, None, 0)``), 2
    "LR": counts equal to ``jax.vmap``'s, values within 1e-10, and each
    problem bit-identical to its one-problem solve (values, vectors,
    residuals, residual norms, counts)."""
    As, Bs, _ = _pencils(seed=11)
    X = np.random.default_rng(12).standard_normal((P, N))
    vj, _, ij = jax_vmapped("LR", (None, None, 0))(jnp.asarray(As[0]), jnp.asarray(Bs[0]),
                                                   jnp.asarray(X))
    A, B = torch.from_numpy(As[0]), torch.from_numpy(Bs[0])
    vals, vecs, info = kt.geneigsolve_golubye_batched(A, B, torch.from_numpy(X), 2, "LR",
                                                      kt.GolubYe(**KW))
    assert _counts(info) == _counts(ij)
    np.testing.assert_allclose(vals.numpy(), np.asarray(vj), rtol=0, atol=1e-10)
    for p in range(P):
        _check_pairs(As, Bs, vals, vecs, info, p, None)
        v1, w1, i1 = t_golubye(as_operator(A), as_operator(B), torch.from_numpy(X[p]), 2, "LR",
                               kt.GolubYe(**KW))
        assert torch.equal(vals[p], v1) and torch.equal(vecs[p], w1)
        assert torch.equal(info.residual[p], i1.residual)
        assert torch.equal(info.normres[p], i1.normres)
        assert [i1.numops, i1.numiter, i1.converged] == [c[p] for c in _counts(info)]


def test_custom_inner_product_space_is_each_problems_one_problem_solve():
    """A space with its own inner product (``VectorSpace(inner_fn=...)``,
    twice the Euclidean one: the projected pencil scales as a whole, so the
    values are the pencil's): one shared pencil, three starts, 2 "SR";
    each start is normalised in that space, and every problem is
    bit-identical to its one-problem solve in the same space (values,
    vectors, residual norms, counts); the values within 1e-10 of numpy's
    eigenvalues of ``B⁻¹A``."""
    As, Bs, _ = _pencils(seed=13)
    X = torch.from_numpy(np.random.default_rng(14).standard_normal((P, N)))
    A, B = torch.from_numpy(As[0]), torch.from_numpy(Bs[0])
    space = kt.VectorSpace(inner_fn=lambda x, y: 2.0 * torch.vdot(x, y))
    alg = kt.GolubYe(**KW)
    vals, vecs, info = kt.geneigsolve_golubye_batched(A, B, X, 2, "SR", alg, space)
    assert info.converged.tolist() == [2] * P
    want = np.sort(np.linalg.eigvals(np.linalg.solve(Bs[0], As[0])).real)[:2]
    np.testing.assert_allclose(vals.numpy(), np.broadcast_to(want, (P, 2)), rtol=0, atol=1e-10)
    for p in range(P):
        v1, w1, i1 = t_golubye(as_operator(A), as_operator(B), X[p], 2, "SR", alg, space)
        assert torch.equal(vals[p], v1) and torch.equal(vecs[p], w1)
        assert torch.equal(info.normres[p], i1.normres)
        assert [i1.numops, i1.numiter, i1.converged] == [c[p] for c in _counts(info)]


def test_complex_hermitian_stack_with_identity_b_matches_jax(jax_vmapped):
    """``B = None`` (the identity, shared whatever its ``in_dims`` entry)
    with three complex128 Hermitian matrices and three starts: counts equal
    to ``jax.vmap``'s, values within 1e-10, ``‖A x − λ x‖`` within
    ``normres`` + 1e-10, and the values within 1e-10 of ``numpy.linalg.eigvalsh``."""
    As, _, _ = _pencils(seed=13, dtype=np.complex128)
    rng = np.random.default_rng(14)
    X = rng.standard_normal((P, N)) + 1j * rng.standard_normal((P, N))
    vj, _, ij = jax_vmapped("SR", (0, None, 0), with_b=False)(jnp.asarray(As), jnp.asarray(X))
    vals, vecs, info = kt.geneigsolve_golubye_batched(
        convert.matrices_from_numpy(As, "cpu"), None, torch.from_numpy(X), 2, "SR",
        kt.GolubYe(**KW), in_dims=(0, 0, 0))
    assert _counts(info) == _counts(ij)
    assert vecs.dtype == torch.complex128
    np.testing.assert_allclose(vals.numpy(), np.asarray(vj), rtol=0, atol=1e-10)
    for p in range(P):
        _check_pairs(As, None, vals, vecs, info, p, 0)
        if info.converged[p] == 2:
            np.testing.assert_allclose(vals[p].numpy(), np.linalg.eigvalsh(As[p])[:2], rtol=0,
                                       atol=1e-10)


def _q1(ny, nx, dtype):
    """The Q1 pencil on an ``ny × nx`` grid: two ``BandedOperator``\\ s on
    the CPU and the two dense matrices."""
    (K, M), n = q1_coo(np, ny, nx, dtype), ny * nx
    dense = []
    for rows, cols, vals in (K, M):
        D = np.zeros((n, n), dtype=dtype)
        D[rows, cols] = vals
        dense.append(D)
    return (kt.banded_from_coo(*K, n, device="cpu"), kt.banded_from_coo(*M, n, device="cpu"),
            n, dense)


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


def test_shared_banded_q1_pencil_is_bit_identical_and_batches_k3(monkeypatch):
    """The Q1 pencil on an 8 × 12 grid (no repeated eigenvalues) as two
    shared float64 ``BandedOperator``\\ s, three starts, 2 "SR": each
    problem bit-identical to its one-problem solve; every pencil apply is
    one batched apply of each operator (each problem's batched applies
    equal to twice its ``numops``), the K3 wrapper's batched entry runs
    twice per batched apply of the pencil and its one-problem entry never;
    converged values within 1e-10 of ``numpy.linalg.eigh`` of ``M⁻¹K``."""
    Kb, Mb, n, (Kd, Md) = _q1(8, 12, np.float64)
    X = torch.from_numpy(np.random.default_rng(15).standard_normal((P, n)))
    alg = kt.GolubYe(krylovdim=10, tol=1e-10, maxiter=60)
    calls = _counting(monkeypatch, bd, ("banded_spmv", "banded_spmv_batched"))
    with ApplyRecorder(batched_mod) as rec:
        vals, vecs, info = kt.geneigsolve_golubye_batched(Kb, Mb, X, 2, "SR", alg)
    assert calls == {"banded_spmv": 0, "banded_spmv_batched": rec.calls}
    assert rec.per_problem == {p: 2 * info.numops[p].item() for p in range(P)}
    want = np.sort(np.linalg.eigvals(np.linalg.solve(Md, Kd)).real)[:2]
    for p in range(P):
        v1, w1, i1 = t_golubye(Kb, Mb, X[p], 2, "SR", alg)
        assert torch.equal(vals[p], v1) and torch.equal(vecs[p], w1)
        assert torch.equal(info.residual[p], i1.residual)
        assert [i1.numops, i1.numiter, i1.converged] == [c[p] for c in _counts(info)]
        assert i1.converged == 2
        np.testing.assert_allclose(vals[p].numpy(), want, rtol=0, atol=1e-10)


def test_projection_flag_batches_k5_k6_bit_for_bit(monkeypatch):
    """The float32 Q1 pencil on a 32 × 32 grid (``(8, 128)`` vectors), three
    starts, fixed work (tol 1e-30, maxiter 3), with the projection flag on:
    each problem bit-identical to its one-problem solve with the flag on;
    every sweep is one batched call of the plain K5 twin and one of K6's for
    the three problems (``2·(numops + numiter − 1)`` each, the one-problem
    count), and none a one-problem call."""
    Kb, Mb, n, _ = _q1(32, 32, np.float32)
    X = torch.from_numpy(np.random.default_rng(16).standard_normal((P, 8, 128))
                         .astype(np.float32))
    alg = kt.GolubYe(krylovdim=12, tol=1e-30, maxiter=3)
    calls = _counting(monkeypatch, pb, ("project_pallas", "unproject_pallas",
                                        "project_pallas_batched", "unproject_pallas_batched"))
    monkeypatch.setattr(tbs, "use_pallas_projections", True)
    vals, vecs, info = kt.geneigsolve_golubye_batched(Kb, Mb, X, 2, "SR", alg)
    batched = dict(calls)
    numops, numiter = info.numops.tolist(), info.numiter.tolist()
    assert numops == [numops[0]] * P and numiter == [3] * P
    sweeps = golubye_sweeps(numops[0], numiter[0])
    assert batched == {"project_pallas": 0, "unproject_pallas": 0,
                       "project_pallas_batched": sweeps, "unproject_pallas_batched": sweeps}
    for p in range(P):
        v1, w1, i1 = t_golubye(Kb, Mb, X[p], 2, "SR", alg)
        assert torch.equal(vals[p], v1) and torch.equal(vecs[p], w1)
        assert torch.equal(info.normres[p], i1.normres)
        assert [i1.numops, i1.numiter] == [numops[p], numiter[p]]
    assert calls["project_pallas"] == P * sweeps


def _capture(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return [line for line in buf.getvalue().splitlines() if line.strip()]


def test_warn_lines_are_the_one_problem_lines_in_problem_order():
    """At WARN, one "stopped without convergence" line per unconverged
    problem, with its one-problem text, in problem order (the stack of the
    first test, cut to 10 cycles: two problems end with one value
    converged, one with none)."""
    As, Bs, x0 = _pencils()
    alg = kt.GolubYe(**{**KW, "maxiter": 10, "verbosity": 1})
    lines = _capture(lambda: kt.geneigsolve_golubye_batched(
        convert.matrices_from_numpy(As, "cpu"), convert.matrices_from_numpy(Bs, "cpu"),
        torch.from_numpy(x0), 2, "SR", alg, in_dims=(0, 0, None)))
    one = []
    for p in range(P):
        one += _capture(lambda p=p: t_golubye(as_operator(torch.from_numpy(As[p])),
                                              as_operator(torch.from_numpy(Bs[p])),
                                              torch.from_numpy(x0), 2, "SR", alg))
    assert lines == one and len(lines) == P, (lines, one)
    assert all("GolubYe geneigsolve stopped without convergence" in t for t in lines)
    assert len(set(lines)) == 2, lines


def test_batched_geneigsolve_refusals():
    """Each piece this slice does not batch raises ``ValueError`` with its
    name: an input or an operator tensor that requires grad (``geneigsolve``
    has no rule), ``in_dims`` other than 0 or None, an ``(f, fadjoint)``
    tuple given as a batch; and the argument checks.  A sharded space is
    batched: on a one-rank axis, the unsharded bits, a dict batch too."""
    As, Bs, x0 = _pencils()
    A, B = torch.from_numpy(As[0]), torch.from_numpy(Bs[0])
    X = torch.from_numpy(np.stack([x0] * P))
    alg = kt.GolubYe(**KW)
    solve = kt.geneigsolve_golubye_batched
    grad_A = A.clone().requires_grad_(True)
    cases = [
        (lambda: solve(A, B, X.clone().requires_grad_(True), 1, "SR", alg),
         "geneigsolve_golubye_batched: differentiation has no rule"),
        (lambda: solve(grad_A, B, X, 1, "SR", alg), "differentiation"),
        (lambda: solve(A, B, X, 1, "SR", alg, in_dims=(None, None, 1)), "in_dims"),
        (lambda: solve((lambda x: A @ x, lambda x: A @ x), B, X[:2], 1, "SR", alg,
                       in_dims=(0, None, 0)), "one shared operator"),
        (lambda: solve(A, B, X, 9, "SR", alg), "exceeds krylovdim"),
        (lambda: solve(A, B, X, 1, "SI", alg), "LI/SI"),
        (lambda: solve([A, A], B, X, 1, "SR", alg, in_dims=(0, None, 0)), "disagree"),
    ]
    for call, match in cases:
        with pytest.raises(ValueError, match=match):
            call()
    # a sharded space is batched: on a one-rank axis (no collective) each
    # problem solves as on the unsharded space, bit for bit
    got = solve(A, B, X, 1, "SR", alg, space=kt.VectorSpace(psum_axis=MeshAxis("vec", None, 1, 0)))
    want = solve(A, B, X, 1, "SR", alg)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[2].numops, want[2].numops)
    # a dict batch: each problem is its one-problem dict solve, bit for bit
    dA, dB = (as_operator(lambda x, M=M: {"a": M @ x["a"]}) for M in (A, B))
    Xd = X + torch.arange(P, dtype=X.dtype)[:, None] / 10
    vals, vecs, info = solve(dA, dB, {"a": Xd}, 1, "SR", alg)
    for p in range(P):
        v1, w1, i1 = t_golubye(dA, dB, {"a": Xd[p]}, 1, "SR", alg)
        assert torch.equal(vals[p], v1) and torch.equal(vecs["a"][p], w1["a"])
        assert int(info.numops[p]) == i1.numops
    got = solve(dA, dB, {"a": Xd}, 1, "SR", alg,
                space=kt.VectorSpace(psum_axis=MeshAxis("vec", None, 1, 0)))
    assert torch.equal(got[0], vals) and torch.equal(got[1]["a"], vecs["a"])
    assert torch.equal(got[2].numops, info.numops)
