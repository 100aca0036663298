"""PyTorch port: batched ``Lanczos(reorth="selective")`` eigensolves
(``solvers/batched.py:eigsolve_lanczos_batched`` through
``factorizations/krylov.py:expand_hermitian_selective_batched``) against
``jax.jit(jax.vmap(...))`` of the JAX package's ``eigsolve_lanczos`` on the
same numpy-seeded float64 inputs, and each problem against the port's own
one-problem solve, its drift sweeps included.

Tolerances, stated per test: values within 1e-10 of the JAX package's;
``numops``, ``numiter`` and ``converged`` equal; on a shared operator each
problem bit-identical (``torch.equal``) to its one-problem solve and sweeping
at the same steps; on a matrix stack (one batched product an apply) each
problem's values within 1e-12 of its one-problem solve's, counts and sweeps
equal.
The JAX side is one compiled ``vmap`` over ``(A, x0)``, fed a matrix stack
with a repeated start or a repeated matrix with ``P`` starts, and computed
once per module.  The card test (marker ``cuda``) imports no JAX:

    python -m pytest --noconftest tests/test_torch_batched_selective.py -m cuda
"""

import functools

import numpy as np
import pytest
import torch

import krylovkit_tpu_torch as kt
from chip_smoke import SMALL_SHARDED_TOL, impurity_banded, small_batched_eager_cases
from krylovkit_tpu_torch import convert
from krylovkit_tpu_torch.factorizations import krylov as tkf
from krylovkit_tpu_torch.ops import basis as tbs
from krylovkit_tpu_torch.ops.collectives import MeshAxis
from krylovkit_tpu_torch.ops.vector import tree_leaves, tree_row
from krylovkit_tpu_torch.solvers.lanczos import eigsolve_lanczos as t_lanczos

try:  # the card's machine has no JAX; there only the card test runs
    import jax
    import jax.numpy as jnp
except ImportError:
    jax = None

torch.set_num_threads(2)
P = 3
N = 24
KW = dict(krylovdim=12, tol=1e-10, maxiter=100, reorth="selective")


def counts(info):
    return [np.asarray(info.numops).tolist(), np.asarray(info.numiter).tolist(),
            np.asarray(info.converged).tolist()]


def bits(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _problems():
    """Three symmetric 24 × 24 matrices, then three starts."""
    rng = np.random.default_rng(501)
    As = [rng.standard_normal((N, N)) for _ in range(P)]
    return np.stack([(a + a.T) / 2 for a in As]), rng.standard_normal((P, N))


def cut(v):
    """``v`` cut on its last axis into a two-leaf dict."""
    return {"a": v[..., :10], "b": v[..., 10:]}


def join(t):
    return (torch.cat if isinstance(t["a"], torch.Tensor) else jnp.concatenate)(
        [t["a"], t["b"]], -1)


@functools.lru_cache(maxsize=None)
def _jax_solve():
    """The JAX package's selective Lanczos vmapped over ``(A, x0)``."""
    from krylovkit_tpu import Lanczos as JLanczos
    from krylovkit_tpu.ops.operator import MatrixOperator as JMatrixOperator
    from krylovkit_tpu.solvers.lanczos import eigsolve_lanczos as j_lanczos

    return jax.jit(jax.vmap(lambda A, x: j_lanczos(JMatrixOperator(A), x, 2, "LR",
                                                   JLanczos(**KW))))


@functools.lru_cache(maxsize=None)
def _jax_tree():
    """The same on dict vectors of the shared matrix (values, counts)."""
    from krylovkit_tpu import Lanczos as JLanczos
    from krylovkit_tpu.ops import operator as jop
    from krylovkit_tpu.solvers.lanczos import eigsolve_lanczos as j_lanczos

    As, X = _problems()
    A = jnp.asarray(As[0])
    op = jop.as_operator(lambda x: cut(A @ join(x)))
    vals, _, info = jax.jit(jax.vmap(lambda x: j_lanczos(op, x, 2, "LR", JLanczos(**KW))))(
        cut(jnp.asarray(X)))
    return np.asarray(vals), counts(info)


def _jax():
    if jax is None:
        pytest.skip("needs JAX (the reference)")


class _Sweeps:
    """Records the drift-sweep decisions of the port's one-problem and
    batched selective steps: ``one`` a list, ``batched`` one list per
    problem (the wrapper of ``tests/test_torch_lanczos.py``, batched)."""

    def __init__(self):
        self.one, self.batched = [], {}

    def __enter__(self):
        self._one, self._bat = tkf.expand_hermitian_selective, tkf.expand_hermitian_selective_batched

        def one(*a, **kw):
            out = self._one(*a, **kw)
            self.one.append(out[3])
            return out

        def bat(*a, **kw):
            outs = self._bat(*a, **kw)
            for p, out in outs.items():
                self.batched.setdefault(p, []).append(out[3])
            return outs

        tkf.expand_hermitian_selective, tkf.expand_hermitian_selective_batched = one, bat
        return self

    def __exit__(self, *exc):
        tkf.expand_hermitian_selective, tkf.expand_hermitian_selective_batched = self._one, self._bat


def _one_problem(op, x, alg, howmany=2, which="LR"):
    """The port's one-problem solve and its sweep decisions."""
    with _Sweeps() as s:
        out = t_lanczos(kt.as_operator(op), x, howmany, which, alg)
    return out, s.one


@pytest.mark.parametrize("case", ["matrix_stack", "shared_matrix"])
def test_batched_selective_matches_jax_vmap(case):
    """A matrix stack with one shared start (problems stop apart), and one
    shared matrix with ``P`` starts: values within 1e-10 of
    ``jax.jit(jax.vmap(...))``, counts equal; each problem its one-problem
    solve (bit for bit on the shared matrix, 1e-12 on the stack) with the
    same sweeps."""
    _jax()
    As, X = _problems()
    alg = kt.Lanczos(**KW)
    if case == "matrix_stack":
        jA, jX = As, np.repeat(X[:1], P, 0)
        op, x0, dims = convert.matrices_from_numpy(As, "cpu"), torch.from_numpy(X[0]), (0, None)
    else:
        jA, jX = np.repeat(As[:1], P, 0), X
        op, x0, dims = torch.from_numpy(As[0]), torch.from_numpy(X), (None, 0)
    jv, _, ji = _jax_solve()(jnp.asarray(jA), jnp.asarray(jX))
    with _Sweeps() as s:
        vals, vecs, info = kt.eigsolve_lanczos_batched(op, x0, 2, "LR", alg, in_dims=dims)
    np.testing.assert_allclose(vals.numpy(), np.asarray(jv), rtol=0, atol=1e-10)
    assert counts(info) == counts(ji) and counts(info)[2] == [2] * P
    if case == "matrix_stack":
        assert len(set(counts(info)[0])) > 1  # the problems stop apart
    for p in range(P):
        A = torch.from_numpy(As[p] if case == "matrix_stack" else As[0])
        (v1, w1, i1), sweeps = _one_problem(A, torch.from_numpy(X[0] if dims[1] is None else X[p]),
                                            alg)
        assert [c[p] for c in counts(info)] == [i1.numops, i1.numiter, i1.converged]
        assert s.batched[p] == sweeps and len(sweeps) == i1.numops
        if case == "shared_matrix":
            assert torch.equal(vals[p], v1) and torch.equal(vecs[p], w1)
            assert torch.equal(info.residual[p], i1.residual)
            assert torch.equal(info.normres[p], i1.normres)
        else:
            np.testing.assert_allclose(vals[p].numpy(), v1.numpy(), rtol=0, atol=1e-12)


def test_batched_selective_on_dict_vectors_matches_jax_vmap():
    """``P`` dict starts (10 + 14 entries) of the shared matrix: values within
    1e-10 of the vmapped JAX tree solve, counts equal; each problem its
    one-problem dict solve bit for bit, with the same sweeps."""
    _jax()
    As, X = _problems()
    A = torch.from_numpy(As[0])

    def op(x):
        return cut(A @ join(x))

    alg = kt.Lanczos(**KW)
    Xt = cut(torch.from_numpy(X))
    with _Sweeps() as s:
        vals, vecs, info = kt.eigsolve_lanczos_batched(op, Xt, 2, "LR", alg)
    jv, jc = _jax_tree()
    np.testing.assert_allclose(vals.numpy(), jv, rtol=0, atol=1e-10)
    assert counts(info) == jc
    for p in range(P):
        (v1, w1, i1), sweeps = _one_problem(op, tree_row(Xt, p), alg)
        assert torch.equal(vals[p], v1) and bits(tree_row(vecs, p), w1)
        assert bits(tree_row(info.residual, p), i1.residual)
        assert s.batched[p] == sweeps and i1.numops == counts(info)[0][p]


def test_batched_selective_with_the_projection_flag():
    """Config 2's Poisson plus the wells at ``N = 32`` (float32 ``(8, 128)``
    vectors, a shared ``BandedOperator``), 4 "SR", krylovdim 30, tol 1e-5,
    three starts, the projection flag on: each problem its one-problem
    solve with the flag, bit for bit, sweeps equal; the sweeps of a
    lock-step are one ``project_batched`` and one ``unproject_batched``
    call, made only in the lock-steps where a problem sweeps."""
    op = impurity_banded(np, kt, 32, "cpu")
    rng = np.random.default_rng(6)
    X = torch.from_numpy(rng.standard_normal((P, 8, 128)).astype(np.float32))
    alg = kt.Lanczos(krylovdim=30, maxiter=10, tol=1e-5, reorth="selective")
    calls = []
    proj, unproj = tbs.project_batched, tbs.unproject_batched

    def rec(name, f):
        def g(*a, **kw):
            calls.append(name)
            return f(*a, **kw)
        return g

    tbs.use_pallas_projections = True
    tbs.project_batched, tbs.unproject_batched = rec("project", proj), rec("unproject", unproj)
    try:
        with _Sweeps() as s:
            vals, vecs, info = kt.eigsolve_lanczos_batched(op, X, 4, "SR", alg)
        ones = [_one_problem(op, X[p], alg, 4, "SR") for p in range(P)]
    finally:
        tbs.use_pallas_projections = False
        tbs.project_batched, tbs.unproject_batched = proj, unproj
    steps = max(len(f) for f in s.batched.values())
    sweeping = sum(any(f[i] for f in s.batched.values() if i < len(f)) for i in range(steps))
    assert calls.count("project") == calls.count("unproject") == sweeping > 0
    for p, ((v1, w1, i1), sweeps) in enumerate(ones):
        assert torch.equal(vals[p], v1) and torch.equal(vecs[p], w1)
        assert s.batched[p] == sweeps and int(info.numops[p]) == i1.numops
    assert counts(info)[2] == [4] * P


def test_selective_with_eager_is_refused_and_a_sharded_space_batches():
    """``selective`` with ``eager=True`` raises as the one-problem driver
    does; on a one-rank sharded axis a selective batch is the unsharded one,
    bit for bit."""
    As, X = _problems()
    A, Xt = torch.from_numpy(As[0]), torch.from_numpy(X)
    with pytest.raises(ValueError, match="eigsolve_lanczos_batched.*incompatible with eager"):
        kt.eigsolve_lanczos_batched(A, Xt, 2, "LR", kt.Lanczos(**KW, eager=True))
    with pytest.raises(ValueError, match="incompatible with eager"):
        t_lanczos(kt.as_operator(A), Xt[0], 2, "LR", kt.Lanczos(**KW, eager=True))
    one = kt.VectorSpace(psum_axis=MeshAxis("vec", None, 1, 0))
    got = kt.eigsolve_lanczos_batched(A, Xt, 2, "LR", kt.Lanczos(**KW), space=one)
    want = kt.eigsolve_lanczos_batched(A, Xt, 2, "LR", kt.Lanczos(**KW))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert counts(got[2]) == counts(want[2])


@pytest.mark.cuda
def test_batched_selective_on_the_card():
    """The small float64 selective batches of ``chip_smoke.py``'s phase
    ``batched_eager_selective`` (a matrix, a dict tree) on the card against
    the CPU: within ``SMALL_SHARDED_TOL``, counts equal, each problem
    bit-identical to its one-problem solve on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for name in ("lanczos_selective", "lanczos_selective_dict"):
        vc, cc, bc = small_batched_eager_cases(torch, np, kt, "cuda")[name]()
        vh, ch, _ = small_batched_eager_cases(torch, np, kt, "cpu", one_problem=False)[name]()
        assert float((vc - vh).abs().max()) <= SMALL_SHARDED_TOL * max(float(vh.abs().max()), 1)
        assert cc == ch and bc
