"""PyTorch port: batched eigensolves on pytree vectors (the counterpart of
``jax.vmap`` over a JAX eigensolver whose vectors are pytrees).

Lanczos (tuples), Golub-Ye (dicts) and Block Lanczos (``(P, b, ...)`` dict
leaves) are held against ``jax.jit(jax.vmap(...))`` of the JAX drivers on
the same numpy-seeded float64 inputs: values within 1e-8, ``numops``,
``numiter`` and ``converged`` equal, every output's tree structure and leaf
shapes equal.  ``schursolve``, ``eigsolve_arnoldi``, ``realeigsolve_arnoldi``
(tuples) and BiArnoldi (a ``(v0, w0)`` pair of tuples) are held against the
port's one-problem tree solves, bit for bit (``torch.equal`` leaf by leaf).
The leaf routes: under ``eigsolve_lanczos_batched`` a ``((kmax, 16, 128)
f32, (kmax, 40) f32)`` basis takes the batched K2 (its plain version here)
once per rotation for its first leaf and never for its second.  The card
test (marker ``cuda``) runs config 1 at ``R = 64`` on a tuple; it imports
no JAX, so on a machine with a card and without JAX

    python -m pytest --noconftest tests/test_torch_batched_pytree_eig.py -m cuda

runs it alone.
"""

import numpy as np
import pytest
import torch

import krylovkit_tpu_torch as kt
from chip_smoke import _tree_map_of, _tree_of, batched_starts
from krylovkit_tpu_torch import _build
from krylovkit_tpu_torch.ops import basis as tbs
from krylovkit_tpu_torch.ops.operator import as_operator
from krylovkit_tpu_torch.ops.vector import tree_leaves, tree_row
from krylovkit_tpu_torch.solvers import arnoldi as tarn
from krylovkit_tpu_torch.solvers import batched as tbatched
from krylovkit_tpu_torch.solvers import biarnoldi as tba
from krylovkit_tpu_torch.solvers import lanczos as tlz

try:  # the card's machine has no JAX; there only the card test runs
    import jax
    import jax.numpy as jnp
except ImportError:
    jax = None

torch.set_num_threads(2)
P = 3
TOL = 1e-10


def cut(v, kind, at):
    """``v`` cut on its last axis into a dict or a tuple of two leaves."""
    a, b = v[..., :at], v[..., at:]
    return {"a": a, "b": b} if kind == "dict" else (a, b)


def join(t):
    parts = [t["a"], t["b"]] if isinstance(t, dict) else list(t)
    return (torch.cat if isinstance(parts[0], torch.Tensor) else jnp.concatenate)(parts, -1)


def op_pair(M, kind, at):
    """The matrix ``M`` on ``(kind, at)`` trees: the JAX operator and the
    port's callable."""
    from krylovkit_tpu.ops import operator as jop

    Mj, Mt = jnp.asarray(M), torch.from_numpy(M)
    return (jop.as_operator(lambda x: cut(Mj @ join(x), kind, at)),
            lambda x: cut(Mt @ join(x), kind, at))


def counts(info):
    return [np.asarray(info.numops).tolist(), np.asarray(info.numiter).tolist(),
            np.asarray(info.converged).tolist()]


def same_tree(t, j):
    """Equal tree structure and leaf shapes."""
    assert jax.tree_util.tree_structure(t) == jax.tree_util.tree_structure(j)
    for a, b in zip(tree_leaves(t), jax.tree_util.tree_leaves(j)):
        assert tuple(a.shape) == tuple(b.shape)


def bits(t, u):
    la, lb = tree_leaves(t), tree_leaves(u)
    return len(la) == len(lb) and all(torch.equal(a, b) for a, b in zip(la, lb))


def _sym(seed, n):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    return (A + A.T) / 2, rng


def _jax():
    if jax is None:
        pytest.skip("needs JAX (the reference)")


def test_batched_lanczos_on_tuples_matches_jax_vmap():
    """``P`` tuple starts (12 + 28 entries) of one symmetric 40 × 40 map."""
    _jax()
    from krylovkit_tpu import Lanczos as JLanczos
    from krylovkit_tpu.solvers.lanczos import eigsolve_lanczos as j_lanczos

    A, rng = _sym(301, 40)
    X = rng.standard_normal((P, 40))
    opj, opt = op_pair(A, "tuple", 12)
    kw = dict(krylovdim=12, tol=TOL, maxiter=100)
    vj, Vj, ij = jax.jit(jax.vmap(lambda x: j_lanczos(opj, x, 2, "SR", JLanczos(**kw))))(
        cut(jnp.asarray(X), "tuple", 12))
    vt, Vt, it = kt.eigsolve_lanczos_batched(opt, cut(torch.from_numpy(X), "tuple", 12), 2, "SR",
                                             kt.Lanczos(**kw))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0, atol=1e-8)
    assert counts(it) == counts(ij) and counts(it)[2] == [2] * P
    for t, j in ((Vt, Vj), (it.residual, ij.residual)):
        same_tree(t, j)
    np.testing.assert_allclose(vt.numpy(), np.linalg.eigvalsh(A)[None, :2].repeat(P, 0),
                               atol=1e-8)
    for p in range(P):
        for i in range(2):
            u, w = join(Vt)[p, i].numpy(), np.asarray(join(Vj))[p, i]
            assert abs(abs(u @ w) - 1) < 1e-8


def test_batched_geneigsolve_on_dicts_matches_jax_vmap():
    """``P`` dict starts (9 + 11 entries) of one 20 × 20 pencil."""
    _jax()
    from krylovkit_tpu import GolubYe as JGolubYe
    from krylovkit_tpu.solvers.golubye import geneigsolve_golubye as j_golubye

    A, rng = _sym(302, 20)
    C = rng.standard_normal((20, 20))
    B = C @ C.T / 20 + np.eye(20)
    X = rng.standard_normal((P, 20))
    (aj, at), (bj, bt) = op_pair(A, "dict", 9), op_pair(B, "dict", 9)
    kw = dict(krylovdim=10, tol=TOL, maxiter=50)
    vj, Vj, ij = jax.jit(jax.vmap(lambda x: j_golubye(aj, bj, x, 2, "SR", JGolubYe(**kw))))(
        cut(jnp.asarray(X), "dict", 9))
    vt, Vt, it = kt.geneigsolve_golubye_batched(as_operator(at), as_operator(bt),
                                                cut(torch.from_numpy(X), "dict", 9), 2, "SR",
                                                kt.GolubYe(**kw))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0, atol=1e-8)
    assert counts(it) == counts(ij) and counts(it)[2] == [2] * P
    for t, j in ((Vt, Vj), (it.residual, ij.residual)):
        same_tree(t, j)


def test_batched_block_lanczos_on_dict_blocks_matches_jax_vmap():
    """``P`` start blocks of 3 dict rows (15 + 25 entries), leaves ``(P, 3,
    ...)``."""
    _jax()
    from krylovkit_tpu import BlockLanczos as JBlockLanczos
    from krylovkit_tpu.solvers.blocklanczos import eigsolve_blocklanczos as j_block

    A, rng = _sym(303, 40)
    X = rng.standard_normal((P, 3, 40))
    opj, opt = op_pair(A, "dict", 15)
    kw = dict(krylovdim=15, tol=TOL, maxiter=100)
    vj, Vj, ij = jax.jit(jax.vmap(lambda x: j_block(opj, x, 3, "LR", JBlockLanczos(**kw))))(
        cut(jnp.asarray(X), "dict", 15))
    vt, Vt, it = kt.eigsolve_blocklanczos_batched(opt, cut(torch.from_numpy(X), "dict", 15), 3,
                                                  "LR", kt.BlockLanczos(**kw))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0, atol=1e-8)
    assert counts(it) == counts(ij) and counts(it)[2] == [3] * P
    for t, j in ((Vt, Vj), (it.residual, ij.residual)):
        same_tree(t, j)
    np.testing.assert_allclose(vt.numpy(), np.linalg.eigvalsh(A)[None, ::-1][:, :3].repeat(P, 0),
                               atol=1e-8)


def test_batched_arnoldi_on_tuples_are_the_one_problem_solves():
    """``schursolve``, ``eigsolve_arnoldi`` and ``realeigsolve_arnoldi`` of
    a nonsymmetric 30 × 30 map on two tuple starts (11 + 19): each problem
    is its one-problem tuple solve, bit for bit."""
    P = 2
    rng = np.random.default_rng(304)
    A = torch.from_numpy(rng.standard_normal((30, 30)) / 30 ** 0.5
                         + np.diag(np.linspace(1, 3, 30)))
    X = cut(torch.from_numpy(rng.standard_normal((P, 30))), "tuple", 11)
    op = as_operator(lambda x: cut(A @ join(x), "tuple", 11))
    alg = kt.Arnoldi(krylovdim=24, tol=TOL, maxiter=100)
    T, V, (re, im), info = kt.schursolve_batched(op, X, 3, "LM", alg)
    for p in range(P):
        T1, V1, (re1, im1), i1 = tarn.schursolve(op, tree_row(X, p), 3, "LM", alg)
        assert torch.equal(T[p], T1) and bits(tree_row(V, p), V1)
        assert torch.equal(re[p], re1) and torch.equal(im[p], im1)
        assert bits(tree_row(info.residual, p), i1.residual)
        assert [c[p] for c in counts(info)] == [i1.numops, i1.numiter, i1.converged]
    for batched, one in ((kt.eigsolve_arnoldi_batched, tarn.eigsolve_arnoldi),
                         (kt.realeigsolve_arnoldi_batched, tarn.realeigsolve_arnoldi)):
        out = batched(op, X, 3, "LR", alg)
        assert isinstance(out[1], tuple) and tuple(out[1][1].shape) == (P, 3, 19)
        for p in range(P):
            o = one(op, tree_row(X, p), 3, "LR", alg)
            assert torch.equal(out[0][p], o[0]) and bits(tree_row(out[1], p), o[1])
            assert [c[p] for c in counts(out[2])] == [o[2].numops, o[2].numiter, o[2].converged]


def test_batched_bieigsolve_on_a_pair_of_tuples_is_the_one_problem_solve():
    """A ``(v0, w0)`` pair of two tuple batches (13 + 11 entries) of a
    24 × 24 map given as ``(f, fadjoint)``: each problem is its one-problem
    solve, bit for bit."""
    P = 2
    rng = np.random.default_rng(305)
    A = torch.from_numpy(rng.standard_normal((24, 24)))
    V0, W0 = (cut(torch.from_numpy(rng.standard_normal((P, 24))), "tuple", 13) for _ in range(2))
    pair = (lambda x: cut(A @ join(x), "tuple", 13), lambda y: cut(A.T @ join(y), "tuple", 13))
    alg = kt.BiArnoldi(krylovdim=22, tol=TOL, maxiter=50)
    vals, (V, W), (iV, iW) = kt.bieigsolve_batched(pair, V0, W0, 2, "LM", alg)
    for p in range(P):
        v1, (V1, W1), (i1, j1) = tba.bieigsolve_driver(as_operator(pair), tree_row(V0, p),
                                                       tree_row(W0, p), 2, "LM", alg)
        assert torch.equal(vals[p], v1) and bits(tree_row(V, p), V1) and bits(tree_row(W, p), W1)
        assert [c[p] for c in counts(iV)] == [i1.numops, i1.numiter, i1.converged]


def test_batched_lanczos_rotates_each_leaf_by_its_route(monkeypatch):
    """A ``((kmax, 16, 128) f32, (kmax, 40) f32)`` basis: every rotation
    (``solvers/batched.py:_rotate``) makes one batched K2 call (its plain
    version here) for the first leaf and none for the second, which takes
    the plain product problem by problem; no one-problem K2 runs.  Each
    problem is its one-problem tuple solve, bit for bit."""
    seen = {"batched": [], "one": 0, "rotations": 0}
    real_b, real_1, real_rot = (tbs.transform_partial_inplace_batched,
                                tbs.transform_partial_inplace, tbatched._rotate)

    def batched(V, U, m_out, active=None):
        seen["batched"].append(tuple(V.shape))
        return real_b(V, U, m_out, active)

    def one(*a, **k):
        seen["one"] += 1
        return real_1(*a, **k)

    def rotate(*a, **k):
        seen["rotations"] += 1
        return real_rot(*a, **k)

    monkeypatch.setattr(tbs, "transform_partial_inplace_batched", batched)
    monkeypatch.setattr(tbs, "transform_partial_inplace", one)
    monkeypatch.setattr(tbatched, "_rotate", rotate)
    gen = torch.Generator().manual_seed(306)
    d = torch.linspace(0.5, 1.5, 40)
    X = (torch.randn((2, 16, 128), generator=gen), torch.randn((2, 40), generator=gen))
    lap = kt.laplacian_1d(16 * 128, device="cpu")
    op = as_operator(lambda x: (lap.normal(x[0]), d * x[1]))
    alg = kt.Lanczos(krylovdim=10, tol=1e-5, maxiter=4)
    vals, vecs, info = kt.eigsolve_lanczos_batched(op, X, 2, "LM", alg)
    assert seen["rotations"] >= 2 and seen["one"] == 0
    assert seen["batched"] == [(2, 11, 16, 128)] * seen["rotations"]
    monkeypatch.undo()
    for p in range(2):
        v1, w1, i1 = tlz.eigsolve_lanczos(op, tree_row(X, p), 2, "LM", alg)
        assert torch.equal(vals[p], v1) and bits(tree_row(vecs, p), w1)
        assert [c[p] for c in counts(info)] == [i1.numops, i1.numiter, i1.converged]


@pytest.mark.cuda
def test_batched_config1_on_a_tuple_on_the_card():
    """Config 1 at ``R = 64`` (``laplacian_1d(2^13)`` as a tuple of two
    ``(32, 128)`` float32 leaves), 3 starts, 4 "LM", krylovdim 30, maxiter
    10, tol 1e-30: every problem is its one-problem tuple solve on the card
    bit for bit, with 138 / 10, and the batch launches the batched K2 once
    per leaf per rotation, as many as one problem's K2, and no one-problem
    kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _build.build()
    R = 64
    lap = kt.laplacian_1d(R * 128, device="cuda")
    t = _tree_of(torch, "tuple", R // 2)
    op = _tree_map_of(torch, kt, lap.normal, t, t, torch.float32)
    X = batched_starts(torch, np, R, 3, "cuda")
    Xt = (X[:, :R // 2], X[:, R // 2:])
    alg = kt.Lanczos(krylovdim=30, maxiter=10, tol=1e-30, verbosity=kt.SILENT)
    _build.reset_launches()
    vals, vecs, info = kt.eigsolve_lanczos_batched(op, Xt, 4, "LM", alg)
    torch.cuda.synchronize()
    launches = {k: v for k, v in _build.launches.items() if v}
    assert info.numops.tolist() == [138] * 3 and info.numiter.tolist() == [10] * 3
    for p in range(3):
        _build.reset_launches()
        v1, w1, i1 = tlz.eigsolve_lanczos(op, tree_row(Xt, p), 4, "LM", alg)
        torch.cuda.synchronize()
        one = {k: v for k, v in _build.launches.items() if v}
        assert torch.equal(vals[p], v1) and bits(tree_row(vecs, p), w1)
        assert bits(tree_row(info.residual, p), i1.residual)
        assert set(one) == {"transform_partial"}
    assert launches == {"transform_partial_batched": one["transform_partial"]}
    assert one["transform_partial"] % 2 == 0
