"""PyTorch port: pytree vectors in GKL (``svdsolve``, ``realsvdsolve``),
LSMR (``lssolve``), the matrix functions (``exponentiate``,
``expintegrator``), Golub-Ye (``geneigsolve``) and Block Lanczos, against
the JAX package on the CPU.

The same numpy-seeded matrices go through both packages as callables on
dict and tuple vectors (a vector split into leaves of unequal length); the
maps of ``svdsolve`` and ``lssolve`` take a domain tree that differs from
their codomain tree.  Values agree within 1e-10 and ``numops``,
``numiter`` and ``converged`` are equal.  ``test_geneig_pytree_mode`` of
``tests/test_geneigsolve.py`` is mirrored here.  The fused gates still
refuse a tree, as the JAX package's do.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import krylovkit_tpu as kk
import krylovkit_tpu_torch as kt
from krylovkit_tpu_torch.factorizations import gkl as tgf
from krylovkit_tpu_torch.factorizations import krylov as tkf
from krylovkit_tpu_torch.ops import vector as tvec
from testsetup import hermitize, rand_mat, rand_vec

torch.set_num_threads(2)
TOL = 1e-10


class Tree:
    """A vector as a ``kind`` tree cut at ``cut``: a dict ``{"a", "b"}`` or
    a tuple of two leaves, for either package."""

    def __init__(self, kind, cut):
        self.kind, self.cut = kind, cut

    def split(self, v):
        a, b = v[:self.cut], v[self.cut:]
        return {"a": a, "b": b} if self.kind == "dict" else (a, b)

    def join(self, t):
        parts = [t["a"], t["b"]] if self.kind == "dict" else list(t)
        return jnp.concatenate(parts) if isinstance(parts[0], jnp.ndarray) else torch.cat(parts)

    def jax(self, v):
        return self.split(jnp.asarray(v))

    def torch(self, v):
        return self.split(torch.from_numpy(np.asarray(v)))

    def host(self, t):
        """A tree of either package as one numpy vector (stacked trees keep
        their leading axis)."""
        leaves = [t["a"], t["b"]] if self.kind == "dict" else list(t)
        return np.concatenate([np.asarray(l) for l in leaves], axis=-1)


def maps(A, dom: Tree, cod: Tree):
    """``(f, fadjoint)`` of the matrix ``A`` between the two trees, for the
    JAX package and for the port."""
    Aj, At = jnp.asarray(A), torch.from_numpy(A)

    def pair(M):
        return (lambda x: cod.split(M @ dom.join(x)),
                lambda y: dom.split(M.conj().T @ cod.join(y)))

    return pair(Aj), pair(At)


def counts(info):
    return int(info.numops), int(info.numiter), int(info.converged)


def close(got, want, atol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


SVD_CASES = [("svdsolve", "LR", np.float64), ("svdsolve", "SR", np.float64),
             ("realsvdsolve", "LR", np.float64), ("svdsolve", "LR", np.complex128)]


@pytest.mark.parametrize("front_end,which,dtype", SVD_CASES)
def test_svdsolve_on_trees_matches_jax(front_end, which, dtype):
    """Codomain a tuple of 17 + 23 entries, domain a dict of 12 + 18."""
    rng = np.random.default_rng(201)
    A = rand_mat(rng, 40, 30, dtype)
    cod, dom = Tree("tuple", 17), Tree("dict", 12)
    fj, ft = maps(A, dom, cod)
    # a start in range(A): a component in the left null space stalls "SR"
    # (the reference's tests start from a column of A, test/svdsolve.jl:13)
    x0 = A @ rand_vec(rng, 30, dtype)
    kw = dict(krylovdim=20, tol=TOL, maxiter=200)
    Sj, Uj, Vj, ij = getattr(kk, front_end)(fj, cod.jax(x0), 3, which, **kw)
    St, Ut, Vt, it = getattr(kt, front_end)(ft, cod.torch(x0), 3, which, **kw)
    close(St, Sj)
    assert counts(it) == counts(ij)
    assert counts(it)[2] >= 3
    # the triplets: A v = σ u on the joined vectors, u and v in their trees
    U, V = cod.host(Ut), dom.host(Vt)
    assert U.shape == (3, 40) and V.shape == (3, 30)
    np.testing.assert_allclose(A @ V.T, U.T * St.numpy(), atol=1e-9)


@pytest.mark.parametrize("lam", [0.0, 0.5])
def test_lssolve_on_trees_matches_jax(lam):
    """``b`` a dict in the codomain, ``x`` a tuple in the domain."""
    rng = np.random.default_rng(202)
    A = rand_mat(rng, 40, 30, np.float64)
    cod, dom = Tree("dict", 25), Tree("tuple", 9)
    fj, ft = maps(A, dom, cod)
    b = rand_vec(rng, 40, np.float64)
    xj, ij = kk.lssolve(fj, cod.jax(b), lam, tol=TOL, maxiter=400)
    xt, it = kt.lssolve(ft, cod.torch(b), lam, tol=TOL, maxiter=400)
    close(dom.host(xt), dom.host(xj))
    assert counts(it) == counts(ij)
    want = np.linalg.solve(A.T @ A + lam ** 2 * np.eye(30), A.T @ b)
    close(dom.host(xt), want, atol=1e-8)


def make_pencil(rng, m, dtype):
    A = hermitize(rand_mat(rng, m, m, dtype))
    C = rand_mat(rng, m, m, dtype)
    return A, C @ C.conj().T + 2 * np.eye(m, dtype=dtype)


@pytest.mark.parametrize("kind,krylovdim", [("dict", 20), ("tuple", 8)])
def test_geneigsolve_on_trees_matches_jax(kind, krylovdim):
    """``tests/test_geneigsolve.py:128 test_geneig_pytree_mode`` (a dict,
    the whole space in one cycle), and a tuple with restarts."""
    n = 20
    rng = np.random.default_rng(46)
    A, B = make_pencil(rng, n, np.float64)
    x0 = rand_vec(rng, n, np.float64)
    tree = Tree(kind, n // 2)
    (aj, _), (at, _) = maps(A, tree, tree)
    (bj, _), (bt, _) = maps(B, tree, tree)
    kw = dict(krylovdim=krylovdim, tol=TOL, maxiter=50)
    vj, Xj, ij = kk.geneigsolve((aj, bj), tree.jax(x0), 2, "SR", **kw)
    vt, Xt, it = kt.geneigsolve((at, bt), tree.torch(x0), 2, "SR", **kw)
    close(vt, vj)
    assert counts(it) == counts(ij)
    assert counts(it)[2] >= 2
    X = tree.host(Xt)
    for i in range(2):
        v = X[i]
        assert np.linalg.norm(A @ v - vt[i].item() * (B @ v)) <= 1e-6 * np.linalg.norm(v)


@pytest.mark.parametrize("kind", ["dict", "tuple"])
def test_exponentiate_on_trees_matches_jax(kind):
    n = 30
    rng = np.random.default_rng(203)
    A = hermitize(rand_mat(rng, n, n, np.float64))
    tree = Tree(kind, 11)
    (fj, _), (ft, _) = maps(A, tree, tree)
    x0 = rand_vec(rng, n, np.float64)
    kw = dict(ishermitian=True, tol=TOL, krylovdim=12)
    yj, ij = kk.exponentiate(fj, 0.3, tree.jax(x0), **kw)
    yt, it = kt.exponentiate(ft, 0.3, tree.torch(x0), **kw)
    close(tree.host(yt), tree.host(yj))
    assert counts(it) == counts(ij)
    w, U = np.linalg.eigh(A)
    close(tree.host(yt), U @ (np.exp(0.3 * w) * (U.T @ x0)), atol=1e-8)


@pytest.mark.parametrize("hermitian", [True, False])
def test_expintegrator_with_three_tree_vectors_matches_jax(hermitian):
    """``u₀, u₁, u₂`` as dicts (a Lanczos and an Arnoldi subspace)."""
    n = 30
    rng = np.random.default_rng(204)
    A = rand_mat(rng, n, n, np.float64) / 4
    if hermitian:
        A = hermitize(A)
    tree = Tree("dict", 13)
    (fj, _), (ft, _) = maps(A, tree, tree)
    us = [rand_vec(rng, n, np.float64) for _ in range(3)]
    kw = dict(ishermitian=hermitian, tol=TOL, krylovdim=10)
    yj, ij = kk.expintegrator(fj, 0.5, *(tree.jax(u) for u in us), **kw)
    yt, it = kt.expintegrator(ft, 0.5, *(tree.torch(u) for u in us), **kw)
    close(tree.host(yt), tree.host(yj))
    assert counts(it) == counts(ij)


@pytest.mark.parametrize("kind", ["dict", "tuple"])
def test_block_lanczos_on_a_block_of_trees_matches_jax(kind):
    n = 40
    rng = np.random.default_rng(205)
    A = hermitize(rand_mat(rng, n, n, np.float64))
    tree = Tree(kind, 15)
    (fj, _), (ft, _) = maps(A, tree, tree)
    xs = [rand_vec(rng, n, np.float64) for _ in range(3)]
    kw = dict(tol=TOL, krylovdim=20, maxiter=100)
    vj, Xj, ij = kk.eigsolve(fj, kk.Block([tree.jax(x) for x in xs]), 3, "LR", **kw)
    blk = kt.Block([tree.torch(x) for x in xs])
    assert blk.size == 3 and tree.host(blk[1]).shape == (n,)
    vt, Xt, it = kt.eigsolve(ft, blk, 3, "LR", **kw)
    close(vt, vj)
    assert counts(it) == counts(ij)
    close(vt, np.linalg.eigvalsh(A)[::-1][:3], atol=1e-8)
    X = tree.host(Xt)
    np.testing.assert_allclose(A @ X.T, X.T * vt.numpy(), atol=1e-8)


def test_fused_gates_refuse_a_tree():
    """The fused Lanczos and fused GKL gates take one eligible tensor only."""
    op = kt.StencilOperator((-1, 0, 1), (-1.0, 2.0, -1.0))
    x = torch.ones((32, 128), dtype=torch.float32)
    space = tvec.VectorSpace()
    assert tkf.fused_available(op, x, space, kmax=31)
    assert tgf.fused_kernel_available(op, x, space, 31)
    for tree in ({"a": x[:16], "b": x[16:]}, (x[:16], x[16:])):
        assert not tkf.fused_available(op, tree, space, kmax=31)
        assert not tgf.fused_kernel_available(op, tree, space, 31)
