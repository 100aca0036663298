"""PyTorch port: batched linear solves, ``svdsolve`` and ``lssolve`` on
pytree vectors (the counterpart of ``jax.vmap`` over a JAX driver whose
vectors are pytrees).

A batched argument with ``in_dims`` 0 is a tree whose every leaf carries the
problem axis first; the outputs are trees of the input's structure with
leaves ``(P, ...)``.  GMRES (dict vectors), CG (tuples) and GKL ``svdsolve``
(a dict domain, a tuple codomain) are held against ``jax.jit(jax.vmap(...))``
of the JAX drivers on the same numpy-seeded inputs: values within 1e-8,
``numops``, ``numiter`` and ``converged`` equal, every output's tree
structure and leaf shapes equal.  MINRES, BiCGStab, ``expintegrator`` and
LSMR are held against the port's one-problem tree solves, bit for bit
(``torch.equal`` leaf by leaf); those are held against the JAX package in
``tests/test_torch_pytree*.py``.  Then the refusals: leaves that disagree on
the problem count, a tuple read as a pytree and not as a list of problems;
and pytree vectors on a one-rank sharded space, the unsharded bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krylovkit_tpu import CG as JCG
from krylovkit_tpu import GKL as JGKL
from krylovkit_tpu import GMRES as JGMRES
from krylovkit_tpu.ops import operator as jop
from krylovkit_tpu.solvers.cg import linsolve_cg as j_cg
from krylovkit_tpu.solvers.gmres import linsolve_gmres as j_gmres
from krylovkit_tpu.solvers.svdsolve import svdsolve_gkl as j_svdsolve_gkl
import krylovkit_tpu_torch as kt
from krylovkit_tpu_torch.ops.collectives import MeshAxis
from krylovkit_tpu_torch.ops.operator import as_operator
from krylovkit_tpu_torch.ops.vector import tree_leaves
from krylovkit_tpu_torch.solvers import bicgstab as tbicgstab
from krylovkit_tpu_torch.solvers import expintegrator as te
from krylovkit_tpu_torch.solvers import lssolve as tls
from krylovkit_tpu_torch.solvers import minres as tminres

torch.set_num_threads(2)
P = 3
TOL = 1e-10


def cut(v, kind, at):
    """``v`` cut on its last axis into a dict or a tuple of two leaves."""
    a, b = v[..., :at], v[..., at:]
    return {"a": a, "b": b} if kind == "dict" else (a, b)


def join(t):
    parts = [t["a"], t["b"]] if isinstance(t, dict) else list(t)
    return (jnp.concatenate if isinstance(parts[0], jax.Array) else torch.cat)(parts, -1)


def maps(A, dom, cod):
    """``(f, fadjoint)`` of the matrix ``A`` from ``dom = (kind, at)`` trees
    to ``cod`` trees: the JAX pair and the port's."""

    def pair(M):
        return (lambda x: cut(M @ join(x), *cod), lambda y: cut(M.conj().T @ join(y), *dom))

    return pair(jnp.asarray(A)), pair(torch.from_numpy(A))


def tj(x, kind, at):
    return cut(jnp.asarray(x), kind, at)


def tt(x, kind, at):
    return cut(torch.from_numpy(np.ascontiguousarray(x)), kind, at)


def counts(info):
    return [np.asarray(info.numops).tolist(), np.asarray(info.numiter).tolist(),
            np.asarray(info.converged).tolist()]


def same_tree(t, j, atol=None):
    """Equal tree structure and leaf shapes (and values within ``atol``)."""
    assert jax.tree_util.tree_structure(t) == jax.tree_util.tree_structure(j)
    for a, b in zip(tree_leaves(t), jax.tree_util.tree_leaves(j)):
        assert tuple(a.shape) == tuple(b.shape)
        if atol is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=atol)


def bits(t, u):
    """Bit-identical trees of one structure."""
    assert jax.tree_util.tree_structure(t) == jax.tree_util.tree_structure(u)
    return all(torch.equal(a, b) for a, b in zip(tree_leaves(t), tree_leaves(u)))


def _system(spd, seed=7, n=30):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    A = A @ A.T / n + np.eye(n) if spd else A / np.sqrt(n) + 2 * np.eye(n)
    B = rng.standard_normal((P, n)) * np.arange(1, P + 1)[:, None]
    return A, B


@pytest.mark.parametrize("driver", ["gmres", "cg"])
def test_batched_linsolve_on_trees_matches_jax_vmap(driver):
    """GMRES on dicts, CG on tuples, ``P`` right-hand sides, zero starts."""
    kind = "dict" if driver == "gmres" else "tuple"
    A, B = _system(spd=driver == "cg")
    (fj, _), (ft, _) = maps(A, (kind, 12), (kind, 12))
    if driver == "gmres":
        jalg, talg = JGMRES(krylovdim=8, maxiter=50, tol=TOL), kt.GMRES(krylovdim=8, maxiter=50,
                                                                        tol=TOL)
        jsolve, tsolve = j_gmres, kt.linsolve_gmres_batched
    else:
        jalg, talg = JCG(maxiter=200, tol=TOL), kt.CG(maxiter=200, tol=TOL)
        jsolve, tsolve = j_cg, kt.linsolve_cg_batched
    op = jop.as_operator(fj)
    xj, ij = jax.jit(jax.vmap(lambda b: jsolve(op, b, jax.tree_util.tree_map(jnp.zeros_like, b),
                                               0.5, 1.0, jalg)))(tj(B, kind, 12))
    Bt = tt(B, kind, 12)
    xt, it = tsolve(ft, Bt, jax.tree_util.tree_map(torch.zeros_like, Bt), 0.5, 1.0, talg)
    assert counts(it) == counts(ij) and counts(it)[2] == [1] * P
    same_tree(xt, xj, atol=1e-8)
    same_tree(it.residual, ij.residual)
    # the solves: (0.5 + A) x = b
    np.testing.assert_allclose(join(xt).numpy() @ (A + 0.5 * np.eye(30)).T, B, atol=1e-8)


def test_batched_svdsolve_dict_domain_tuple_codomain_matches_jax_vmap():
    """GKL on a 40 × 30 map from a dict domain (12 + 18) to a tuple
    codomain (17 + 23), ``P`` starts in its range."""
    rng = np.random.default_rng(201)
    A = rng.standard_normal((40, 30))
    fj, ft = maps(A, ("dict", 12), ("tuple", 17))
    X0 = (A @ rng.standard_normal((30, P))).T
    kw = dict(krylovdim=12, tol=TOL, maxiter=100)
    Sj, Uj, Vj, ij = jax.jit(jax.vmap(lambda x: j_svdsolve_gkl(
        jop.as_operator(fj), x, 3, "LR", JGKL(**kw))))(tj(X0, "tuple", 17))
    St, Ut, Vt, it = kt.svdsolve_gkl_batched(ft, tt(X0, "tuple", 17), 3, "LR", kt.GKL(**kw))
    np.testing.assert_allclose(St.numpy(), np.asarray(Sj), rtol=0, atol=1e-8)
    assert counts(it) == counts(ij) and counts(it)[2] == [3] * P
    for t, j in ((Ut, Uj), (Vt, Vj), (it.residual, ij.residual)):
        same_tree(t, j)
    np.testing.assert_allclose(St.numpy(), np.linalg.svd(A, compute_uv=False)[None, :3]
                               .repeat(P, 0), atol=1e-8)
    # the triplets: A v = σ u on the joined vectors
    U, V = join(Ut).numpy(), join(Vt).numpy()
    np.testing.assert_allclose(np.einsum("mn,pkn->pkm", A, V), U * St.numpy()[..., None],
                               atol=1e-8)


def test_batched_minres_bicgstab_on_tuples_are_the_one_problem_solves():
    """Each problem of a tuple batch is its one-problem tuple solve, bit for
    bit: MINRES on a symmetric system, BiCGStab on a nonsymmetric one."""
    for spd, tsolve, tone, alg in (
            (True, kt.linsolve_minres_batched, tminres.linsolve_minres,
             kt.MINRES(tol=TOL, maxiter=200)),
            (False, kt.linsolve_bicgstab_batched, tbicgstab.linsolve_bicgstab,
             kt.BiCGStab(tol=TOL, maxiter=200))):
        A, B = _system(spd, seed=8)
        _, (ft, _) = maps(A, ("tuple", 12), ("tuple", 12))
        Bt = tt(B, "tuple", 12)
        X0 = jax.tree_util.tree_map(torch.zeros_like, Bt)
        x, info = tsolve(ft, Bt, X0, 0.5, 1.0, alg)
        for p in range(P):
            x1, i1 = tone(as_operator(ft), tuple(l[p] for l in Bt), tuple(l[p] for l in X0), 0.5,
                          1.0, alg)
            assert bits(tuple(l[p] for l in x), x1)
            assert bits(tuple(l[p] for l in info.residual), i1.residual)
            assert [c[p] for c in counts(info)] == [i1.numops, i1.numiter, i1.converged]


def test_batched_expintegrator_on_three_dicts_is_the_one_problem_integration():
    """``u₀, u₁, u₂`` as dict batches, ``t`` per problem: each problem is
    the one-problem integration of its dicts, bit for bit."""
    rng = np.random.default_rng(204)
    A = rng.standard_normal((30, 30)) / 4
    A = (A + A.T) / 2
    _, (ft, _) = maps(A, ("dict", 13), ("dict", 13))
    us = [tt(rng.standard_normal((P, 30)), "dict", 13) for _ in range(3)]
    alg = kt.Lanczos(krylovdim=10, tol=TOL)
    ts = [0.5, 1.0, 1.5]
    y, info = kt.expintegrator_batched(ft, ts, tuple(us), alg, in_dims=(None, 0, 0))
    for p in range(P):
        up = tuple({k: u[k][p] for k in u} for u in us)
        y1, i1 = te._expintegrator_core(as_operator(ft), ts[p], up, alg, kt.STANDARD)
        assert bits({k: y[k][p] for k in y}, y1)
        assert [c[p] for c in counts(info)] == [i1.numops, i1.numiter, i1.converged]


def test_batched_lssolve_dict_codomain_tuple_domain_is_the_one_problem_solve():
    """LSMR from a tuple domain (9 + 21) to a dict codomain (25 + 15): each
    problem's ``x`` (a tuple) and counts are its one-problem solve's."""
    rng = np.random.default_rng(202)
    A = rng.standard_normal((40, 30))
    _, ft = maps(A, ("tuple", 9), ("dict", 25))
    Bt = tt(rng.standard_normal((P, 40)), "dict", 25)
    alg = kt.LSMR(tol=TOL, maxiter=400)
    x, info = kt.lssolve_lsmr_batched(ft, Bt, alg, 0.5)
    assert isinstance(x, tuple) and tuple(x[1].shape) == (P, 21)
    for p in range(P):
        x1, i1 = tls.lssolve_lsmr(as_operator(ft), {k: Bt[k][p] for k in Bt}, alg, 0.5)
        assert bits(tuple(l[p] for l in x), x1)
        assert [c[p] for c in counts(info)] == [i1.numops, i1.numiter, i1.converged]


def test_batched_tree_refusals():
    """Leaves that disagree on the problem count raise a ``ValueError``
    (``jax.vmap`` refuses inconsistent sizes); a tuple vector is a pytree,
    its leaves' leading axis the problem count, never a list of problems;
    pytree vectors run on a sharded space: on a one-rank axis, the
    unsharded bits."""
    A, B = _system(spd=True)
    _, (ft, fta) = maps(A, ("tuple", 12), ("tuple", 12))
    Bt = tt(B, "tuple", 12)
    bad = (Bt[0], Bt[1][:2])
    with pytest.raises(ValueError, match="disagree on the problem count"):
        kt.linsolve_cg_batched(ft, bad, bad, 0.0, 1.0, kt.CG())
    # two leaves, three problems: a list reading would give two
    x, info = kt.linsolve_cg_batched(ft, Bt, jax.tree_util.tree_map(torch.zeros_like, Bt), 0.0,
                                     1.0, kt.CG(tol=TOL, maxiter=200))
    assert tuple(info.numops.shape) == (P,) and [tuple(l.shape) for l in x] == [(P, 12), (P, 18)]
    with pytest.raises(ValueError, match="problem count"):
        kt.linsolve_cg_batched([as_operator(ft)] * 2, Bt, Bt, 0.0, 1.0, kt.CG(),
                               in_dims=(0, 0, 0))
    one = kt.VectorSpace(psum_axis=MeshAxis("vec", None, 1, 0))
    for call in (lambda s: kt.linsolve_cg_batched(ft, Bt, Bt, 0.0, 1.0, kt.CG(), s),
                 lambda s: kt.lssolve_lsmr_batched((ft, fta), Bt, kt.LSMR(), space=s)):
        (got, gi), (want, wi) = call(one), call(kt.STANDARD)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert torch.equal(gi.numops, wi.numops)
