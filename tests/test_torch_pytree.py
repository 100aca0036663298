"""PyTorch port: pytree vectors (tuples, lists and dicts of tensors) against
the JAX package, mirroring the pytree cases of ``tests/test_vector_ops.py``,
``tests/test_issues.py`` and ``tests/test_sparse_and_spaces.py``, plus the
drivers the pullbacks run on tuples (GMRES, Arnoldi) and the kernels'
per-leaf gates.

The same numpy-seeded inputs go through the JAX package (CPU) and the port
(CPU tensors, the kernels' plain versions).  Values agree within 1e-8
(float64 solves; 1e-12 for the vector operations) and ``numops``,
``numiter`` and ``converged`` are equal.  The gate tests count the calls of
the kernel wrappers (their plain versions here) with a counter.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import krylovkit_tpu as kk
from krylovkit_tpu.ops import operator as jop
from krylovkit_tpu.ops import vector as jvec
import krylovkit_tpu_torch as kt
from krylovkit_tpu_torch import convert
from krylovkit_tpu_torch.factorizations import krylov as tkf
from krylovkit_tpu_torch.ops import basis as tbs
from krylovkit_tpu_torch.ops import operator as top_
from krylovkit_tpu_torch.ops import vector as tvec
from testsetup import DTYPES, precision, rand_mat, rand_vec

torch.set_num_threads(2)


def T(x):
    return torch.from_numpy(np.array(x))


def counts(info):
    return int(info.numops), int(info.numiter), int(info.converged)


def leaves(tree):
    return [np.asarray(l) for l in jax.tree_util.tree_leaves(tree)]


def assert_tree_close(tt, tj, atol):
    lt, lj = tvec.tree_leaves(tt), leaves(tj)
    assert len(lt) == len(lj)
    for a, b in zip(lt, lj):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.detach().numpy(), b, atol=atol)


def _split(x, kind):
    """The vector ``x`` as a dict, a tuple or a nested tuple of pieces."""
    if kind == "dict":
        return {"a": x[:8], "b": x[8:]}
    if kind == "tuple":
        return (x[:5], x[5:12], x[12:])
    return (x[:4], (x[4:9], {"c": x[9:]}))


# ---------------------------------------------------------------- vector ops

@pytest.mark.parametrize("kind", ["dict", "tuple", "nested"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_inner_norm_match_jax(dtype, kind):
    rng = np.random.default_rng(0)
    x, y = rand_vec(rng, 20, dtype), rand_vec(rng, 20, dtype)
    jx, jy = _split(jnp.asarray(x), kind), _split(jnp.asarray(y), kind)
    tx, ty = convert.tree_from_numpy(_split(x, kind), "cpu"), convert.tree_from_numpy(
        _split(y, kind), "cpu")
    tol = precision(dtype)
    np.testing.assert_allclose(tvec.inner(tx, ty).numpy(), np.asarray(jvec.inner(jx, jy)),
                               atol=tol)
    np.testing.assert_allclose(tvec.norm(tx).numpy(), np.asarray(jvec.norm(jx)), atol=tol)
    np.testing.assert_allclose(tvec.inner(tx, ty).numpy(), np.vdot(x, y), atol=tol)
    np.testing.assert_allclose(tvec.REAL.inner(tx, ty).numpy(),
                               np.asarray(jvec.REAL.inner(jx, jy)), atol=tol)


@pytest.mark.parametrize("kind", ["dict", "tuple", "nested"])
def test_add_scale_zerovector_scalartype_match_jax(kind):
    rng = np.random.default_rng(1)
    x, y = rand_vec(rng, 20, np.float64), rand_vec(rng, 20, np.float64)
    jx, jy = _split(jnp.asarray(x), kind), _split(jnp.asarray(y), kind)
    tx, ty = convert.tree_from_numpy(_split(x, kind), "cpu"), convert.tree_from_numpy(
        _split(y, kind), "cpu")
    assert_tree_close(tvec.add(ty, tx, a=2.0, b=-1.0), jvec.add(jy, jx, a=2.0, b=-1.0), 1e-15)
    assert_tree_close(tvec.scale(tx, 3.0), jvec.scale(jx, 3.0), 1e-15)
    assert_tree_close(tvec.zerovector(tx), jvec.zerovector(jx), 0)
    mixed = (tvec.tree_leaves(tx)[0].to(torch.float32), T(np.ones(3, np.complex64)))
    assert tvec.scalartype(mixed) == torch.complex64
    assert tvec.scalartype(tx, mixed) == torch.complex128
    assert tvec.real_scalartype(torch.complex128) == torch.float64
    flat = np.arange(20.0)
    assert_tree_close(tvec.from_template(tx, T(flat)), jvec.from_template(jx, jnp.asarray(flat)),
                      0)
    gen = torch.Generator().manual_seed(0)
    r = tvec.randn_like(gen, tx, dtype=torch.complex128)
    assert [tuple(l.shape) for l in tvec.tree_leaves(r)] == [l.shape for l in leaves(jx)]
    assert all(l.dtype == torch.complex128 for l in tvec.tree_leaves(r))
    gen.manual_seed(0)
    assert all(torch.equal(a, b) for a, b in zip(
        tvec.tree_leaves(r), tvec.tree_leaves(tvec.randn_like(gen, tx, dtype=torch.complex128))))


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_auto_adjoint_with_adjoint_from(dtype):
    """``with_adjoint_from`` on a complex matrix: torch's vector-Jacobian
    product is ``Aᴴ y`` with no conjugation around it (the JAX package
    conjugates its linear transpose)."""
    rng = np.random.default_rng(4)
    A = rand_mat(rng, 6, 6, dtype)
    y = rand_vec(rng, 6, dtype)
    Aj, At = jnp.asarray(A), T(A)
    Oj = jop.as_operator(lambda x: Aj @ x).with_adjoint_from(jnp.zeros(6, dtype=dtype))
    Ot = kt.as_operator(lambda x: At @ x).with_adjoint_from(torch.zeros(6, dtype=At.dtype))
    got = Ot.apply_adjoint(T(y)).numpy()
    np.testing.assert_allclose(got, np.asarray(Oj.apply_adjoint(jnp.asarray(y))), atol=1e-14)
    np.testing.assert_allclose(got, A.conj().T @ y, atol=1e-14)
    # on a tuple vector: the embedding [0 A; Aᴴ 0] is its own adjoint
    f = lambda xy: (At @ xy[1], At.conj().T @ xy[0])  # noqa: E731
    O2 = kt.as_operator(f).with_adjoint_from((torch.zeros(6, dtype=At.dtype),) * 2)
    u, v = T(y), T(rand_vec(rng, 6, dtype))
    for a, b in zip(O2.apply_adjoint((u, v)), f((u, v))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-14)
    # ParametricOperator keeps its params explicit
    P = kt.ParametricOperator(lambda M, x: M @ x, At).with_adjoint_from(torch.zeros(6, dtype=At.dtype))
    assert P.params is At and P.tensors() == (At,)
    np.testing.assert_allclose(P.apply_adjoint(T(y)).numpy(), got, atol=1e-14)


def test_probe_dtype_on_pytrees():
    calls = []

    def f(x):
        calls.append(1)
        return {"a": x["a"] * 1.0, "b": x["b"] * 1j}

    x0 = {"a": torch.zeros(4, dtype=torch.float32), "b": torch.zeros(2, dtype=torch.float32)}
    assert top_.probe_dtype(kt.as_operator(f), x0) == torch.complex64
    typed = top_.TypedOperator(lambda x: x, None, dtype=torch.complex128)
    assert top_.probe_dtype(typed, x0) == torch.complex128


# ---------------------------------------------------------------- solves

@functools.lru_cache(maxsize=None)
def _jax_issue_100():
    N = 32
    rng = np.random.default_rng(100)
    A = rng.standard_normal((N, N))
    A = A + A.T
    h = N // 2
    a, b = rng.standard_normal(h), rng.standard_normal(h)

    def f(v):
        y = jnp.asarray(A) @ jnp.concatenate([v["a"], v["b"]])
        return {"a": y[:h], "b": y[h:]}

    vals, vecs, info = kk.eigsolve(f, {"a": jnp.asarray(a), "b": jnp.asarray(b)}, 4, "LM",
                                   ishermitian=True, krylovdim=12, maxiter=100, tol=1e-12)
    return (A, a, b), (np.asarray(vals), vecs, counts(info))


def test_issue_100_vector_of_vectors_with_shrinking():
    """Reference test/issues.jl:1-19: a two-leaf dict vector through a Lanczos
    solve that restarts, against the JAX package."""
    (A, a, b), (vj, vecsj, cj) = _jax_issue_100()
    h = len(a)
    At = T(A)

    def f(v):
        y = At @ torch.cat([v["a"], v["b"]])
        return {"a": y[:h], "b": y[h:]}

    vals, vecs, info = kt.eigsolve(f, {"a": T(a), "b": T(b)}, 4, "LM", ishermitian=True,
                                   krylovdim=12, maxiter=100, tol=1e-12)
    assert counts(info) == cj and cj[1] > 1 and info.converged >= 4
    np.testing.assert_allclose(vals.numpy(), vj, atol=1e-8)
    assert set(vecs) == {"a", "b"} and vecs["a"].shape == (4, h)
    for i in range(4):
        ft = torch.cat([vecs["a"][i], vecs["b"][i]]).numpy()
        fj = np.concatenate([np.asarray(vecsj["a"][i]), np.asarray(vecsj["b"][i])])
        assert abs(abs(np.vdot(ft, fj)) - 1) < 1e-8
    assert set(info.residual) == {"a", "b"}


@functools.lru_cache(maxsize=None)
def _jax_tuple_embedding():
    rng = np.random.default_rng(106)
    A = rand_mat(rng, 25, 15, np.float64)
    Aj = jnp.asarray(A)
    x0 = (rand_vec(rng, 25, np.float64), rand_vec(rng, 15, np.float64))
    vals, vecs, info = kk.eigsolve(lambda xy: (Aj @ xy[1], Aj.T @ xy[0]),
                                   tuple(map(jnp.asarray, x0)), 3, "LR", ishermitian=True,
                                   tol=1e-10, krylovdim=30, maxiter=60)
    return (A, x0), (np.asarray(vals), counts(info))


def test_nested_tuple_svd_embedding():
    """Reference test/nestedtuple.jl: the Hermitian embedding [0 A; Aᴴ 0] on
    an ``(x, y)`` tuple has eigenvalues ±σ(A)."""
    (A, x0), (vj, cj) = _jax_tuple_embedding()
    At = T(A)
    vals, vecs, info = kt.eigsolve(lambda xy: (At @ xy[1], At.T @ xy[0]), tuple(map(T, x0)), 3,
                                   "LR", ishermitian=True, tol=1e-10, krylovdim=30, maxiter=60)
    assert counts(info) == cj and info.converged >= 3
    np.testing.assert_allclose(vals.numpy(), vj, atol=1e-8)
    np.testing.assert_allclose(vals.numpy(), np.linalg.svd(A, compute_uv=False)[:3], atol=1e-8)
    assert isinstance(vecs, tuple) and vecs[0].shape == (3, 25) and vecs[1].shape == (3, 15)


def test_nested_tuple_svd_embedding_gradient():
    """The embedding as a ParametricOperator of ``A``: the gradient of the
    top two values through the bordered pullback on ``((x, y), δ)`` pytrees
    equals the JAX package's (conjugated) and the SVD oracle's."""
    (A, x0), _ = _jax_tuple_embedding()

    def jloss(M):
        op = jop.ParametricOperator(lambda M, xy: (M @ xy[1], M.T @ xy[0]), M)
        vals, _, _ = kk.eigsolve(op, tuple(map(jnp.asarray, x0)), 2, "LR", ishermitian=True,
                                 tol=1e-12, krylovdim=30, maxiter=60)
        return jnp.sum(vals)

    gj = np.asarray(jax.grad(jloss)(jnp.asarray(A)))
    At = T(A).requires_grad_(True)
    op = kt.ParametricOperator(lambda M, xy: (M @ xy[1], M.T @ xy[0]), At)
    vals, _, _ = kt.eigsolve(op, tuple(map(T, x0)), 2, "LR", ishermitian=True, tol=1e-12,
                             krylovdim=30, maxiter=60)
    vals.sum().backward()
    np.testing.assert_allclose(At.grad.numpy(), gj, atol=1e-8)
    Ad = T(A).requires_grad_(True)
    torch.linalg.svdvals(Ad)[:2].sum().backward()
    np.testing.assert_allclose(At.grad.numpy(), Ad.grad.numpy(), atol=1e-7)


def _tuple_system(dtype, spd=False):
    rng = np.random.default_rng(7)
    m = 30
    A = rand_mat(rng, m, m, dtype)
    A = A @ A.conj().T + np.eye(m, dtype=dtype) if spd else A + 3 * np.eye(m, dtype=dtype)
    b = rand_vec(rng, m, dtype)
    return A, (b[:12], b[12:])


def _split_op(A, lib):
    """``A`` acting on ``(b[:12], b[12:])`` tuples, in JAX or torch."""
    cat = jnp.concatenate if lib is jnp else torch.cat
    M = jnp.asarray(A) if lib is jnp else T(A)
    return lambda v: (lambda y: (y[:12], y[12:]))(M @ cat([v[0], v[1]]))


@pytest.mark.parametrize("alg, dtype", [
    ("GMRES", np.float64), ("GMRES", np.complex128), ("CG", np.float64),
    ("MINRES", np.float64), ("BiCGStab", np.float64), ("BiCGStab", np.complex128),
])
def test_linsolve_on_tuples_matches_jax(alg, dtype):
    """Every linear solver takes ``(vector, vector)`` tuples (GMRES is the
    bordered pullbacks' solver), with JAX's values and counts."""
    A, b = _tuple_system(dtype, spd=alg in ("CG", "MINRES"))
    kw = dict(GMRES=dict(krylovdim=8, maxiter=50), CG=dict(maxiter=200),
              MINRES=dict(maxiter=200), BiCGStab=dict(maxiter=200))[alg]
    xj, ij = kk.linsolve(_split_op(A, jnp), tuple(map(jnp.asarray, b)),
                         alg=getattr(kk, alg)(tol=1e-10, **kw))
    xt, it = kt.linsolve(_split_op(A, torch), tuple(map(T, b)),
                         alg=getattr(kt, alg)(tol=1e-10, **kw))
    assert counts(it) == counts(ij) and it.converged == 1
    assert_tree_close(xt, xj, 1e-8)
    assert isinstance(it.residual, tuple)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_arnoldi_on_tuples_matches_jax(dtype):
    """Non-Hermitian eigsolve (real and complex Arnoldi) on an ``(x, y)``
    tuple: the Sylvester pullbacks' solver."""
    rng = np.random.default_rng(8)
    m = 40
    A = rand_mat(rng, m, m, dtype) + np.diag(np.linspace(1, 3, m)).astype(dtype)
    x0 = rand_vec(rng, m, dtype)
    vj, Vj, ij = kk.eigsolve(_split_op(A, jnp), (jnp.asarray(x0[:12]), jnp.asarray(x0[12:])),
                             3, "LR", krylovdim=20, maxiter=50, tol=1e-10)
    vt, Vt, it = kt.eigsolve(_split_op(A, torch), (T(x0[:12]), T(x0[12:])), 3, "LR",
                             krylovdim=20, maxiter=50, tol=1e-10)
    assert counts(it) == counts(ij) and it.converged >= 3
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-8)
    for i in range(3):
        ft = torch.cat([Vt[0][i], Vt[1][i]]).numpy()
        fj = np.concatenate([np.asarray(Vj[0][i]), np.asarray(Vj[1][i])])
        assert abs(abs(np.vdot(ft, fj)) - 1) < 1e-8


# ---------------------------------------------------------------- kernel gates

@pytest.fixture
def count_calls(monkeypatch):
    """Counts the calls of a kernel wrapper looked up through ``module``."""
    seen = {}

    def install(module, name):
        real = getattr(module, name)

        def counted(*args, **kw):
            seen[name] = seen.get(name, 0) + 1
            return real(*args, **kw)

        monkeypatch.setattr(module, name, counted)
        return seen

    return install


def test_transform_partial_routes_per_leaf(count_calls):
    """K2 is decided leaf by leaf: a ``((kmax, R, 128) f32, (kmax, n) f32)``
    basis runs the kernel (its plain version here) once, for the first leaf,
    and the plain product on the second; both agree with ``transform``."""
    seen = count_calls(tbs, "transform_partial_inplace")
    gen = torch.Generator().manual_seed(0)
    kmax, m_out = 9, 5
    V = (torch.randn((kmax, 16, 128), generator=gen), torch.randn((kmax, 40), generator=gen))
    U = torch.randn((kmax, kmax), generator=gen, dtype=torch.float64)
    want = tbs.transform(V, U)
    out = tbs.transform_partial((V[0].clone(), V[1].clone()), U, m_out)
    assert seen == {"transform_partial_inplace": 1}
    for a, b in zip(out, want):
        torch.testing.assert_close(a[:m_out], b[:m_out], rtol=1e-5, atol=1e-5)
    # the kernel keeps its leaf's tail rows, the plain product rotates them
    assert torch.equal(out[0][m_out:], V[0][m_out:])
    torch.testing.assert_close(out[1], want[1])


def test_projection_kernels_and_fused_step_refuse_pytrees(count_calls, monkeypatch):
    """K5/K6 take a single-leaf basis only (JAX ``_pallas_proj_leaf``) and
    the fused expansion (K1) one tensor only: a tuple sweep with the
    projection flag on runs neither, and a single leaf still does."""
    from krylovkit_tpu_torch.ops import projections as pb

    seen = count_calls(pb, "project_pallas")
    count_calls(pb, "unproject_pallas")
    monkeypatch.setattr(tbs, "use_pallas_projections", True)
    gen = torch.Generator().manual_seed(1)
    V = (torch.randn((9, 16, 128), generator=gen), torch.randn((9, 1), generator=gen))
    w = (torch.randn((16, 128), generator=gen), torch.randn((1,), generator=gen))
    from krylovkit_tpu_torch.ops import orthonormal as on

    on.orthogonalize(w, V, 5, on.cgs2)
    assert seen == {}
    on.orthogonalize(w[0], V[0], 5, on.cgs2)
    assert seen == {"project_pallas": 2, "unproject_pallas": 2}
    grid = kt.poisson_2d(16, 128, device="cpu")
    assert tkf.fused_available(grid, w[0], tvec.STANDARD)
    assert not tkf.fused_available(grid, (w[0],), tvec.STANDARD)


# ---------------------------------------------------------------- autograd guards

def _wrapper_calls():
    """Each kernel wrapper called on CPU tensors: ``(name, fn(x))`` where
    ``x`` is the tensor the guard must look at."""
    from krylovkit_tpu_torch.ops import banded as bd
    from krylovkit_tpu_torch.ops import fused_lanczos as fl
    from krylovkit_tpu_torch.ops import projections as pb
    from krylovkit_tpu_torch.ops import stencil_1d as s1

    V = torch.randn((9, 16, 128))
    U = torch.eye(9)
    D = torch.randn((3, 16, 128))
    spec = fl.spec_for(kt.laplacian_1d(2048, device="cpu"))
    return [
        ("banded_spmv", lambda x: bd.banded_spmv(x, D, (-1, 0, 1), 2048), torch.randn((16, 128))),
        ("laplacian_1d", s1.laplacian_1d_flat, torch.randn((16, 128))),
        ("transform_partial", lambda v: tbs.transform_partial_inplace(v, U, 4), V.clone()),
        ("project", lambda x: pb.project_pallas(V, x, 4), torch.randn((16, 128))),
        ("unproject", lambda c: pb.unproject_pallas(V, c, 4), torch.randn(9)),
        ("fused_step", lambda y: fl.fused_step(V.clone(), y, torch.randn(10), 4, 4, spec,
                                               with_drift=True), torch.randn((16, 128))),
    ]


@pytest.mark.parametrize("case", range(6))
def test_kernel_wrappers_refuse_autograd_inputs(case):
    """A kernel's launch records no graph: every wrapper refuses a tensor
    that requires grad or that torch.func has wrapped, on every device."""
    name, fn, x = _wrapper_calls()[case]
    fn(x)  # a plain tensor is served
    with pytest.raises(RuntimeError, match=f"{name}: the kernel is not differentiable"):
        fn(x.clone().requires_grad_(True))
    with pytest.raises(RuntimeError, match=f"{name}: the kernel is not differentiable"):
        torch.func.vjp(fn, x.clone())


def test_banded_operator_gradient_through_plain_version():
    """A BandedOperator's planes get their gradient through the plain apply
    (``with_tensors(..., plain=True)``), while the solve runs the kernel
    wrapper; the gradient of a linear solve equals the dense oracle's."""
    rng = np.random.default_rng(9)
    n = 256
    A = np.diag(np.full(n, 4.0)) + np.diag(rng.standard_normal(n - 1), 1) + np.diag(
        rng.standard_normal(n - 1), -1)
    band = kt.banded_from_dense(A, device="cpu")
    D = band.diags.clone().requires_grad_(True)
    op = band.with_tensors([D, band.adj.diags])
    b = T(rng.standard_normal(n))
    x, _ = kt.linsolve(op, b, alg=kt.GMRES(tol=1e-12, krylovdim=40))
    x.sum().backward()
    Ad = T(A).requires_grad_(True)
    torch.linalg.solve(Ad, b).sum().backward()
    gd = Ad.grad.numpy()
    want = np.zeros_like(D.detach().numpy()).reshape(len(band.offsets), -1)
    for p, d in enumerate(band.offsets):
        i = np.arange(max(0, -d), min(n, n - d))
        want[p, i] = gd[i, i + d]
    np.testing.assert_allclose(D.grad.reshape(len(band.offsets), -1).numpy()[:, :n],
                               want[:, :n], atol=1e-10)


# ---------------------------------------------------------------- no rule, no pytree

def _no_rule_calls():
    A = np.diag(np.arange(1.0, 21.0)) + 0.01
    x0 = np.ones(20)
    return {
        "schursolve": lambda At, x: kt.schursolve(At, x, 2),
        "realeigsolve": lambda At, x: kt.realeigsolve(At, x, 2),
        "geneigsolve": lambda At, x: kt.geneigsolve((At, None), x, 2),
        "lssolve": lambda At, x: kt.lssolve(At, x),
        "exponentiate": lambda At, x: kt.exponentiate(At, 0.1, x),
        "expintegrator": lambda At, x: kt.expintegrator(At, 0.1, (x, x)),
        "Block Lanczos": lambda At, x: kt.eigsolve(At, kt.Block([x, x.flip(0)]), 2),
    }, A, x0


@pytest.mark.parametrize("front_end", ["schursolve", "realeigsolve", "geneigsolve", "lssolve",
                                       "exponentiate", "expintegrator", "Block Lanczos"])
def test_front_ends_without_a_rule_refuse_grad(front_end):
    """No gradient where the JAX package has no rule: an input that requires
    grad raises instead of building an unrolled graph; without grad, or
    under torch.no_grad(), the solve runs."""
    calls, A, x0 = _no_rule_calls()
    fn = calls[front_end]
    fn(T(A), T(x0))
    with pytest.raises(NotImplementedError, match="no differentiation rule"):
        fn(T(A).requires_grad_(True), T(x0))
    with pytest.raises(NotImplementedError, match="no differentiation rule"):
        fn(T(A), T(x0).requires_grad_(True))
    with torch.no_grad():
        fn(T(A).requires_grad_(True), T(x0))

