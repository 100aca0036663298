"""PyTorch port: reverse-mode AD of ``linsolve``, ``eigsolve`` and
``svdsolve`` (``krylovkit_tpu_torch/ad``) against the JAX package's custom
VJPs, mirroring ``tests/test_ad.py`` test for test with the same
parametrisation.

The same numpy-seeded inputs go through ``jax.grad`` on ``krylovkit_tpu``
and ``torch.autograd`` on the port.  torch's gradient of a real loss is the
conjugate of ``jax.grad``'s (conjugate-Wirtinger convention), so each port
gradient is held against ``conj(jax.grad)``: within 1e-8 of the largest
entry (float64 and complex128; both packages run the same formulas, their
sums in other orders).  Each test also holds the port against the dense
oracle or the finite differences of the JAX test, with its tolerance, and
checks that the differentiated solve's counts are the plain solve's.  The
JAX gradients are computed once, in this module.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import krylovkit_tpu as kk
import krylovkit_tpu_torch as kt
from testsetup import hermitize, n, rand_mat, rand_vec

torch.set_num_threads(2)

GRAD_TOL = 1e-8


def T(x):
    return torch.from_numpy(np.array(x))


def P(x):
    """A leaf tensor that requires grad."""
    return T(x).requires_grad_(True)


def counts(info):
    return int(info.numops), int(info.numiter), int(info.converged)


def assert_conj_close(gt, gj, tol=GRAD_TOL):
    """Port gradient ``gt`` (torch) within ``tol`` of ``conj(gj)`` (JAX),
    relative to the largest entry (at least 1)."""
    gj = np.conj(np.asarray(gj))
    gt = gt.detach().numpy()
    scale = max(1.0, float(np.max(np.abs(gj))))
    err = float(np.max(np.abs(gt - gj)))
    assert err <= tol * scale, (err, scale)


# ---------------------------------------------------------------- linsolve

@functools.lru_cache(maxsize=None)
def _jax_linsolve(dtype):
    rng = np.random.default_rng(71)
    A = rand_mat(rng, n, n, dtype) + 2 * np.eye(n, dtype=dtype)
    b = rand_vec(rng, n, dtype)
    c = rand_vec(rng, n, dtype)

    def loss(A, b, a0, a1):
        x, _ = kk.linsolve(A, b, a0=a0, a1=a1, tol=1e-12, krylovdim=n)
        return jnp.real(jnp.vdot(c, x))

    dt = jnp.asarray(A).dtype
    args = (jnp.asarray(A), jnp.asarray(b), jnp.asarray(0.4, dt), jnp.asarray(1.3, dt))
    return (A, b, c), [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2, 3))(*args)]


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_ad_linsolve_matches_dense(dtype):
    (A, b, c), gj = _jax_linsolve(dtype)
    At, bt = P(A), P(b)
    a0, a1 = P(np.asarray(0.4, dtype)), P(np.asarray(1.3, dtype))
    x, info = kt.linsolve(At, bt, a0=a0, a1=a1, tol=1e-12, krylovdim=n)
    torch.real(torch.vdot(T(c), x)).backward()
    gt = (At.grad, bt.grad, a0.grad, a1.grad)
    for g_t, g_j in zip(gt, gj):
        assert_conj_close(g_t, g_j)
    # the dense oracle (torch.linalg.solve under autograd), and the counts
    Ad, bd = P(A), P(b)
    a0d, a1d = P(np.asarray(0.4, dtype)), P(np.asarray(1.3, dtype))
    xd = torch.linalg.solve(a0d * torch.eye(n, dtype=Ad.dtype) + a1d * Ad, bd)
    torch.real(torch.vdot(T(c), xd)).backward()
    for g_t, g_d in zip(gt, (Ad.grad, bd.grad, a0d.grad, a1d.grad)):
        np.testing.assert_allclose(g_t.numpy(), g_d.numpy(), atol=1e-8)
    x2, info2 = kt.linsolve(T(A), T(b), a0=0.4, a1=1.3, tol=1e-12, krylovdim=n)
    assert counts(info) == counts(info2)
    assert torch.equal(x.detach(), x2)


@functools.lru_cache(maxsize=None)
def _jax_cg():
    rng = np.random.default_rng(72)
    B = rand_mat(rng, n, n, np.float64)
    A = B @ B.T + 2 * np.eye(n)
    b = rand_vec(rng, n, np.float64)
    c = rand_vec(rng, n, np.float64)

    def loss(A, b):
        x, _ = kk.linsolve(A, b, alg=kk.CG(tol=1e-12, maxiter=200))
        return jnp.vdot(c, x)

    return (A, b, c), jax.grad(loss, argnums=(0, 1))(jnp.asarray(A), jnp.asarray(b))


def test_ad_linsolve_cg_hermitian():
    (A, b, c), (gA, gb) = _jax_cg()
    At, bt = P(A), P(b)
    x, info = kt.linsolve(At, bt, alg=kt.CG(tol=1e-12, maxiter=200))
    torch.vdot(T(c), x).backward()
    assert_conj_close(At.grad, gA)
    assert_conj_close(bt.grad, gb)
    Ad, bd = P(A), P(b)
    torch.vdot(T(c), torch.linalg.solve(Ad, bd)).backward()
    np.testing.assert_allclose(At.grad.numpy(), Ad.grad.numpy(), atol=1e-8)
    np.testing.assert_allclose(bt.grad.numpy(), bd.grad.numpy(), atol=1e-8)
    _, info2 = kt.linsolve(T(A), T(b), alg=kt.CG(tol=1e-12, maxiter=200))
    assert counts(info) == counts(info2)


# ---------------------------------------------------------------- eigsolve

@functools.lru_cache(maxsize=None)
def _jax_herm_values(dtype):
    rng = np.random.default_rng(73)
    A = hermitize(rand_mat(rng, n, n, dtype))
    x0 = rand_vec(rng, n, dtype)
    wts = jnp.asarray([1.0, 0.5])

    def loss(A):
        vals, _, _ = kk.eigsolve(A, jnp.asarray(x0), 2, "SR", ishermitian=True, tol=1e-12,
                                 krylovdim=n)
        return jnp.sum(wts * vals)

    return (A, x0), np.asarray(jax.grad(loss)(jnp.asarray(A)))


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_ad_eigsolve_hermitian_values(dtype):
    (A, x0), gj = _jax_herm_values(dtype)
    wts = torch.tensor([1.0, 0.5], dtype=torch.float64)
    At = P(A)
    vals, _, info = kt.eigsolve(At, T(x0), 2, "SR", ishermitian=True, tol=1e-12, krylovdim=n)
    torch.sum(wts * vals).backward()
    assert_conj_close(At.grad, gj)
    Ad = P(A)
    torch.sum(wts * torch.linalg.eigvalsh(Ad)[:2]).backward()
    np.testing.assert_allclose(At.grad.numpy(), Ad.grad.numpy(), atol=1e-7)
    vals2, _, info2 = kt.eigsolve(T(A), T(x0), 2, "SR", ishermitian=True, tol=1e-12,
                                  krylovdim=n)
    assert counts(info) == counts(info2) and torch.equal(vals.detach(), vals2)


def _top_vector_loss(c):
    return lambda vecs: torch.abs(torch.vdot(T(c), vecs[0])) ** 2


@functools.lru_cache(maxsize=None)
def _jax_herm_vectors():
    rng = np.random.default_rng(74)
    A = hermitize(rand_mat(rng, n, n, np.float64))
    x0 = rand_vec(rng, n, np.float64)
    c = rand_vec(rng, n, np.float64)

    def loss(A):
        _, vecs, _ = kk.eigsolve(A, jnp.asarray(x0), 1, "LR", ishermitian=True, tol=1e-12,
                                 krylovdim=n)
        return jnp.abs(jnp.vdot(c, vecs[0])) ** 2

    return (A, x0, c), np.asarray(jax.grad(loss)(jnp.asarray(A)))


def test_ad_eigsolve_hermitian_vectors():
    (A, x0, c), gj = _jax_herm_vectors()
    At = P(A)
    _, vecs, _ = kt.eigsolve(At, T(x0), 1, "LR", ishermitian=True, tol=1e-12, krylovdim=n)
    _top_vector_loss(c)(vecs).backward()
    assert_conj_close(At.grad, gj)
    # the oracle: the gradient is defined up to symmetrization
    Ad = P(A)
    _top_vector_loss(c)(torch.linalg.eigh(Ad)[1][:, -1:].T).backward()
    g, gd = At.grad.numpy(), Ad.grad.numpy()
    np.testing.assert_allclose(g + g.T, gd + gd.T, atol=1e-6)


def _fd_check(loss, A, g, seed, count, eps=1e-6, tol=1e-5):
    """Central differences of ``loss`` at ``count`` entries drawn from
    ``default_rng(seed)`` within ``tol`` of the gradient ``g``."""
    rng = np.random.default_rng(seed)
    m = A.shape[0]
    for _ in range(count):
        i, j = rng.integers(0, m, 2)
        Ap, Am = A.copy(), A.copy()
        Ap[i, j] += eps
        Am[i, j] -= eps
        fd = (loss(Ap) - loss(Am)) / (2 * eps)
        assert abs(g[i, j] - fd) < tol, (i, j, g[i, j], fd)


@functools.lru_cache(maxsize=None)
def _jax_general_values():
    rng = np.random.default_rng(75)
    A = rand_mat(rng, n, n, np.float64) + np.diag(np.linspace(1, 2, n))
    x0 = rand_vec(rng, n, np.float64)

    def loss(A):
        vals, _, _ = kk.eigsolve(A, jnp.asarray(x0), 1, "LR", tol=1e-12, krylovdim=n)
        return jnp.real(vals[0])

    return (A, x0), np.asarray(jax.grad(loss)(jnp.asarray(A)))


def test_ad_eigsolve_general_values_fd():
    (A, x0), gj = _jax_general_values()

    def loss(A):
        vals, _, _ = kt.eigsolve(A, T(x0), 1, "LR", tol=1e-12, krylovdim=n)
        return torch.real(vals[0])

    At = P(A)
    loss(At).backward()
    assert_conj_close(At.grad, gj)
    _fd_check(lambda Ak: float(loss(T(Ak))), A, At.grad.numpy(), 0, 5)


# ---------------------------------------------------------------- svdsolve

@functools.lru_cache(maxsize=None)
def _jax_svd_values():
    rng = np.random.default_rng(76)
    A = rand_mat(rng, 2 * n, n, np.float64)
    x0 = A @ rand_vec(rng, n, np.float64)

    def loss(A):
        vals, _, _, _ = kk.svdsolve(A, jnp.asarray(x0), 2, "LR", tol=1e-12, krylovdim=n,
                                    maxiter=100)
        return jnp.sum(vals)

    return (A, x0), np.asarray(jax.grad(loss)(jnp.asarray(A)))


def test_ad_svdsolve_values():
    (A, x0), gj = _jax_svd_values()
    At = P(A)
    vals, _, _, info = kt.svdsolve(At, T(x0), 2, "LR", tol=1e-12, krylovdim=n, maxiter=100)
    torch.sum(vals).backward()
    assert_conj_close(At.grad, gj)
    Ad = P(A)
    torch.sum(torch.linalg.svdvals(Ad)[:2]).backward()
    np.testing.assert_allclose(At.grad.numpy(), Ad.grad.numpy(), atol=1e-6)
    vals2, _, _, info2 = kt.svdsolve(T(A), T(x0), 2, "LR", tol=1e-12, krylovdim=n, maxiter=100)
    assert counts(info) == counts(info2) and torch.equal(vals.detach(), vals2)


def _pair_loss(c, d):
    return lambda u, v: torch.vdot(T(c), u) * torch.vdot(v, T(d))


@functools.lru_cache(maxsize=None)
def _jax_svd_vectors():
    rng = np.random.default_rng(77)
    A = rand_mat(rng, 2 * n, n, np.float64)
    x0 = A @ rand_vec(rng, n, np.float64)
    c = rand_vec(rng, 2 * n, np.float64)
    d = rand_vec(rng, n, np.float64)

    def loss(A):
        _, lv, rv, _ = kk.svdsolve(A, jnp.asarray(x0), 1, "LR", tol=1e-12, krylovdim=n,
                                   maxiter=100)
        return jnp.vdot(c, lv[0]) * jnp.vdot(rv[0], d)

    return (A, x0, c, d), np.asarray(jax.grad(loss)(jnp.asarray(A)))


def test_ad_svdsolve_vectors():
    (A, x0, c, d), gj = _jax_svd_vectors()
    At = P(A)
    _, lv, rv, _ = kt.svdsolve(At, T(x0), 1, "LR", tol=1e-12, krylovdim=n, maxiter=100)
    _pair_loss(c, d)(lv[0], rv[0]).backward()
    # the loss flips sign with the common sign of (u, v); both GKL solves
    # start from the same vector and end at the same signs
    g = At.grad.numpy()
    assert_conj_close(At.grad, gj)
    Ad = P(A)
    U, _, Vh = torch.linalg.svd(Ad, full_matrices=False)
    _pair_loss(c, d)(U[:, 0], Vh[0, :].conj()).backward()
    gd = Ad.grad.numpy()
    assert np.allclose(g, gd, atol=1e-6) or np.allclose(g, -gd, atol=1e-6)


# ---------------------------------------------------------------- Sylvester routes

@functools.lru_cache(maxsize=None)
def _jax_sylvester_path():
    rng = np.random.default_rng(78)
    m = 30
    As = hermitize(rand_mat(rng, m, m, np.float64))
    w, V = np.linalg.eigh(As)
    w[-1] = w[-2]  # doubly-degenerate top pair
    A = (V * w) @ V.T
    x0 = rand_vec(rng, m, np.float64)
    rr = kk.Arnoldi(tol=1e-12, krylovdim=m, maxiter=100)

    def loss(A):
        vals, _, _ = kk.eigsolve(A, jnp.asarray(x0), 2, "LR", ishermitian=True, tol=1e-12,
                                 krylovdim=m, alg_rrule=rr)
        return jnp.sum(vals)

    return (A, x0), np.asarray(jax.grad(loss)(jnp.asarray(A)))


def test_ad_eigsolve_sylvester_path():
    (A, x0), gj = _jax_sylvester_path()
    m = A.shape[0]
    At = P(A)
    vals, _, _ = kt.eigsolve(At, T(x0), 2, "LR", ishermitian=True, tol=1e-12, krylovdim=m,
                             alg_rrule=kt.Arnoldi(tol=1e-12, krylovdim=m, maxiter=100))
    torch.sum(vals).backward()
    assert_conj_close(At.grad, gj)
    Ad = P(A)
    torch.sum(torch.linalg.eigvalsh(Ad)[-2:]).backward()
    g, gd = At.grad.numpy(), Ad.grad.numpy()
    np.testing.assert_allclose(g + g.T, gd + gd.T, atol=1e-8)


@functools.lru_cache(maxsize=None)
def _jax_sylvester_vectors():
    rng = np.random.default_rng(79)
    m = 25
    A = hermitize(rand_mat(rng, m, m, np.float64))
    x0 = rand_vec(rng, m, np.float64)
    c = rand_vec(rng, m, np.float64)
    rr = kk.Arnoldi(tol=1e-12, krylovdim=m, maxiter=100)

    def loss(A):
        _, vecs, _ = kk.eigsolve(A, jnp.asarray(x0), 1, "SR", ishermitian=True, tol=1e-12,
                                 krylovdim=m, alg_rrule=rr)
        return jnp.abs(jnp.vdot(c, vecs[0])) ** 2

    return (A, x0, c), np.asarray(jax.grad(loss)(jnp.asarray(A)))


def test_ad_eigsolve_sylvester_vectors():
    (A, x0, c), gj = _jax_sylvester_vectors()
    m = A.shape[0]
    At = P(A)
    _, vecs, _ = kt.eigsolve(At, T(x0), 1, "SR", ishermitian=True, tol=1e-12, krylovdim=m,
                             alg_rrule=kt.Arnoldi(tol=1e-12, krylovdim=m, maxiter=100))
    _top_vector_loss(c)(vecs).backward()
    assert_conj_close(At.grad, gj)
    Ad = P(A)
    _top_vector_loss(c)(torch.linalg.eigh(Ad)[1][:, :1].T).backward()
    g, gd = At.grad.numpy(), Ad.grad.numpy()
    np.testing.assert_allclose(g + g.T, gd + gd.T, atol=1e-7)


@functools.lru_cache(maxsize=None)
def _jax_sylvester_general():
    rng = np.random.default_rng(80)
    m = 20
    A = rand_mat(rng, m, m, np.float64) + np.diag(np.linspace(1, 2, m))
    x0 = rand_vec(rng, m, np.float64)
    rr = kk.Arnoldi(tol=1e-12, krylovdim=m, maxiter=100)

    def loss(A):
        vals, _, _ = kk.eigsolve(A, jnp.asarray(x0), 1, "LR", tol=1e-12, krylovdim=m,
                                 alg_rrule=rr)
        return jnp.real(vals[0])

    return (A, x0), np.asarray(jax.grad(loss)(jnp.asarray(A)))


def test_ad_eigsolve_sylvester_general():
    (A, x0), gj = _jax_sylvester_general()
    m = A.shape[0]
    rr = kt.Arnoldi(tol=1e-12, krylovdim=m, maxiter=100)

    def loss(A):
        vals, _, _ = kt.eigsolve(A, T(x0), 1, "LR", tol=1e-12, krylovdim=m, alg_rrule=rr)
        return torch.real(vals[0])

    At = P(A)
    loss(At).backward()
    assert_conj_close(At.grad, gj)
    _fd_check(lambda Ak: float(loss(T(Ak))), A, At.grad.numpy(), 1, 5)


@functools.lru_cache(maxsize=None)
def _jax_svd_sylvester():
    rng = np.random.default_rng(81)
    A = rand_mat(rng, 30, 18, np.float64)
    x0 = A @ rand_vec(rng, 18, np.float64)
    c = rand_vec(rng, 30, np.float64)
    d = rand_vec(rng, 18, np.float64)
    rr = kk.Arnoldi(tol=1e-12, krylovdim=40, maxiter=200)

    def loss(A):
        vals, lv, rv, _ = kk.svdsolve(A, jnp.asarray(x0), 2, "LR", tol=1e-12, krylovdim=18,
                                      maxiter=200, alg_rrule=rr)
        return jnp.sum(vals) + jnp.vdot(c, lv[0]) * jnp.vdot(rv[0], d)

    return (A, x0, c, d), np.asarray(jax.grad(loss)(jnp.asarray(A)))


def test_ad_svdsolve_sylvester_path():
    (A, x0, c, d), gj = _jax_svd_sylvester()
    At = P(A)
    vals, lv, rv, _ = kt.svdsolve(At, T(x0), 2, "LR", tol=1e-12, krylovdim=18, maxiter=200,
                                  alg_rrule=kt.Arnoldi(tol=1e-12, krylovdim=40, maxiter=200))
    (torch.sum(vals) + _pair_loss(c, d)(lv[0], rv[0])).backward()
    g = At.grad.numpy()
    Ad = P(A)
    U, s, Vh = torch.linalg.svd(Ad, full_matrices=False)
    (s[0] + s[1] + _pair_loss(c, d)(U[:, 0], Vh[0, :].conj())).backward()
    gd = Ad.grad.numpy()
    assert np.allclose(g, gd, atol=1e-6) or np.allclose(g, -gd, atol=1e-6)
    # against JAX: both GKL solves start from the same vector and end at the
    # same signs of (u, v)
    assert_conj_close(At.grad, gj)


# ---------------------------------------------------------------- ParametricOperator

@functools.lru_cache(maxsize=None)
def _jax_parametric():
    rng = np.random.default_rng(20)
    m = 24
    S = rng.standard_normal((m, m))
    S = (S + S.T) / 2
    D = rng.standard_normal(m)
    x0 = rng.standard_normal(m)

    def smallest(g):
        op = kk.ParametricOperator(lambda g, x: jnp.asarray(S) @ x + g * jnp.asarray(D) * x,
                                   params=g)
        vals, _, _ = kk.eigsolve(op, jnp.asarray(x0), 1, "SR", ishermitian=True, krylovdim=24,
                                 maxiter=100, tol=1e-12)
        return vals[0]

    return (S, D, x0), float(jax.grad(smallest)(jnp.float64(0.3)))


def test_parametric_operator_gradient():
    (S, D, x0), dE_jax = _jax_parametric()
    St, Dt = T(S), T(D)

    def smallest(g):
        op = kt.ParametricOperator(lambda g, x: St @ x + g * Dt * x, params=g)
        vals, _, info = kt.eigsolve(op, T(x0), 1, "SR", ishermitian=True, krylovdim=24,
                                    maxiter=100, tol=1e-12)
        return vals[0], info

    g = P(np.float64(0.3))
    val, info = smallest(g)
    val.backward()
    dE = float(g.grad)
    assert abs(dE - dE_jax) <= GRAD_TOL * max(1.0, abs(dE_jax))
    eps = 1e-6
    fd = (float(smallest(T(np.float64(0.3 + eps)))[0])
          - float(smallest(T(np.float64(0.3 - eps)))[0])) / (2 * eps)
    assert abs(dE - fd) < 1e-6 * max(1.0, abs(fd))
    assert counts(info) == counts(smallest(T(np.float64(0.3)))[1])


# ---------------------------------------------------------------- repeated magnitudes

@functools.lru_cache(maxsize=None)
def _jax_block_cyclic():
    rng = np.random.default_rng(97)
    m = 6
    A = rand_mat(rng, m, m, np.float64) + 2 * np.eye(m)
    B = rand_mat(rng, m, m, np.float64) + 2 * np.eye(m)
    C = rand_mat(rng, m, m, np.float64) + 2 * np.eye(m)
    x0 = rand_vec(rng, 3 * m, np.float64)
    Z = jnp.zeros((m, m))

    def loss(Aj, Bj, Cj):
        M = jnp.block([[Z, Z, Cj], [Aj, Z, Z], [Z, Bj, Z]])
        vals, _, _ = kk.eigsolve(M, jnp.asarray(x0), 1, "LM", tol=1e-12, krylovdim=3 * m,
                                 maxiter=50)
        return jnp.real(vals[0] * jnp.conj(vals[0]))

    gs = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(A), jnp.asarray(B), jnp.asarray(C))
    return (A, B, C, x0), [np.asarray(g) for g in gs]


def test_ad_repeated_eigsolve_block_cyclic():
    (A, B, C, x0), gj = _jax_block_cyclic()
    m = A.shape[0]

    def loss(At, Bt, Ct):
        Z = torch.zeros((m, m), dtype=torch.float64)
        M = torch.cat([torch.cat([Z, Z, Ct], 1), torch.cat([At, Z, Z], 1),
                       torch.cat([Z, Bt, Z], 1)], 0)
        vals, _, _ = kt.eigsolve(M, T(x0), 1, "LM", tol=1e-12, krylovdim=3 * m, maxiter=50)
        return torch.real(vals[0] * torch.conj(vals[0]))

    blocks = [P(A), P(B), P(C)]
    loss(*blocks).backward()
    for bt, g in zip(blocks, gj):
        assert_conj_close(bt.grad, g)
    eps = 1e-6
    rng2 = np.random.default_rng(1)
    base = [A, B, C]
    for k in range(3):
        for _ in range(3):
            i, j = rng2.integers(0, m, 2)
            plus = [b.copy() for b in base]
            minus = [b.copy() for b in base]
            plus[k][i, j] += eps
            minus[k][i, j] -= eps
            fd = (float(loss(*map(T, plus))) - float(loss(*map(T, minus)))) / (2 * eps)
            assert abs(float(blocks[k].grad[i, j]) - fd) < 1e-4, (k, i, j, fd)


# ---------------------------------------------------------------- gauge warnings

def test_ad_gauge_warning_eager():
    """A loss that depends on the arbitrary eigenvector phase gives a
    cotangent with a gauge component: each pullback warns before projecting
    it out, as the JAX package's does outside jit."""
    rng = np.random.default_rng(3)
    M = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    A = M + M.conj().T
    c = T(rng.standard_normal(n) + 1j * rng.standard_normal(n))
    x0 = T(rng.standard_normal(n) + 0j)

    def loss(A, **kw):
        _, vecs, _ = kt.eigsolve(A, x0, 1, "LM", tol=1e-10, krylovdim=n, maxiter=40, **kw)
        return torch.imag(torch.vdot(c, vecs[0]))

    with pytest.warns(UserWarning, match="gauge"):
        loss(P(A)).backward()
    with pytest.warns(UserWarning, match="gauge"):
        loss(P(A), alg_rrule=kt.Arnoldi(krylovdim=n, tol=1e-10)).backward()
    R = rng.standard_normal((n + 2, n)) + 1j * rng.standard_normal((n + 2, n))
    u0 = T(rng.standard_normal(n + 2) + 0j)
    cu = T(rng.standard_normal(n + 2) + 1j * rng.standard_normal(n + 2))
    Rt = P(R)
    _, lv, _, _ = kt.svdsolve(Rt, u0, 1, "LR", tol=1e-10, krylovdim=n, maxiter=40)
    with pytest.warns(UserWarning, match="gauge"):
        torch.imag(torch.vdot(cu, lv[0])).backward()


def test_chip_smoke_ad_phases_rehearse_on_cpu():
    """``chip_smoke.py``'s AD phases on a 32 × 32 grid on the CPU (plain
    versions; launch counts are the card's to check): the bound states'
    gradient meets Hellmann–Feynman and the central difference through both
    rules, the linear-solve gradient the independent solve."""
    import krylovkit_tpu_torch as kt_
    from chip_smoke import ad_impurity, ad_potential
    from krylovkit_tpu_torch import _build
    from krylovkit_tpu_torch.ops import banded as bd
    from krylovkit_tpu_torch.ops import basis as bs

    ad_impurity(torch, np, kt_, _build, bs, bd, N=32, dev="cpu")
    ad_potential(torch, np, kt_, _build, bd, N=32, dev="cpu")


def _complex_route(kind, rule, lib):
    """A complex128 problem of ``kind`` (``herm``, ``gen`` or ``svd``) as
    ``(A, loss)``: ``loss(A)`` differentiates one solve in ``lib`` (``jnp``
    or ``torch``) with the GMRES (``rule`` None) or the Sylvester rule."""
    dt = np.complex128
    mod, xp = (kk, jnp) if lib is jnp else (kt, torch)
    arr = jnp.asarray if lib is jnp else T
    if kind == "herm":
        rng = np.random.default_rng(79)
        m = 16
        A = hermitize(rand_mat(rng, m, m, dt))
        x0, c = rand_vec(rng, m, dt), rand_vec(rng, m, dt)
        rr = mod.Arnoldi(tol=1e-12, krylovdim=m, maxiter=100) if rule else None

        def loss(A):
            vals, vecs, _ = mod.eigsolve(A, arr(x0), 2, "SR", ishermitian=True, tol=1e-12,
                                         krylovdim=m, alg_rrule=rr)
            return vals[0] + 0.3 * vals[1] + xp.abs(xp.vdot(arr(c), vecs[0])) ** 2
    elif kind == "gen":
        rng = np.random.default_rng(80)
        m = 14
        A = rand_mat(rng, m, m, dt) + np.diag(np.linspace(1, 2, m))
        x0 = rand_vec(rng, m, dt)
        rr = mod.Arnoldi(tol=1e-12, krylovdim=m, maxiter=100) if rule else None

        def loss(A):
            vals, _, _ = mod.eigsolve(A, arr(x0), 1, "LR", tol=1e-12, krylovdim=m, alg_rrule=rr)
            return xp.real(vals[0]) + 0.7 * xp.imag(vals[0])
    else:
        rng = np.random.default_rng(81)
        A = rand_mat(rng, 24, 14, dt)
        x0 = A @ rand_vec(rng, 14, dt)
        c, d = rand_vec(rng, 24, dt), rand_vec(rng, 14, dt)
        rr = mod.Arnoldi(tol=1e-12, krylovdim=40, maxiter=200) if rule else None

        def loss(A):
            vals, lv, rv, _ = mod.svdsolve(A, arr(x0), 2, "LR", tol=1e-12, krylovdim=14,
                                           maxiter=200, alg_rrule=rr)
            return xp.sum(vals) + xp.real(xp.vdot(arr(c), lv[0]) * xp.vdot(rv[0], arr(d)))
    return A, loss


@pytest.mark.parametrize("rule", [False, True], ids=["gmres_rule", "sylvester_rule"])
@pytest.mark.parametrize("kind", ["herm", "gen", "svd"])
def test_ad_complex_routes_match_jax(kind, rule):
    """Each backward route on a complex128 problem (``tests/test_ad.py``
    runs the Sylvester rules in float64 only): the port's gradient is the
    conjugate of ``jax.grad``'s within 1e-8; for the general eigenvalue it
    also meets the central differences of the real and imaginary parts
    (torch's gradient is ∂L/∂Re A + i·∂L/∂Im A)."""
    A, jloss = _complex_route(kind, rule, jnp)
    gj = np.asarray(jax.grad(jloss)(jnp.asarray(A)))
    _, tloss = _complex_route(kind, rule, torch)
    At = P(A)
    tloss(At).backward()
    assert_conj_close(At.grad, gj)
    if kind == "gen":
        eps, (i, j) = 1e-6, (3, 5)
        fd = 0
        for unit in (1, 1j):
            Ap, Am = A.copy(), A.copy()
            Ap[i, j] += unit * eps
            Am[i, j] -= unit * eps
            fd += unit * (float(tloss(T(Ap))) - float(tloss(T(Am)))) / (2 * eps)
        assert abs(complex(At.grad[i, j]) - fd) < 1e-5


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_dotu_matches_jax(dtype):
    """``ad.linsolve.dotu``, the unconjugated dot over the leaves of a
    tree, against the JAX package's; ``dot`` conjugates its first
    argument."""
    from krylovkit_tpu.ad.linsolve import dotu as jdotu
    from krylovkit_tpu_torch.ad.linsolve import dot, dotu

    rng = np.random.default_rng(72)
    x = (rand_vec(rng, n, dtype), rand_mat(rng, 3, 4, dtype))
    y = (rand_vec(rng, n, dtype), rand_mat(rng, 3, 4, dtype))
    got = complex(dotu(tuple(map(T, x)), tuple(map(T, y))))
    want = complex(jdotu(tuple(map(jnp.asarray, x)), tuple(map(jnp.asarray, y))))
    assert abs(got - want) <= 1e-12 * max(1.0, abs(want))
    conj = complex(dot(tuple(map(T, x)), tuple(map(T, y))))
    want = complex(jdotu(tuple(jnp.conj(jnp.asarray(a)) for a in x), tuple(map(jnp.asarray, y))))
    assert abs(conj - want) <= 1e-12 * max(1.0, abs(want))
