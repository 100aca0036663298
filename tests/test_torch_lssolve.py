"""PyTorch port: ``lssolve`` / ``reallssolve`` (LSMR) against the JAX package
on the same numpy inputs, and against ``np.linalg.lstsq``.

Float64 solutions agree to 1e-10 with equal ``numops``, ``numiter`` and
``converged``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import krylovkit_tpu as kk
import krylovkit_tpu_torch as kt
from krylovkit_tpu_torch import convert
from krylovkit_tpu_torch.ops import basis as tbs
from testsetup import N, n, precision, rand_mat, rand_vec

torch.set_num_threads(2)


def counts(info):
    return int(info.numops), int(info.numiter), int(info.converged)


def both(A, b, *lam, **kw):
    xj, ij = kk.lssolve(jnp.asarray(A), jnp.asarray(b), *lam, **kw)
    xt, it = kt.lssolve(torch.from_numpy(A), torch.from_numpy(b), *lam, **kw)
    return np.asarray(xj), ij, xt.numpy(), it


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_lsmr_overdetermined(dtype):
    rng = np.random.default_rng(21)
    A, b = rand_mat(rng, 2 * n, n, dtype), rand_vec(rng, 2 * n, dtype)
    tol = precision(dtype)
    xj, ij, xt, it = both(A, b, tol=tol, maxiter=200)
    want, *_ = np.linalg.lstsq(A, b, rcond=None)
    assert it.converged == 1 and counts(it) == counts(ij)
    assert np.allclose(xt, want, atol=100 * tol)
    np.testing.assert_allclose(xt, xj, atol=1e-10)
    # the normal-equation residual is the convergence measure
    r = b - A @ xt
    assert np.linalg.norm(A.conj().T @ r) <= 100 * tol
    # info.residual is the running residual b − A x
    np.testing.assert_allclose(it.residual.numpy(), r, atol=1e-9)
    np.testing.assert_allclose(float(it.normres), float(ij.normres), rtol=1e-4, atol=1e-14)


def test_lsmr_regularized():
    rng = np.random.default_rng(22)
    A, b = rand_mat(rng, 2 * n, n, np.float64), rand_vec(rng, 2 * n, np.float64)
    lam, tol = 0.7, precision(np.float64)
    xj, ij, xt, it = both(A, b, lam, tol=tol, maxiter=200)
    want = np.linalg.solve(A.T @ A + lam**2 * np.eye(n), A.T @ b)
    assert it.converged == 1 and counts(it) == counts(ij)
    assert np.allclose(xt, want, atol=100 * tol)
    np.testing.assert_allclose(xt, xj, atol=1e-10)


def test_lsmr_iterative_large():
    rng = np.random.default_rng(23)
    A, b = rand_mat(rng, 2 * N, N, np.float64), rand_vec(rng, 2 * N, np.float64)
    xj, ij, xt, it = both(A, b, tol=precision(np.float64), maxiter=4 * N)
    want, *_ = np.linalg.lstsq(A, b, rcond=None)
    assert it.converged == 1 and counts(it) == counts(ij)
    assert np.allclose(xt, want, atol=1e-7)
    np.testing.assert_allclose(xt, xj, atol=1e-10)


def test_lsmr_identity_opcount():
    """lssolve(I, b): converged = 1, numiter = 1, numops = 2 (reference
    test/issues.jl:22-29)."""
    xj, ij, xt, it = both(np.eye(2), np.ones(2), tol=1e-12)
    assert counts(it) == counts(ij) == (2, 1, 1)
    assert np.allclose(xt, 1.0)


def test_lsmr_tuple_operator_rectangular():
    rng = np.random.default_rng(24)
    A, b = rand_mat(rng, 3 * n, n, np.complex128), rand_vec(rng, 3 * n, np.complex128)
    Aj, At = jnp.asarray(A), torch.from_numpy(A)
    tol = precision(np.complex128)
    xj, ij = kk.lssolve((lambda x: Aj @ x, lambda y: Aj.conj().T @ y), jnp.asarray(b), tol=tol,
                        maxiter=200)
    xt, it = kt.lssolve((lambda x: At @ x, lambda y: At.conj().T @ y), torch.from_numpy(b), tol=tol,
                        maxiter=200)
    want, *_ = np.linalg.lstsq(A, b, rcond=None)
    assert it.converged == 1 and counts(it) == counts(ij)
    assert np.allclose(xt.numpy(), want, atol=100 * tol)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-10)


def test_reallssolve_rlinear():
    rng = np.random.default_rng(25)
    A = rand_mat(rng, n, n, np.complex128) + 3 * np.eye(n)
    Bm = 0.2 * rand_mat(rng, n, n, np.complex128)
    b = rand_vec(rng, n, np.complex128)
    Aj, Bj, At, Bt = jnp.asarray(A), jnp.asarray(Bm), torch.from_numpy(A), torch.from_numpy(Bm)
    # the real adjoint of x ↦ Ax + B conj(x) under Re⟨·,·⟩: y ↦ Aᴴy + Bᵀconj(y)
    jpair = (lambda x: Aj @ x + Bj @ jnp.conj(x), lambda y: Aj.conj().T @ y + Bj.T @ jnp.conj(y))
    tpair = (lambda x: At @ x + Bt @ torch.conj(x), lambda y: At.conj().T @ y + Bt.T @ torch.conj(y))
    tol = precision(np.complex128)
    xj, ij = kk.reallssolve(jpair, jnp.asarray(b), tol=tol, maxiter=300)
    xt, it = kt.reallssolve(tpair, torch.from_numpy(b), tol=tol, maxiter=300)
    assert it.converged == 1 and counts(it) == counts(ij)
    x = xt.numpy()
    assert np.linalg.norm(A @ x + Bm @ np.conj(x) - b) <= 1e-6
    np.testing.assert_allclose(x, np.asarray(xj), atol=1e-10)


@pytest.mark.parametrize("orth", ["cgs", "mgs", "cgs2", "mgs2", "cgsir", "mgsir"])
@pytest.mark.parametrize("krylovdim", [1, 5])
def test_lsmr_ring_reorthogonalization_matches_jax(orth, krylovdim):
    """A well-conditioned map (singular values in about [1, 1.4]): LSMR
    converges in ~15 iterations, before a ring of 1 or 5 vectors loses the
    orthogonality that keeps two roundings of the recurrence together."""
    rng = np.random.default_rng(26)
    A = np.vstack([np.eye(30), 0.3 * rand_mat(rng, 30, 30, np.float64) * np.sqrt(30)])
    b = rand_vec(rng, 60, np.float64)
    kw = dict(tol=1e-10, maxiter=100, krylovdim=krylovdim)
    xj, ij = kk.lssolve(jnp.asarray(A), jnp.asarray(b), orth=getattr(kk, orth), **kw)
    xt, it = kt.lssolve(torch.from_numpy(A), torch.from_numpy(b), orth=getattr(kt, orth), **kw)
    assert it.converged == 1 and it.numiter > 8 and counts(it) == counts(ij)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-10)


def test_lsmr_tolerances_alg_object_and_messages(capsys):
    rng = np.random.default_rng(27)
    A, b = rand_mat(rng, 50, 25, np.float64), rand_vec(rng, 50, np.float64)
    # rtol scales with ‖b‖; an explicit algorithm carries its own tol
    for kw in (dict(atol=1e-9, rtol=1e-7), dict(atol=1e-6, rtol=0.0), dict(rtol=1e-5)):
        xj, ij, xt, it = both(A, b, maxiter=100, **kw)
        assert counts(it) == counts(ij) and it.converged == 1
    jalg = kk.LSMR(krylovdim=4, tol=1e-8, maxiter=3, verbosity=kk.STARTSTOP)
    talg = convert.lsmr_from_dict({**dataclasses.asdict(jalg), "orth": type(jalg.orth).__name__})
    xj, ij = kk.lssolve(jnp.asarray(A), jnp.asarray(b), alg=jalg)
    capsys.readouterr()
    xt, it = kt.lssolve(torch.from_numpy(A), torch.from_numpy(b), alg=talg)
    out = capsys.readouterr().out
    assert counts(it) == counts(ij) == (7, 3, 0)
    assert "LSMR lssolve finished at iteration 3: converged = 0" in out
    assert "LSMR lssolve finished without converging after 3 iterations" in out
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-10)


def test_lsmr_zero_rhs_and_float32_stencil():
    # b = 0: converged before the first iteration, one apply
    A = np.eye(3)
    xj, ij, xt, it = both(A, np.zeros(3), tol=1e-12)
    assert counts(it) == counts(ij) == (1, 0, 1) and not xt.any()
    # a float32 stencil system on (R, 128) vectors, projection kernels' plain
    # versions on: the same solve
    chain = ((-1, 0, 1), (-1.0, 2.5, -1.0))
    jop, top = kk.StencilOperator(*chain), convert.stencil_from_arrays(*chain, device="cpu")
    b = np.random.default_rng(28).standard_normal((8, 128)).astype(np.float32)
    kw = dict(tol=1e-4, maxiter=60, krylovdim=6)
    xj, ij = kk.lssolve(jop, jnp.asarray(b), **kw)
    xt, it = kt.lssolve(top, torch.from_numpy(b), **kw)
    assert it.converged == 1 and counts(it) == counts(ij)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-4, atol=1e-5)
    old = tbs.use_pallas_projections
    tbs.use_pallas_projections = True
    try:
        xp, ip = kt.lssolve(top, torch.from_numpy(b), **kw)
    finally:
        tbs.use_pallas_projections = old
    assert counts(ip) == counts(it)
    np.testing.assert_allclose(xp.numpy(), xt.numpy(), rtol=1e-4, atol=1e-5)
