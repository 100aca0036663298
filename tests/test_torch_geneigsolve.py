"""PyTorch port: ``geneigsolve`` (Golub-Ye) against the JAX package on the
CPU, mirroring ``tests/test_geneigsolve.py``, plus the Q1 finite-element
pencil as two ``BandedOperator``\\ s with the projection kernels' plain
versions on and off.

The same numpy inputs, made from a seed, go to both packages.  Tolerances:
values rtol 1e-10 in float64/complex128 and 1e-5 in float32/complex64
(float32 rounding of two differently ordered reductions); residual norms
within 1e-3 of each other relative, or absolute 1e-3·tol (float64,
complex128) and 0.1·tol (float32, complex64, whose converged residuals are
rounding noise of ~eps·‖A‖, 3e-7 at tol 4.8e-6); ``numops``,
``numiter`` and ``converged`` equal.  ``test_geneig_pytree_mode`` is
mirrored in ``tests/test_torch_pytree_drivers.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import krylovkit_tpu as kk
from chip_smoke import q1_coo
from krylovkit_tpu.ops.pallas_spmv import banded_from_coo as j_banded_from_coo
import krylovkit_tpu_torch as kt
from krylovkit_tpu_torch import convert
from krylovkit_tpu_torch.ops import basis as tbs
from testsetup import N, hermitize, n, precision, rand_mat, rand_vec

torch.set_num_threads(2)

ORTHS = ["cgs2", "mgs2", "cgsir", "mgsir"]


def make_pencil(rng, m, dtype):
    A = hermitize(rand_mat(rng, m, m, dtype))
    C = rand_mat(rng, m, m, dtype)
    B = C @ C.conj().T + 2 * np.eye(m, dtype=dtype)
    return A, B


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rtol(dtype):
    return 1e-5 if np.dtype(dtype) in (np.float32, np.complex64) else 1e-10


def assert_same(got, want, dtype, tol, rtol=None):
    """Values, residual norms and counts of a port solve against a JAX one."""
    vt, _, it = got
    vj, _, ij = want
    rtol = rtol or _rtol(dtype)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=rtol, atol=rtol)
    floor = 0.1 if np.dtype(dtype) in (np.float32, np.complex64) else 1e-3
    np.testing.assert_allclose(it.normres.numpy(), np.asarray(ij.normres), rtol=1e-3,
                               atol=floor * tol)
    assert (it.numops, it.numiter, it.converged) == (
        int(ij.numops), int(ij.numiter), int(ij.converged))


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("which", ["SR", "LR"])
def test_geneig_full_matches_jax(dtype, which):
    rng = np.random.default_rng(41)
    A, B = make_pencil(rng, n, dtype)
    x0 = rand_vec(rng, n, dtype)
    tol = precision(dtype)
    kw = dict(krylovdim=n, tol=tol, maxiter=50)
    want = kk.geneigsolve((A, B), jnp.asarray(x0), 2, which, **kw)
    got = kt.geneigsolve((_t(A), _t(B)), _t(x0), 2, which, **kw)
    assert_same(got, want, dtype, tol)
    vals, vecs, info = got
    assert info.converged >= 2 and vecs.shape == (2, n) and vecs.dtype == _t(x0).dtype
    for i in range(2):
        v = vecs[i].numpy()
        assert np.linalg.norm(A @ v - float(vals[i]) * (B @ v)) <= 1e-5 * np.linalg.norm(v)


def test_geneig_iterative_matches_jax():
    rng = np.random.default_rng(42)
    A, B = make_pencil(rng, N, np.float64)
    x0 = rand_vec(rng, N, np.float64)
    kw = dict(krylovdim=25, tol=1e-8, maxiter=200)
    want = kk.geneigsolve((A, B), jnp.asarray(x0), 2, "SR", **kw)
    got = kt.geneigsolve((_t(A), _t(B)), _t(x0), 2, "SR", **kw)
    assert_same(got, want, np.float64, 1e-8)
    assert got[2].converged == 2 and got[2].numiter > 1  # restarts with LOCG and deflation


@pytest.mark.parametrize("form", ["pair", "bare"])
def test_geneig_b_identity_matches_jax(form):
    rng = np.random.default_rng(43)
    A = hermitize(rand_mat(rng, n, n, np.float64))
    x0 = rand_vec(rng, n, np.float64)
    kw = dict(krylovdim=n, tol=1e-10, maxiter=60)
    want = kk.geneigsolve((A, None), jnp.asarray(x0), 2, "SR", **kw)
    got = kt.geneigsolve((_t(A), None) if form == "pair" else _t(A), _t(x0), 2, "SR", **kw)
    assert_same(got, want, np.float64, 1e-10)
    np.testing.assert_allclose(got[0].numpy(), np.linalg.eigvalsh(A)[:2], atol=1e-7)


def test_geneig_callable_pencil_matches_jax():
    rng = np.random.default_rng(44)
    A, B = make_pencil(rng, n, np.float64)
    x0 = rand_vec(rng, n, np.float64)
    Aj, Bj, At, Bt = jnp.asarray(A), jnp.asarray(B), _t(A), _t(B)
    kw = dict(krylovdim=n, tol=1e-10, maxiter=60)
    want = kk.geneigsolve((lambda x: Aj @ x, lambda x: Bj @ x), jnp.asarray(x0), 1, "SR", **kw)
    got = kt.geneigsolve((lambda x: At @ x, lambda x: Bt @ x), _t(x0), 1, "SR", **kw)
    assert_same(got, want, np.float64, 1e-10)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex64, np.complex128])
@pytest.mark.parametrize("orth", ORTHS)
def test_geneig_full_matrix_matches_jax(dtype, orth):
    """The reference-parity matrix (test/geneigsolve.jl:1-25): dtype × orth,
    float32 at eps^(2/3), with B-orthonormality and the residual identity."""
    rng = np.random.default_rng(45)
    A, B = make_pencil(rng, n, dtype)
    x0 = rand_vec(rng, n, dtype)
    tol = precision(dtype)
    howmany = n // 2
    want = kk.geneigsolve((A, B), jnp.asarray(x0), howmany, "SR", krylovdim=n, tol=tol,
                          maxiter=3, orth=getattr(kk, orth))
    alg = convert.golubye_from_dict({"krylovdim": n, "tol": tol, "maxiter": 3, "orth": orth})
    got = kt.geneigsolve((_t(A), _t(B)), _t(x0), howmany, "SR", alg=alg)
    assert_same(got, want, dtype, tol)
    vals, vecs, _ = got
    V = vecs.numpy().T
    D = vals.numpy()
    assert np.linalg.norm(V.conj().T @ B @ V - np.eye(howmany)) <= 1000 * tol
    assert np.linalg.norm(A @ V - (B @ V) * D) <= 2000 * tol


@pytest.fixture
def projections():
    yield
    tbs.use_pallas_projections = False


@pytest.mark.parametrize("dtype,flag,maxiter", [
    (np.float64, False, 300), (np.float32, False, 2), (np.float32, True, 2)],
    ids=["float64-converged", "float32-sweeps", "float32-projection_kernels"])
def test_q1_banded_pencil_matches_jax(projections, dtype, flag, maxiter):
    """The Q1 pencil on a 16×64 grid (n = 1024, ``(8, 128)`` vectors, nine
    offsets each; no repeated eigenvalue, so both packages take the same
    path): float64 to convergence, float32 for 2 cycles.  In float32 the
    leading value agrees to 1e-5 and the unconverged trailing ones to 1e-3
    (their Ritz values follow the rounding: 1e-4 apart with the unbucketed
    sweeps of the flag, 5e-4 after 4 cycles).  With the flag on, the
    float32 sweeps run the projection kernels' plain versions."""
    Kc, Mc = q1_coo(np, 16, 64, dtype)
    nn = 16 * 64
    x0 = np.random.default_rng(0).standard_normal((nn // 128, 128)).astype(dtype)
    tol = 1e-8 if dtype == np.float64 else 1e-30
    kw = dict(krylovdim=30, tol=tol, maxiter=maxiter, verbosity=0)
    want = kk.geneigsolve((j_banded_from_coo(*Kc, nn), j_banded_from_coo(*Mc, nn)),
                          jnp.asarray(x0), 4, "SR", **kw)
    Kt, Mt = kt.banded_from_coo(*Kc, nn, device="cpu"), kt.banded_from_coo(*Mc, nn, device="cpu")
    assert len(Kt.offsets) == len(Mt.offsets) == 9
    tbs.use_pallas_projections = flag
    got = kt.geneigsolve((Kt, Mt), _t(x0), 4, "SR", **kw)
    assert_same(got, want, dtype, max(tol, 1e-6), rtol=None if dtype == np.float64 else 1e-3)
    np.testing.assert_allclose(float(got[0][0]), float(want[0][0]), rtol=_rtol(dtype))
    assert got[2].converged == (4 if dtype == np.float64 else 0)


def test_q1_square_pencil_smallest_value_is_analytic():
    """N = 32 square grid: the smallest value is 2μ₁ with
    μ_i = 6(1 − cos θ_i)/(2 + cos θ_i), θ_i = iπ/(N+1)."""
    N_ = 32
    Kc, Mc = q1_coo(np, N_, N_, np.float64)
    x0 = np.random.default_rng(0).standard_normal(N_ * N_)
    ops = (kt.banded_from_coo(*Kc, N_ * N_, device="cpu"), kt.banded_from_coo(*Mc, N_ * N_, device="cpu"))
    vals, _, info = kt.geneigsolve(ops, _t(x0), 4, "SR", krylovdim=30, tol=1e-8, maxiter=300)
    th = np.pi / (N_ + 1)
    assert info.converged == 4
    assert abs(float(vals[0]) - 12 * (1 - np.cos(th)) / (2 + np.cos(th))) <= 1e-8


def test_geneig_default_x0_matches_jax():
    rng = np.random.default_rng(47)
    A, B = make_pencil(rng, n, np.float64)
    kw = dict(krylovdim=n, tol=1e-10, maxiter=20)
    want = kk.geneigsolve((A, B), None, 2, "SR", **kw)
    got = kt.geneigsolve((_t(A), _t(B)), None, 2, "SR", **kw)
    assert_same(got, want, np.float64, 1e-10)


def test_geneig_guards_match_jax():
    rng = np.random.default_rng(48)
    A, B = make_pencil(rng, n, np.float64)
    x0 = rand_vec(rng, n, np.float64)
    for pkg, conv in ((kk, jnp.asarray), (kt, _t)):
        with pytest.raises(ValueError, match="x0 is required unless A is a concrete matrix"):
            pkg.geneigsolve((lambda x: x, None), None, 1)
        with pytest.raises(ValueError, match=r"which=LI/SI invalid for Hermitian pencils"):
            pkg.geneigsolve((conv(A), conv(B)), conv(x0), 1, "si")
        with pytest.raises(ValueError, match="howmany=4 exceeds krylovdim=3"):
            pkg.geneigsolve((conv(A), conv(B)), conv(x0), 4, "SR", krylovdim=3)


def test_geneig_alg_tol_override_and_numpy_pencil():
    """An explicit ``alg`` with another ``tol`` keyword takes the keyword (as
    the JAX front-end's ``dataclasses.replace``); numpy matrices move to
    ``x0``'s device."""
    rng = np.random.default_rng(49)
    A, B = make_pencil(rng, n, np.float64)
    x0 = rand_vec(rng, n, np.float64)
    jalg = kk.GolubYe(krylovdim=n, maxiter=20, tol=1e-4)
    want = kk.geneigsolve((A, B), jnp.asarray(x0), 2, "SR", alg=jalg, tol=1e-12)
    talg = convert.golubye_from_dict({**dataclasses.asdict(jalg), "orth": "cgs2"})
    got = kt.geneigsolve((A, B), _t(x0), 2, "SR", alg=talg, tol=1e-12)
    assert_same(got, want, np.float64, 1e-12)
