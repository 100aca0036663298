"""PyTorch port: ``exponentiate`` / ``expintegrator`` against the JAX package
on the same numpy inputs, and against dense oracles (``exp(tA)`` by
eigendecomposition, φ-functions by their Taylor series).

Float64 values agree with the JAX package to 1e-10 of the result's norm;
the float32 fused solves to 1e-5 relative (both packages run the same
scalar chain, the JAX kernel in interpret mode); ``numops``, ``numiter`` and
``converged`` are equal."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import krylovkit_tpu as kk
from krylovkit_tpu.factorizations import krylov as jkf
from krylovkit_tpu.ops.vector import STANDARD as JSTD
from krylovkit_tpu.solvers.expintegrator import _expintegrator_core as j_core
import krylovkit_tpu_torch as kt
from krylovkit_tpu_torch import convert, dense as tdense
from krylovkit_tpu_torch.factorizations import krylov as tkf
from krylovkit_tpu_torch.ops.vector import STANDARD as TSTD
from testsetup import N, hermitize, n, precision, rand_mat, rand_vec

torch.set_num_threads(2)

NEG_LAP = ((-1, 0, 1), (1.0, -2.0, 1.0))


def dense_expm(M):
    w, V = np.linalg.eig(M)
    return (V * np.exp(w)) @ np.linalg.inv(V)


def phi_mat(M, j, terms=60):
    """φ_j(M) by its Taylor series Σ_k M^k/(k+j)!."""
    out = np.zeros_like(M)
    term = np.eye(M.shape[0], dtype=M.dtype)
    for k_ in range(terms):
        out = out + term / math.factorial(k_ + j)
        term = term @ M
    return out


def counts(info):
    return int(info.numops), int(info.numiter), int(info.converged)


def both(A, t, us, **kw):
    """Run both packages on the same numpy inputs; returns
    ``(y_jax, info_jax, y_port, info_port)`` with numpy results."""
    us = us if isinstance(us, tuple) else (us,)
    yj, ij = kk.expintegrator(jnp.asarray(A), t, tuple(jnp.asarray(u) for u in us), **kw)
    yt, it = kt.expintegrator(torch.from_numpy(A), t, tuple(torch.from_numpy(u) for u in us), **kw)
    return np.asarray(yj), ij, yt.numpy(), it


def close(yt, yj, tol=1e-10):
    assert np.linalg.norm(yt - yj) <= tol * max(1.0, np.linalg.norm(yj))


@pytest.fixture
def interpret_mode():
    old = jkf.fused_interpret
    jkf.fused_interpret = True
    j_core.clear_cache()
    try:
        yield
    finally:
        jkf.fused_interpret = old
        j_core.clear_cache()


def test_expm_active_matches_jax():
    from krylovkit_tpu import dense as jdense

    rng = np.random.default_rng(3)
    for dtype in (np.float64, np.complex128):
        M = rand_mat(rng, 9, 9, dtype)
        for k in (0, 4, 9):
            want = np.asarray(jdense.expm_active(jnp.asarray(M), k))
            got = tdense.expm_active(torch.from_numpy(M), k).numpy()
            np.testing.assert_allclose(got, want, atol=1e-13)
            np.testing.assert_allclose(got[:k, :k], dense_expm(M[:k, :k]), atol=1e-12)
            np.testing.assert_array_equal(got[k:, k:], np.eye(9 - k))


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("herm", [True, False])
def test_exponentiate_full(dtype, herm):
    rng = np.random.default_rng(31)
    A = rand_mat(rng, n, n, dtype)
    if herm:
        A = hermitize(A)
    v = rand_vec(rng, n, dtype)
    t = 1.3
    yj, ij, yt, it = both(A, t, v, tol=precision(dtype), krylovdim=n + 2, ishermitian=herm)
    want = dense_expm(t * A) @ v
    assert it.converged == 1 and counts(it) == counts(ij)
    assert np.allclose(yt, want, atol=1e-8 * np.linalg.norm(want))
    close(yt, yj)
    assert abs(float(it.normres) - float(ij.normres)) <= 1e-10 + 1e-6 * float(ij.normres)
    assert it.residual is None


@pytest.mark.parametrize("t", [-0.7, 1j * 0.9, -0.3 + 0.4j])
def test_exponentiate_negative_and_complex_time(t):
    rng = np.random.default_rng(32)
    A = hermitize(rand_mat(rng, n, n, np.complex128))
    v = rand_vec(rng, n, np.complex128)
    yj, ij, yt, it = both(A, t, v, tol=1e-12, krylovdim=n + 2, ishermitian=True)
    assert np.allclose(yt, dense_expm(t * A) @ v, atol=1e-8)
    close(yt, yj)
    assert counts(it) == counts(ij)


def test_exponentiate_complex_time_promotes_real_problem():
    rng = np.random.default_rng(38)
    A = hermitize(rand_mat(rng, n, n, np.float64))
    v = rand_vec(rng, n, np.float64)
    t = 0.2 + 0.5j
    yj, ij, yt, it = both(A, t, v, tol=1e-12, krylovdim=n + 2, ishermitian=True)
    assert yt.dtype == np.complex128
    assert np.allclose(yt, dense_expm(t * A) @ v, atol=1e-8)
    close(yt, yj)
    assert counts(it) == counts(ij)


def test_exponentiate_iterative_restarts():
    rng = np.random.default_rng(33)
    A = hermitize(rand_mat(rng, N, N, np.float64))
    v = rand_vec(rng, N, np.float64)
    t = 6.0
    yj, ij, yt, it = both(A, t, v, tol=1e-10, krylovdim=10, maxiter=200, ishermitian=True)
    want = dense_expm(t * A) @ v
    assert it.numiter > 1  # genuine substepping/restarts
    assert counts(it) == counts(ij)
    assert np.allclose(yt, want, atol=1e-6 * np.linalg.norm(want))
    close(yt, yj, 1e-9)


@pytest.mark.parametrize("orth", ["cgs", "mgs", "cgs2", "mgs2", "cgsir", "mgsir"])
@pytest.mark.parametrize("herm", [True, False])
def test_exponentiate_all_orthogonalizers_match_jax(orth, herm):
    rng = np.random.default_rng(39)
    A = rand_mat(rng, 40, 40, np.float64)
    A = hermitize(A) if herm else A
    v = rand_vec(rng, 40, np.float64)
    kw = dict(tol=1e-10, krylovdim=12, maxiter=50, ishermitian=herm)
    yj, ij = kk.exponentiate(jnp.asarray(A), 2.0, jnp.asarray(v), orth=getattr(kk, orth), **kw)
    yt, it = kt.exponentiate(torch.from_numpy(A), 2.0, torch.from_numpy(v),
                             orth=getattr(kt, orth), **kw)
    assert it.converged == 1 and counts(it) == counts(ij)
    close(yt.numpy(), np.asarray(yj))
    assert np.allclose(yt.numpy(), dense_expm(2.0 * A) @ v, atol=1e-7)


@pytest.mark.parametrize("p", [1, 2, 3])
def test_expintegrator_phi_combination(p):
    rng = np.random.default_rng(34)
    A = rand_mat(rng, n, n, np.float64)
    us = tuple(rand_vec(rng, n, np.float64) for _ in range(p + 1))
    t = 0.9
    yj, ij, yt, it = both(A, t, us, tol=1e-12, krylovdim=n + p + 2)
    want = phi_mat(t * A, 0) @ us[0]
    for j in range(1, p + 1):
        want = want + t**j * (phi_mat(t * A, j) @ us[j])
    assert it.converged == 1 and counts(it) == counts(ij)
    assert np.allclose(yt, want, atol=1e-8 * np.linalg.norm(want))
    close(yt, yj)


def test_expintegrator_ode_solution():
    """y(t) solves ẋ = A x + u₁ with x(0) = u₀: y = e^{tA}u₀ + tφ₁(tA)u₁;
    the vectors may also be given as separate arguments."""
    rng = np.random.default_rng(35)
    A = rand_mat(rng, n, n, np.float64)
    u0, u1 = rand_vec(rng, n, np.float64), rand_vec(rng, n, np.float64)
    t = 1.1
    yj, ij, yt, it = both(A, t, (u0, u1), tol=1e-12, krylovdim=n + 3)
    want = dense_expm(t * A) @ u0 + t * (phi_mat(t * A, 1) @ u1)
    assert np.allclose(yt, want, atol=1e-8)
    close(yt, yj)
    assert counts(it) == counts(ij)
    y2, i2 = kt.expintegrator(torch.from_numpy(A), t, torch.from_numpy(u0),
                              torch.from_numpy(u1), tol=1e-12, krylovdim=n + 3)
    np.testing.assert_array_equal(y2.numpy(), yt)


def test_expintegrator_fixed_point():
    """t = Inf with (u₀, u₁): converge to the fixed point −A⁻¹u₁ of a stable A
    (reference src/matrixfun/expintegrator.jl:127-135)."""
    rng = np.random.default_rng(36)
    B = rand_mat(rng, n, n, np.float64)
    A = -(B @ B.T + np.eye(n))
    u0, u1 = rand_vec(rng, n, np.float64), rand_vec(rng, n, np.float64)
    yj, ij, yt, it = both(A, np.inf, (u0, u1), tol=1e-10, krylovdim=n + 2, maxiter=100,
                          ishermitian=True)
    assert it.converged == 1 and counts(it) == counts(ij)
    assert np.allclose(yt, -np.linalg.solve(A, u1), atol=1e-7)
    close(yt, yj, 1e-9)


def test_exponentiate_t_zero():
    rng = np.random.default_rng(37)
    A = rand_mat(rng, n, n, np.float64)
    v = rand_vec(rng, n, np.float64)
    yj, ij, yt, it = both(A, 0.0, v, tol=1e-12, krylovdim=n)
    assert np.allclose(yt, v)
    assert counts(it) == counts(ij)


def test_exponentiate_numops_reference_parity():
    """1 probe apply (reused as w[2]) + 1 initialize + (krylovdim-1) expansions
    per cycle, +2 per substep restart (p = 1)."""
    rng = np.random.default_rng(77)
    A = rng.standard_normal((40, 40))
    A = A + A.T
    v = rng.standard_normal(40)
    yj, ij, yt, it = both(A, 0.01, v, krylovdim=20, tol=1e-12, ishermitian=True)
    assert counts(it) == counts(ij) == (21, 1, 1)
    yj, ij, yt, it = both(A, 1.0, v, krylovdim=10, tol=1e-10, maxiter=30, ishermitian=True)
    assert it.numops == 11 * it.numiter and counts(it) == counts(ij)
    close(yt, yj)


def test_expintegrator_shrinking_dtau_counts():
    """A stiff spectrum drives the controller through its shrink loop
    (src/matrixfun/expintegrator.jl:203-221): every substep is a full cycle."""
    rng = np.random.default_rng(5)
    lam = np.linspace(1.0, 200.0, 40)
    A, v, m = np.diag(-lam), rng.standard_normal(40), 15
    yj, ij, yt, it = both(A, 1.0, v, krylovdim=m, tol=1e-8, maxiter=100, ishermitian=True)
    assert it.converged == 1 and it.numiter > 1
    assert it.numops == (1 + m) * it.numiter and counts(it) == counts(ij)
    assert np.allclose(yt, np.exp(-lam) * v, atol=1e-6)
    close(yt, yj, 1e-9)


def test_expintegrator_maxiter_exhausted_matches_jax():
    """At ``maxiter`` the last step takes the whole remaining interval and the
    solve reports ``converged == 0``."""
    rng = np.random.default_rng(5)
    A, v = np.diag(-np.linspace(1.0, 200.0, 40)), rng.standard_normal(40)
    yj, ij, yt, it = both(A, 1.0, v, krylovdim=8, tol=1e-10, maxiter=3, ishermitian=True,
                          verbosity=0)
    assert counts(it) == counts(ij) and it.converged == 0 and it.numiter == 3
    close(yt, yj, 1e-8)


def test_expintegrator_t_inf_counts():
    """t = Inf (src/matrixfun/expintegrator.jl:127-135, 289-304): the last w
    rebuild finds the fixed point and exits before the numiter increment."""
    rng = np.random.default_rng(0)
    Nn, m = 30, 10
    M = rng.standard_normal((Nn, Nn))
    A = -(M @ M.T + Nn * np.eye(Nn))
    b, x0 = rng.standard_normal(Nn), rng.standard_normal(Nn)
    yj, ij, yt, it = both(A, np.inf, (x0, b), krylovdim=m, tol=1e-10, maxiter=200,
                          ishermitian=True)
    assert it.converged == 1 and counts(it) == counts(ij)
    assert it.numops == (1 + m) * it.numiter + 1
    assert np.allclose(yt, -np.linalg.solve(A, b), atol=1e-8)
    np.testing.assert_allclose(float(it.normres), float(ij.normres), rtol=1e-5, atol=1e-14)


def test_expintegrator_immediate_fixed_point():
    """x0 already at the fixed point: one probe apply, numiter = 0
    (src/matrixfun/expintegrator.jl:160-163)."""
    rng = np.random.default_rng(0)
    v = rng.standard_normal(10)
    v /= np.linalg.norm(v)
    A = np.eye(10) - np.outer(v, v)  # A v = 0
    yj, ij, yt, it = both(A, 1.0, v, krylovdim=5, tol=1e-8)
    assert counts(it) == counts(ij) == (1, 0, 1)
    assert np.allclose(yt, v)


def test_expintegrator_phi_functions_counts():
    rng = np.random.default_rng(2)
    Nn, m = 40, 12
    M = rng.standard_normal((Nn, Nn))
    A = M + M.T
    us = tuple(rng.standard_normal(Nn) for _ in range(3))
    yj, ij, yt, it = both(A, 0.05, us, krylovdim=m, tol=1e-10, maxiter=60, ishermitian=True)
    assert it.converged == 1 and counts(it) == counts(ij)
    assert it.numops == (2 + m) * it.numiter
    close(yt, yj)


def test_expintegrator_eager_matches_jax():
    rng = np.random.default_rng(41)
    A = hermitize(rand_mat(rng, 30, 30, np.float64))
    v = rand_vec(rng, 30, np.float64)
    yj, ij, yt, it = both(A, 0.5, v, krylovdim=12, tol=1e-9, maxiter=40, ishermitian=True,
                          eager=True)
    assert counts(it) == counts(ij)
    close(yt, yj, 1e-9)


def test_expintegrator_alg_object_and_tol_override():
    rng = np.random.default_rng(42)
    A = rand_mat(rng, 20, 20, np.float64)
    v = rand_vec(rng, 20, np.float64)
    yj, ij = kk.exponentiate(jnp.asarray(A), 0.4, jnp.asarray(v),
                             alg=kk.Arnoldi(krylovdim=8, tol=1e-3, maxiter=20), tol=1e-9)
    yt, it = kt.exponentiate(torch.from_numpy(A), 0.4, torch.from_numpy(v),
                             alg=kt.Arnoldi(krylovdim=8, tol=1e-3, maxiter=20), tol=1e-9)
    assert counts(it) == counts(ij)
    close(yt.numpy(), np.asarray(yj), 1e-9)


def test_expintegrator_messages(capsys):
    A = np.diag(-np.linspace(1.0, 200.0, 40))
    v = np.random.default_rng(5).standard_normal(40)
    kt.exponentiate(torch.from_numpy(A), 1.0, torch.from_numpy(v), krylovdim=8, tol=1e-10,
                    maxiter=3, ishermitian=True, verbosity=kt.STARTSTOP)
    out = capsys.readouterr().out
    assert "expintegrate finished after 3 iterations: total error = " in out
    assert "expintegrate did not reach sufficiently small error after 3 iterations" in out


# --------------------------------------------------------------------------
# The fused one-stream expansion (float32 stencils, (R, 128) vectors)
# --------------------------------------------------------------------------

def _fused_inputs(seed, nvec=1 << 12):
    x = np.random.default_rng(seed).standard_normal((nvec // 128, 128)).astype(np.float32)
    return x, kk.StencilOperator(*NEG_LAP), convert.stencil_from_arrays(*NEG_LAP, device="cpu")


@pytest.mark.parametrize("orth", ["cgs", "cgs2"])
def test_fused_exponentiate_matches_jax(interpret_mode, orth):
    x, jop, top = _fused_inputs(7 if orth == "cgs" else 45)
    kw = dict(krylovdim=30, tol=1e-4, ishermitian=True)
    yj, ij = kk.exponentiate(jop, 0.1, jnp.asarray(x), orth=getattr(kk, orth), **kw)
    assert tkf.fused_available(top, torch.from_numpy(x), TSTD, kmax=31)
    yt, it = kt.exponentiate(top, 0.1, torch.from_numpy(x), orth=getattr(kt, orth), **kw)
    assert it.converged == 1 and counts(it) == counts(ij)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5, atol=1e-5)
    # ... and the port's own unfused solve (mgs2: the fused gate refuses it)
    yu, iu = kt.exponentiate(top, 0.1, torch.from_numpy(x), orth=kt.mgs2, **kw)
    assert iu.numops == it.numops and iu.converged == 1
    np.testing.assert_allclose(yt.numpy(), yu.numpy(), rtol=1e-4, atol=1e-6)
    # exp(t·A) of a negative semidefinite A contracts
    assert float(torch.linalg.norm(yt)) <= (1 + 1e-4) * np.linalg.norm(x)


def test_fused_exponentiate_substeps_match_jax(interpret_mode):
    """A long interval on a short subspace: restarts, the shrink loop and the
    rejected partial attempts all run on the fused path."""
    x, jop, top = _fused_inputs(46, 1 << 11)
    kw = dict(krylovdim=8, tol=1e-5, maxiter=60, ishermitian=True)
    yj, ij = kk.exponentiate(jop, 3.0, jnp.asarray(x), **kw)
    yt, it = kt.exponentiate(top, 3.0, torch.from_numpy(x), **kw)
    assert it.numiter > 1 and counts(it) == counts(ij)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-4, atol=1e-5)


def test_fused_exponentiate_t_inf_takes_one_step_per_round(interpret_mode):
    """With t = Inf the error budget of the remaining interval is infinite, so
    every round takes only its forced step: the ``min_one`` path."""
    x, jop, top = _fused_inputs(47, 1 << 11)
    b = np.random.default_rng(48).standard_normal(x.shape).astype(np.float32)
    jshift = kk.StencilOperator((-1, 0, 1), (1.0, -3.0, 1.0))
    tshift = convert.stencil_from_arrays((-1, 0, 1), (1.0, -3.0, 1.0), device="cpu")
    kw = dict(krylovdim=10, tol=1e-3, maxiter=30, ishermitian=True)
    yj, ij = kk.expintegrator(jshift, np.inf, (jnp.asarray(x), jnp.asarray(b)), **kw)
    yt, it = kt.expintegrator(tshift, np.inf, (torch.from_numpy(x), torch.from_numpy(b)), **kw)
    assert counts(it) == counts(ij)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-3, atol=1e-4)


def _states(x, m):
    jst = jkf.initialize(jnp.asarray(x), m, jnp.float32)
    tst = tkf.initialize(torch.from_numpy(x), m, torch.float32)
    return jst, jkf.fused_scales_init(m + 1), tst, tkf.fused_scales_init(m + 1, device="cpu")


def test_fused_min_one_forces_progress(interpret_mode):
    """``min_one`` makes exactly one step from a state with β <= btol, and
    none is made without it, as in the JAX package."""
    x = np.random.default_rng(12).standard_normal((32, 128)).astype(np.float32)
    jop, top = kk.parallel.laplacian_1d(1 << 12, jnp.float32), kt.laplacian_1d(1 << 12, device="cpu")
    m = 10
    for min_one, k_want in ((False, 0), (True, 1)):
        jst0, jsc0, tst0, tsc0 = _states(x, m)
        jst, jsc, jops = jkf.fused_expansions(jop, jst0, jsc0, m, jnp.float32(1e6), JSTD,
                                              min_one=min_one)
        tst, tsc, tops = tkf.fused_expansions(top, tst0, tsc0, m, 1e6, TSTD, min_one=min_one)
        assert tst.k == int(jst.k) == k_want and tops == int(jops) == 1 + k_want
        np.testing.assert_allclose(float(tst.beta), float(jst.beta), rtol=1e-6)
        np.testing.assert_allclose(tst.H.numpy(), np.asarray(jst.H), rtol=1e-5, atol=1e-6)


def test_fused_reentry_with_unnormalized_rows(interpret_mode):
    """Entered mid-build with raw stored rows (the rejected partial attempt of
    the expintegrator), the priming norm comes from the scales: two calls
    build what one call builds, in the port as in the JAX package."""
    x = np.random.default_rng(11).standard_normal((32, 128)).astype(np.float32)
    jop, top = kk.parallel.laplacian_1d(1 << 12, jnp.float32), kt.laplacian_1d(1 << 12, device="cpu")
    m = 12
    jst0, jsc0, tst0, tsc0 = _states(x, m)
    jst1, jsc1, jops1 = jkf.fused_expansions(jop, jst0, jsc0, 6, jnp.float32(1e-12), JSTD)
    jst2, jsc2, jops2 = jkf.fused_expansions(jop, jst1, jsc1, m, jnp.float32(1e-12), JSTD)
    # the port continues from the JAX package's intermediate state ...
    tmid = convert.krylov_state_from_numpy(
        np.asarray(jst1.V), np.asarray(jst1.H), int(jst1.k), np.asarray(jst1.beta), "cpu")
    tscm = convert.fused_scales_from_numpy(*(np.asarray(a) for a in jsc1), device="cpu")
    assert abs(float(tscm.s[6]) - 1.0) > 1e-3  # row 6 is stored unnormalized
    tst2, tsc2, tops2 = tkf.fused_expansions(top, tmid, tscm, m, 1e-12, TSTD)
    assert tops2 == int(jops2) and tst2.k == int(jst2.k) == m
    np.testing.assert_allclose(torch.tril(tst2.H).numpy(), np.tril(np.asarray(jst2.H)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tsc2.s.numpy(), np.asarray(jsc2.s), rtol=1e-5)
    np.testing.assert_allclose(tst2.V.numpy(), np.asarray(jst2.V), rtol=1e-4, atol=1e-5)
    # ... and its own two-call build equals its one-call build
    tA, scA, opsA = tkf.fused_expansions(top, tst0, tsc0, m, 1e-12, TSTD)
    _, _, t0, s0 = _states(x, m)
    t1, s1, ops1 = tkf.fused_expansions(top, t0, s0, 6, 1e-12, TSTD)
    t2, s2, ops2 = tkf.fused_expansions(top, t1, s1, m, 1e-12, TSTD)
    assert opsA == ops1 + ops2
    np.testing.assert_allclose(torch.tril(t2.H).numpy(), torch.tril(tA.H).numpy(),
                               rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(t2.V.numpy(), tA.V.numpy(), rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("herm", [True, False])
def test_exponentiate_complex_map_with_real_start_matches_expm(herm):
    """A complex matrix and a real float64 start: both packages already
    promote (the probe found no imaginary part dropped); the port matches
    ``exp(tA) x0`` and the JAX package's counts."""
    r = np.random.default_rng(0)
    A = (r.standard_normal((100, 100)) + 1j * r.standard_normal((100, 100))) / 10
    if herm:
        A = (A + A.conj().T) / 2
    x0 = np.random.default_rng(0).standard_normal(100)
    want = dense_expm(0.3 * A) @ x0
    yt, it = kt.exponentiate(torch.from_numpy(A), 0.3, torch.from_numpy(x0), tol=1e-10)
    yj, ij = kk.exponentiate(jnp.asarray(A), 0.3, jnp.asarray(x0), tol=1e-10)
    assert yt.dtype == torch.complex128
    assert np.linalg.norm(yt.numpy() - want) <= 1e-12 * np.linalg.norm(want)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-12)
    assert (it.numops, it.numiter, it.converged) == (
        int(ij.numops), int(ij.numiter), int(ij.converged))
