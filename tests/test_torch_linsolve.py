"""PyTorch port: the linear solvers (CG, GMRES, MINRES, BiCGStab) and their
front-end against the JAX package, mirroring ``tests/test_linsolve.py``.

The same numpy inputs go through ``kk.linsolve`` (JAX on the CPU, its fused
kernel in Pallas interpret mode) and ``kt.linsolve`` (CPU tensors, the
kernels' plain versions).  Tolerances:

* ``numops``/``numiter``/``converged`` equal;
* float64/complex128: ``x`` within rtol 1e-10 of the JAX solution (both sum
  in another order, nothing more); ``normres`` within rtol 1e-4 or half the
  solve's tolerance: a converged ``normres`` is a true residual below
  ``tol``, set by the last bits of ``x``;
* float32 (the fused GMRES path): ``x`` within 2e-5 of its largest entry,
  the float32 noise of a solve at 1.6e-5 relative tolerance; 2e-4 for the
  raw Poisson runs, whose condition number (~800) amplifies that noise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import krylovkit_tpu as kk
from krylovkit_tpu.dense.givens import givens as j_givens
from krylovkit_tpu.dense.triangular import solve_upper_active as j_solve_upper_active
from krylovkit_tpu.factorizations import krylov as jkf
from krylovkit_tpu.ops.pallas_spmv import banded_from_coo as j_banded_from_coo
from krylovkit_tpu.parallel import poisson_2d as j_poisson_2d
from krylovkit_tpu.solvers import linsolve as jls
import krylovkit_tpu_torch as kt
from krylovkit_tpu_torch import convert
from krylovkit_tpu_torch.dense import givens as t_givens
from krylovkit_tpu_torch.dense import solve_upper_active as t_solve_upper_active
from krylovkit_tpu_torch.factorizations import krylov as tkf
from krylovkit_tpu_torch.ops.operator import apply_shifted
from krylovkit_tpu_torch.solvers import linsolve as tls

torch.set_num_threads(2)

n, N = 10, 100
_TO_PORT = {
    kk.CG: convert.cg_from_dict,
    kk.GMRES: convert.gmres_from_dict,
    kk.MINRES: convert.minres_from_dict,
    kk.BiCGStab: convert.bicgstab_from_dict,
}


def _alg(jalg):
    fields = dataclasses.asdict(jalg)
    if "orth" in fields:
        fields["orth"] = type(jalg.orth).__name__
    return _TO_PORT[type(jalg)](fields)


def rand_mat(rng, m, dtype):
    a = rng.standard_normal((m, m))
    if np.dtype(dtype).kind == "c":
        a = a + 1j * rng.standard_normal((m, m))
    return (a / np.sqrt(m)).astype(dtype)


def rand_vec(rng, m, dtype):
    v = rng.standard_normal(m)
    if np.dtype(dtype).kind == "c":
        v = v + 1j * rng.standard_normal(m)
    return v.astype(dtype)


def precision(dtype):
    return np.finfo(np.dtype(dtype)).eps ** (2 / 3)


def _solve_both(A, b, x0=None, **kw):
    """The same solve through both packages; ``alg`` is a JAX struct."""
    kw_t = dict(kw)
    if "alg" in kw:
        kw_t["alg"] = _alg(kw["alg"])
    jA = A if callable(A) else jnp.asarray(A)
    tA = A if callable(A) else torch.from_numpy(np.asarray(A))
    jout = kk.linsolve(jA, jnp.asarray(b), None if x0 is None else jnp.asarray(x0), **kw)
    tout = kt.linsolve(tA, torch.from_numpy(np.asarray(b)),
                       None if x0 is None else torch.from_numpy(np.asarray(x0)), **kw_t)
    return jout, tout


def _check(jout, tout, tol, rtol=1e-10):
    (xj, ij), (xt, it) = jout, tout
    assert it.numops == int(ij.numops)
    assert it.numiter == int(ij.numiter)
    assert it.converged == int(ij.converged)
    xj = np.asarray(xj)
    assert xt.shape == xj.shape and xt.dtype == torch.from_numpy(xj).dtype
    np.testing.assert_allclose(xt.numpy(), xj, rtol=rtol, atol=rtol * np.max(np.abs(xj)))
    np.testing.assert_allclose(float(it.normres), float(ij.normres), rtol=1e-4, atol=0.5 * tol)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("size", [n, N])
def test_cg_posdef_matches_jax(dtype, size):
    rng = np.random.default_rng(1)
    B = rand_mat(rng, size, dtype)
    A = B @ B.conj().T + np.eye(size, dtype=dtype)
    b = rand_vec(rng, size, dtype)
    tol = float(precision(dtype) * np.linalg.norm(b))
    jout, tout = _solve_both(A, b, tol=tol, maxiter=2 * size)  # auto-selects CG
    _check(jout, tout, tol)
    assert tout[1].converged == 1


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("size,krylovdim", [(n, None), (N, 20)])
def test_gmres_matches_jax(dtype, size, krylovdim):
    rng = np.random.default_rng(3)
    A = rand_mat(rng, size, dtype) + 2 * np.eye(size, dtype=dtype)
    b = rand_vec(rng, size, dtype)
    tol = float(precision(dtype) * np.linalg.norm(b))
    jout, tout = _solve_both(A, b, tol=tol, krylovdim=krylovdim, maxiter=50)
    _check(jout, tout, tol)
    assert tout[1].converged == 1
    if size == N:
        assert tout[1].numiter > 1  # genuine restarts


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_shifted_solve_matches_jax(dtype):
    rng = np.random.default_rng(5)
    A = rand_mat(rng, n, dtype)
    b = rand_vec(rng, n, dtype)
    tol = float(precision(dtype) * np.linalg.norm(b))
    jout, tout = _solve_both(A, b, a0=3.0, a1=0.5, tol=tol)
    _check(jout, tout, tol)
    x = tout[0].numpy()
    assert np.linalg.norm(b - (3.0 * x + 0.5 * (A @ x))) <= 2 * tol


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("explicit", [False, True])
def test_minres_hermitian_indefinite_matches_jax(dtype, explicit):
    rng = np.random.default_rng(6)
    A = rand_mat(rng, n, dtype)
    A = (A + A.conj().T) / 2  # indefinite
    b = rand_vec(rng, n, dtype)
    tol = float(precision(dtype) * np.linalg.norm(b))
    kw = {"alg": kk.MINRES(tol=tol, maxiter=100)} if explicit else {"tol": tol}
    jout, tout = _solve_both(A, b, **kw)
    # MINRES amplifies rounding more than the others (~1e-11 here)
    _check(jout, tout, tol, rtol=1e-9)
    assert tout[1].converged == 1


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_bicgstab_matches_jax(dtype):
    rng = np.random.default_rng(7)
    A = rand_mat(rng, N, dtype) + 2 * np.eye(N, dtype=dtype)
    b = rand_vec(rng, N, dtype)
    tol = float(precision(dtype) * np.linalg.norm(b))
    jout, tout = _solve_both(A, b, alg=kk.BiCGStab(tol=tol, maxiter=4 * N))
    _check(jout, tout, tol)
    assert tout[1].converged == 1


def test_zero_rhs_immediate():
    jout, tout = _solve_both(np.eye(n), np.zeros(n), tol=1e-12)
    _check(jout, tout, 1e-12)
    assert tout[1].converged == 1 and tout[1].numiter == 0 and tout[1].numops == 1
    assert not torch.any(tout[0])


def test_identity_opcount():
    b = rand_vec(np.random.default_rng(10), n, np.float64)
    jout, tout = _solve_both(np.eye(n), b, tol=1e-10)
    _check(jout, tout, 1e-10)
    np.testing.assert_allclose(tout[0].numpy(), b, atol=1e-10)


def test_gmres_warm_start_matches_jax():
    rng = np.random.default_rng(11)
    A = rand_mat(rng, N, np.float64) + 2 * np.eye(N)
    b = rand_vec(rng, N, np.float64)
    xstar = np.linalg.solve(A, b)
    x0 = xstar + 1e-8 * rand_vec(rng, N, np.float64)
    cold = _solve_both(A, b, tol=1e-10, krylovdim=30, maxiter=100)
    warm = _solve_both(A, b, x0, tol=1e-10, krylovdim=30, maxiter=100)
    _check(*cold, 1e-10)
    _check(*warm, 1e-10)
    assert warm[1][1].numops < cold[1][1].numops


@pytest.mark.parametrize("override", [False, True])
def test_explicit_alg_tol_matches_jax(override):
    rng = np.random.default_rng(30)
    A = rand_mat(rng, 40, np.float64)
    A = A @ A.conj().T + 10 * np.eye(40)
    b = rand_vec(rng, 40, np.float64)
    kw = {"tol": 1e-10} if override else {}
    jout, tout = _solve_both(A, b, alg=kk.CG(tol=1e-3, maxiter=500), **kw)
    _check(jout, tout, kw.get("tol", 1e-3))
    if override:
        assert float(tout[1].normres) <= 1e-9
    else:
        assert tout[1].numiter < 100  # the alg's loose tol, not maxiter


SELECT_CASES = [
    ("posdef", 0.0, 1.0, None, None),
    ("posdef", -0.5, 1.0, None, None),  # a negative shift may lose definiteness
    ("posdef", 1.0, 1j, None, None),  # complex shift: not Hermitian
    ("hermitian", 0.0, 1.0, None, None),
    ("general", 0.0, 1.0, None, None),
    ("general", 0.0, 1.0, True, True),  # caller's flags win
    ("general", 0.0, 1.0, True, None),
]


@pytest.mark.parametrize("kind,a0,a1,herm,posdef", SELECT_CASES)
def test_select_alg_matches_jax(kind, a0, a1, herm, posdef):
    rng = np.random.default_rng(12)
    B = rand_mat(rng, n, np.float64)
    A = {"posdef": B @ B.T + np.eye(n), "hermitian": B + B.T, "general": B}[kind]
    kw = dict(maxiter=7, krylovdim=5, orth=None, verbosity=None)
    ja = jls._select_alg(A, a0, a1, herm, posdef, None, 1e-6, **kw)
    ta = tls._select_alg(A, a0, a1, herm, posdef, None, 1e-6, **kw)
    assert type(ta).__name__ == type(ja).__name__
    assert dataclasses.asdict(ta).keys() == dataclasses.asdict(ja).keys()
    assert (ta.tol, ta.maxiter) == (ja.tol, ja.maxiter)
    # a torch matrix is probed like a numpy one
    assert type(tls._select_alg(torch.from_numpy(A), a0, a1, herm, posdef, None, 1e-6, **kw)) is type(ta)


def test_resolve_tol_matches_jax():
    b = rand_vec(np.random.default_rng(13), 50, np.float32)
    for atol, rtol, tol in [(None, None, None), (1e-3, 1e-2, None), (None, 0, None), (1e-9, 1e-9, 0.5)]:
        assert tls._resolve_tol(torch.from_numpy(b), atol, rtol, tol) == jls._resolve_tol(
            jnp.asarray(b), atol, rtol, tol
        )


def test_reallinsolve_rlinear_map_matches_jax():
    rng = np.random.default_rng(9)
    A = rand_mat(rng, n, np.complex128) + 4 * np.eye(n)
    B = 0.1 * rand_mat(rng, n, np.complex128)
    b = rand_vec(rng, n, np.complex128)
    tol = float(precision(np.complex128) * np.linalg.norm(b))
    jA, jB, tA, tB = jnp.asarray(A), jnp.asarray(B), torch.from_numpy(A), torch.from_numpy(B)
    xj, ij = kk.reallinsolve(lambda x: jA @ x + jB @ jnp.conj(x), jnp.asarray(b), tol=tol,
                             krylovdim=2 * n)
    xt, it = kt.reallinsolve(lambda x: tA @ x + tB @ torch.conj(x), torch.from_numpy(b), tol=tol,
                             krylovdim=2 * n)
    _check((xj, ij), (xt, it), tol)
    x = xt.numpy()
    assert np.linalg.norm(b - (A @ x + B @ np.conj(x))) <= 10 * tol


def test_shift_scalars_keep_float32():
    # a Python float or a 0-d float64 tensor shift does not widen float32
    op = kt.laplacian_1d(256, device="cpu")
    x = torch.ones((2, 128))
    assert apply_shifted(op, x, 0.5, 1.0).dtype == torch.float32
    assert apply_shifted(op, x, torch.tensor(0.5, dtype=torch.float64), 1.0).dtype == torch.float32
    assert apply_shifted(op, x, 0.5j, 1.0).dtype == torch.complex64
    xs, info = kt.linsolve(op, x, a0=torch.tensor(0.5, dtype=torch.float64),
                           alg=kt.GMRES(krylovdim=10, tol=1e-3, maxiter=5))
    assert xs.dtype == torch.float32 and info.converged == 1
    xs, _ = kt.linsolve(op, x, a0=0.5, ishermitian=True, isposdef=True,
                        alg=kt.CG(tol=1e-3, maxiter=50))
    assert xs.dtype == torch.float32


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_givens_matches_jax(dtype):
    rng = np.random.default_rng(14)
    pairs = [rand_vec(rng, 2, dtype) for _ in range(4)] + [np.zeros(2, dtype),
                                                            np.array([0, 1], dtype)]
    for a, b in pairs:
        cj, sj, rj = j_givens(jnp.asarray(a), jnp.asarray(b))
        ct, st, rt = t_givens(torch.tensor(a), torch.tensor(b))
        for u, v in ((cj, ct), (sj, st), (rj, rt)):
            np.testing.assert_allclose(v.numpy(), np.asarray(u), rtol=1e-14, atol=1e-15)
        assert not torch.is_complex(ct)


@pytest.mark.parametrize("k", [0, 1, 4, 8])
def test_solve_upper_active_matches_jax(k):
    rng = np.random.default_rng(15)
    R = np.triu(rand_mat(rng, 8, np.complex128)) + 3 * np.eye(8)
    b = rand_vec(rng, 8, np.complex128)
    yj = j_solve_upper_active(jnp.asarray(R), jnp.asarray(b), k)
    yt = t_solve_upper_active(torch.from_numpy(R), torch.from_numpy(b), k)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-13, atol=1e-14)
    assert not torch.any(yt[k:])


# ---------------------------------------------------------------------------
# the fused GMRES cycle (one-stream kernel K1 on a grid spec) and the banded
# operator (K3) inside the solvers
# ---------------------------------------------------------------------------


@pytest.fixture
def _interpret_mode():
    old = jkf.fused_interpret
    jkf.fused_interpret = True
    yield
    jkf.fused_interpret = old


# a grid whose columns are a multiple of 128: the fused path's condition in
# both packages (poisson_2d(32, 32) takes the unfused path)
GX, GY = 32, 128


@pytest.mark.parametrize("a0,krylovdim,maxiter,orth", [
    (0.5, 30, 5, "cgs2"),  # converges in the first cycle
    (0.5, 30, 5, "cgs"),
    (0.0, 30, 4, "cgs2"),  # raw Poisson: the full budget of restarts
    (0.0, 20, 3, "cgs"),
])
def test_fused_gmres_poisson_matches_jax(_interpret_mode, a0, krylovdim, maxiter, orth):
    b = np.ones((GX * GY // 128, 128), np.float32)
    tol = 1e-3  # 1.6e-5 of ‖b‖, clear of the float32 floor of this solve
    jalg = kk.GMRES(krylovdim=krylovdim, tol=tol, maxiter=maxiter, orth=getattr(kk, orth))
    top = kt.poisson_2d(GX, GY, device="cpu")
    assert tkf.fused_available(top, torch.from_numpy(b), kt.STANDARD, kmax=krylovdim + 1)
    jout = kk.linsolve(j_poisson_2d(GX, GY, jnp.float32), jnp.asarray(b), a0=a0, alg=jalg)
    tout = kt.linsolve(top, torch.from_numpy(b), a0=a0, alg=_alg(jalg))
    (xj, ij), (xt, it) = jout, tout
    assert (it.numops, it.numiter, it.converged) == (int(ij.numops), int(ij.numiter), int(ij.converged))
    assert xt.dtype == torch.float32
    xj = np.asarray(xj)
    xtol = 2e-5 if a0 else 2e-4
    np.testing.assert_allclose(xt.numpy(), xj, atol=xtol * np.max(np.abs(xj)))
    np.testing.assert_allclose(float(it.normres), float(ij.normres), rtol=2e-2)


def _poisson_coo(nx, ny, dtype):
    """5-point Poisson COO on an ``nx × ny`` grid: no ±1 couplings across
    grid rows, so ``nnz = 5n − 2(nx + ny)``."""
    i = np.arange(nx * ny)
    iy, ix = i // ny, i % ny
    rows, cols, vals = [i], [i], [np.full(i.size, 4.0, dtype)]
    for mask, d in ((iy > 0, -ny), (ix > 0, -1), (ix < ny - 1, 1), (iy < nx - 1, ny)):
        rows.append(i[mask])
        cols.append(i[mask] + d)
        vals.append(np.full(int(mask.sum()), -1.0, dtype))
    return tuple(np.concatenate(a) for a in (rows, cols, vals))


@pytest.mark.parametrize("jalg", [kk.CG(tol=1e-10, maxiter=400),
                                  kk.GMRES(krylovdim=20, tol=1e-10, maxiter=50)],
                         ids=["cg", "gmres"])
def test_banded_poisson_solves_match_jax(jalg):
    nx = 32
    rows, cols, vals = _poisson_coo(nx, nx, np.float64)
    jop = j_banded_from_coo(rows, cols, vals, nx * nx)
    top = kt.banded_from_coo(rows, cols, vals, nx * nx, device="cpu")
    assert top.nnz == 5 * nx * nx - 4 * nx and top.offsets == jop.offsets
    b = np.ones((nx * nx // 128, 128))
    jout = kk.linsolve(jop, jnp.asarray(b), a0=0.5, alg=jalg)
    tout = kt.linsolve(top, torch.from_numpy(b), a0=0.5, alg=_alg(jalg))
    _check(jout, tout, 1e-10)
    assert tout[1].converged == 1


# ---------------------------------------------------------------------------
# the slice as a whole: chip_smoke.py's small_linsolve phase, through the
# public entry points of both packages
# ---------------------------------------------------------------------------


def test_small_linsolve_phase_matches_jax(_interpret_mode):
    # CG, GMRES(30) and BiCGStab on the banded 64x64 Poisson with a0 = 0.5;
    # MINRES on the indefinite banded 32x32 Poisson with a0 = -0.1.  (On the
    # 64x64 grid with a0 = -0.5 MINRES needs ~300 iterations; its Lanczos
    # vectors lose orthogonality and two correct implementations that round
    # differently finish a few iterations apart: 304 vs 296 operator applies
    # between the two packages at tol 1e-6.)
    for nx, a0, jalg in [(64, 0.5, kk.CG(tol=1e-8, maxiter=300)),
                         (64, 0.5, kk.GMRES(krylovdim=30, tol=1e-8, maxiter=50)),
                         (64, 0.5, kk.BiCGStab(tol=1e-8, maxiter=300)),
                         (32, -0.1, kk.MINRES(tol=1e-8, maxiter=300))]:
        rows, cols, vals = _poisson_coo(nx, nx, np.float64)
        jop = j_banded_from_coo(rows, cols, vals, nx * nx)
        top = kt.banded_from_coo(rows, cols, vals, nx * nx, device="cpu")
        b = np.ones((nx * nx // 128, 128))
        jout = kk.linsolve(jop, jnp.asarray(b), a0=a0, alg=jalg)
        tout = kt.linsolve(top, torch.from_numpy(b), a0=a0, alg=_alg(jalg))
        _check(jout, tout, 1e-8, rtol=1e-9)
        assert tout[1].converged == 1, type(jalg).__name__
    # fused GMRES in float32, on a grid of 128 columns (the fused condition)
    bf = np.ones((64, 128), np.float32)
    jalg = kk.GMRES(krylovdim=30, tol=1e-3, maxiter=20)
    xj, ij = kk.linsolve(j_poisson_2d(64, 128, jnp.float32), jnp.asarray(bf), a0=0.5, alg=jalg)
    xt, it = kt.linsolve(kt.poisson_2d(64, 128, device="cpu"), torch.from_numpy(bf), a0=0.5,
                         alg=_alg(jalg))
    assert it.converged == int(ij.converged) == 1 and it.numiter == int(ij.numiter)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=2e-5 * float(np.max(np.abs(xj))))
