"""PyTorch port, the slice as a whole: the fused float32 Lanczos eigsolve on
``laplacian_1d(4096)`` against the JAX package (its fused kernel in Pallas
interpret mode), from the same numpy start vector and settings.

Tolerances (the JAX package's own fused-vs-unfused test): values rtol 2e-4,
``numops``/``numiter`` equal, normres rtol 0.05 / atol 1e-5, eigenvectors
``|<a, b>|`` within 1e-3 of 1."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import krylovkit_tpu as kk
from krylovkit_tpu.factorizations import krylov as jkf
from krylovkit_tpu.parallel import laplacian_1d as j_laplacian_1d
from krylovkit_tpu.solvers.lanczos import eigsolve_lanczos as j_eigsolve_lanczos
import krylovkit_tpu_torch as kt
from krylovkit_tpu_torch import convert
from krylovkit_tpu_torch.factorizations import krylov as tkf

torch.set_num_threads(2)

N = 1 << 12


@pytest.fixture(autouse=True)
def _interpret_mode():
    old = jkf.fused_interpret
    jkf.fused_interpret = True
    yield
    jkf.fused_interpret = old


def _x0():
    return np.random.default_rng(1).standard_normal((N // 128, 128)).astype(np.float32)


def _solve_both(jalg, entry="eigsolve_lanczos"):
    x0 = _x0()
    talg = convert.lanczos_from_dict(
        {**dataclasses.asdict(jalg), "orth": type(jalg.orth).__name__}
    )
    jop = j_laplacian_1d(N, jnp.float32)
    top = convert.stencil_from_arrays(jop.offsets, jop.coeffs, "cpu")
    xt = convert.vector_from_numpy(x0, "cpu")
    if entry == "eigsolve_lanczos":
        jout = jax.jit(lambda x: j_eigsolve_lanczos(jop, x, 4, "LM", jalg))(jnp.asarray(x0))
        tout = kt.eigsolve_lanczos(top, xt, 4, "LM", talg)
    else:
        jout = kk.eigsolve(jop, jnp.asarray(x0), 4, "LM", ishermitian=True, alg=jalg)
        tout = kt.eigsolve(top, xt, 4, "LM", ishermitian=True, alg=talg)
    assert tkf.fused_available(top, xt, kt.STANDARD, kmax=jalg.krylovdim + 1)
    return jout, tout


def _check(jout, tout):
    (vj, ej, ij), (vt, et, it) = jout, tout
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=2e-4)
    assert it.numops == int(ij.numops)
    assert it.numiter == int(ij.numiter)
    assert it.converged == int(ij.converged)
    np.testing.assert_allclose(it.normres.numpy(), np.asarray(ij.normres), rtol=0.05, atol=1e-5)
    assert tuple(et.shape) == tuple(ej.shape)
    for a, b in zip(np.asarray(ej), et.numpy()):
        np.testing.assert_allclose(abs(float(np.vdot(a, b))), 1.0, atol=1e-3)
    assert tuple(it.residual.shape) == tuple(np.shape(ij.residual))


@pytest.mark.parametrize("maxiter", [1, 6])
def test_fused_dgks_default_matches_jax(maxiter):
    # default kwargs: orth = cgs2 → the fused one-reduce DGKS path
    jout, tout = _solve_both(kk.Lanczos(krylovdim=30, maxiter=maxiter))
    _check(jout, tout)


def test_fused_single_sweep_cgs_matches_jax():
    jout, tout = _solve_both(kk.Lanczos(krylovdim=30, maxiter=6, orth=kk.cgs))
    _check(jout, tout)


def test_eigsolve_front_end_matches_jax():
    jout, tout = _solve_both(kk.Lanczos(krylovdim=30, maxiter=3), entry="eigsolve")
    _check(jout, tout)


def test_fused_converged_eigenpairs_are_eigenpairs():
    # a spread spectrum converges: |A v - λ v| small and ‖v‖ = 1 on the port
    n = 2048
    op = kt.StencilOperator((-1, 0, 1), (-1.0, 2.0, -1.0))
    x0 = torch.from_numpy(np.random.default_rng(2).standard_normal((n // 128, 128)).astype(np.float32))
    alg = kt.Lanczos(krylovdim=20, maxiter=30, tol=5e-3, orth=kt.cgs)
    vals, vecs, info = kt.eigsolve_lanczos(op, x0, 4, "LM", alg)
    assert info.converged >= 2
    for i in range(info.converged):
        v = vecs[i]
        np.testing.assert_allclose(float(torch.linalg.vector_norm(v)), 1.0, rtol=1e-4)
        assert float(torch.linalg.vector_norm(op.normal(v) - vals[i] * v)) < 2e-2
