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


def _count_sweeps(module, counts):
    """Wrap ``module.expand_hermitian_selective`` so each call appends its
    ``swept`` flag to ``counts``; returns the original."""
    orig = module.expand_hermitian_selective

    def wrapped(*a, **kw):
        out = orig(*a, **kw)
        if module is jkf:
            # traced inside the solver's jitted loop: report at run time
            jax.debug.callback(lambda s: counts.append(bool(s)), out[3])
        else:
            counts.append(out[3])
        return out

    module.expand_hermitian_selective = wrapped
    return orig


def test_selective_reorthogonalization_matches_jax():
    """``Lanczos(reorth="selective")`` (``tests/test_modes.py``'s case):
    values within 1e-10 of the JAX package's, counts and the sequence of
    drift sweeps equal, and the JAX test's own checks."""
    rng = np.random.default_rng(116)
    m = 200
    A = rng.standard_normal((m, m)) / np.sqrt(m)
    A = (A + A.T) / 2
    x0 = rng.standard_normal(m)
    jalg = kk.Lanczos(krylovdim=30, tol=1e-10, maxiter=60, reorth="selective")
    talg = convert.lanczos_from_dict({**dataclasses.asdict(jalg), "orth": "cgs2"})
    assert talg.reorth == "selective"
    sj, st = [], []
    jax.clear_caches()  # the wrapper must be traced into the jitted driver
    oj, ot = _count_sweeps(jkf, sj), _count_sweeps(tkf, st)
    try:
        vj, _, ij = kk.eigsolve(jnp.asarray(A), jnp.asarray(x0), 4, "LR", ishermitian=True,
                                alg=jalg)
        jax.effects_barrier()
        vt, et, it = kt.eigsolve(torch.from_numpy(A), torch.from_numpy(x0), 4, "LR",
                                 ishermitian=True, alg=talg)
    finally:
        jkf.expand_hermitian_selective, tkf.expand_hermitian_selective = oj, ot
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0, atol=1e-10)
    assert (it.numops, it.numiter, it.converged) == (
        int(ij.numops), int(ij.numiter), int(ij.converged))
    assert len(st) == it.numops and sorted(sj) == sorted(st) and sum(sj) == sum(st)
    assert it.converged >= 4
    np.testing.assert_allclose(vt.numpy(), np.linalg.eigvalsh(A)[::-1][:4], atol=1e-8)
    V = et.numpy()
    assert np.max(np.abs(V @ V.conj().T - np.eye(4))) < 1e-7
    # the full-reorthogonalization solve finds the same values
    vf, _, _ = kt.eigsolve(torch.from_numpy(A), torch.from_numpy(x0), 4, "LR", ishermitian=True,
                           alg=kt.Lanczos(krylovdim=30, tol=1e-10, maxiter=60))
    np.testing.assert_allclose(vt.numpy(), vf.numpy(), atol=1e-10)


def test_selective_step_matches_jax_step():
    """One ``expand_hermitian_selective`` step at a time, from the same
    factorization and ω vectors: the new ω, the sweep decision and the
    Lanczos column agree with the JAX package's, forced sweep included."""
    rng = np.random.default_rng(117)
    m, kd = 40, 12
    A = rng.standard_normal((m, m)) / np.sqrt(m)
    A = (A + A.T) / 2
    x0 = rng.standard_normal(m)
    sj = jkf.initialize(jnp.asarray(x0), kd, jnp.float64)
    st = tkf.initialize(torch.from_numpy(x0), kd, torch.float64)
    eps = np.finfo(np.float64).eps
    omj = ompj = jnp.full((kd + 1,), eps)
    omt = ompt = torch.full((kd + 1,), eps, dtype=torch.float64)
    Aj, At = jnp.asarray(A), torch.from_numpy(A)
    # the JAX step compiled once per force flag (op by op each call compiles
    # its loops anew)
    jstep = jax.jit(lambda s, o, op_, force: jkf.expand_hermitian_selective(
        lambda v: Aj @ v, s, o, op_, kk.cgs2, force_sweep=force), static_argnums=3)
    swept = []
    for k in range(kd - 1):
        force = k == 5
        sj, omj, ompj, swj = jstep(sj, omj, ompj, force)
        st, omt, ompt, swt = tkf.expand_hermitian_selective(
            lambda v: At @ v, st, omt, ompt, kt.cgs2, force_sweep=force)
        assert bool(swj) == swt
        swept.append(swt)
        np.testing.assert_allclose(omt.numpy(), np.asarray(omj), rtol=1e-9, atol=1e-300)
        np.testing.assert_allclose(ompt.numpy(), np.asarray(ompj), rtol=1e-9, atol=1e-300)
        np.testing.assert_allclose(st.H.numpy(), np.asarray(sj.H), atol=1e-12)
        assert st.k == int(sj.k)
    assert swept[5] and not swept[0]  # the forced sweep; no estimate before step 1


def test_selective_refuses_eager():
    A = torch.from_numpy(np.random.default_rng(6).standard_normal((20, 20)))
    with pytest.raises(ValueError, match="incompatible with eager=True"):
        kt.eigsolve(A + A.T, torch.ones(20, dtype=torch.float64), 2,
                    alg=kt.Lanczos(reorth="selective", eager=True))


def test_complex_hermitian_with_real_start_matches_eigvalsh():
    """A complex Hermitian matrix and a real float64 ``x0``: the port
    promotes ``x0`` to the operator's type and finds ``eigvalsh``'s values.
    Deviation: the JAX package keeps ``x0``'s type, drops the imaginary part
    of ``A v`` and returns other values (its Lanczos is frozen); given a
    complex ``x0`` it is right, and the port matches that solve."""
    r = np.random.default_rng(0)
    A = r.standard_normal((100, 100)) + 1j * r.standard_normal((100, 100))
    H = A + A.conj().T
    x0 = np.random.default_rng(0).standard_normal(100)
    want = np.linalg.eigvalsh(H)[:3]
    vt, et, it = kt.eigsolve(torch.from_numpy(H), torch.from_numpy(x0), 3, "SR", tol=1e-10)
    np.testing.assert_allclose(vt.numpy(), want, rtol=0, atol=1e-8)
    assert et.dtype == torch.complex128 and it.converged == 3
    for i in range(3):
        v = et[i].numpy()
        assert np.linalg.norm(H @ v - vt[i].item() * v) < 1e-7
    vj, _, ij = kk.eigsolve(jnp.asarray(H), jnp.asarray(x0.astype(complex)), 3, "SR", tol=1e-10)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0, atol=1e-10)
    assert (it.numops, it.numiter, it.converged) == (
        int(ij.numops), int(ij.numiter), int(ij.converged))
    # the JAX package given the real x0 (the deviation)
    vr, _, _ = kk.eigsolve(jnp.asarray(H), jnp.asarray(x0), 3, "SR", tol=1e-10)
    assert np.max(np.abs(np.asarray(vr) - want)) > 1.0
