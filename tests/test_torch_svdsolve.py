"""PyTorch port: ``svdsolve`` / ``realsvdsolve`` against the JAX package on
the same numpy inputs, and against ``np.linalg.svd``.

Singular vectors are held to invariants (``A v = σ u``, orthonormality) and
to ``|<u_jax, u_port>| ≈ 1``, not to entries: the projected SVD's signs and
the order inside a cluster are free.  Float64 values agree to 1e-10, float32
and the fused solves to 5e-4 relative (the JAX package's own
fused-against-unfused tolerance); ``numops``, ``numiter`` and ``converged``
are equal."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import krylovkit_tpu as kk
from krylovkit_tpu.factorizations import krylov as jkf
from krylovkit_tpu.solvers.svdsolve import _svdsolve_core as j_core
import krylovkit_tpu_torch as kt
from krylovkit_tpu_torch import convert
from krylovkit_tpu_torch.solvers import svdsolve as tsvd
from testsetup import DTYPES, N, n, precision, rand_mat, rand_vec

torch.set_num_threads(2)

CHAIN = ((-2, 0, 1), (0.4, 1.0, -0.8))
GRID = ((32, 128), ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)), (4.0, -1.5, -0.5, -1.2, -0.8))


def counts(info):
    return int(info.numops), int(info.numiter), int(info.converged)


def both(A, x0, howmany, which, **kw):
    vj, lj, rj, ij = kk.svdsolve(jnp.asarray(A), jnp.asarray(x0), howmany, which, **kw)
    vt, lt, rt, it = kt.svdsolve(torch.from_numpy(A), torch.from_numpy(x0), howmany, which, **kw)
    return (np.asarray(vj), np.asarray(lj), np.asarray(rj), ij), (vt.numpy(), lt.numpy(), rt.numpy(), it)


def aligned(a, b, tol):
    """Rows of ``a`` and ``b`` agree up to a phase."""
    for x, y in zip(a, b):
        assert abs(abs(np.vdot(x, y)) - 1.0) <= tol


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


@pytest.mark.parametrize("dtype", DTYPES)
def test_svd_full_square(dtype):
    rng = np.random.default_rng(11)
    A, x0 = rand_mat(rng, n, n, dtype), rand_vec(rng, n, dtype)
    tol = precision(dtype)
    (vj, _, _, ij), (vt, lt, rt, it) = both(A, x0, n, "LR", krylovdim=n, tol=tol)
    want = np.linalg.svd(A, compute_uv=False)
    assert np.allclose(vt, want, atol=10 * tol)
    np.testing.assert_allclose(vt, vj, atol=10 * np.finfo(dtype).eps * want[0])
    assert counts(it) == counts(ij)
    assert np.linalg.norm(A @ rt.T - lt.T * vt) <= 20 * tol * max(want)
    assert lt.dtype == rt.dtype == np.dtype(dtype) and vt.dtype == np.finfo(dtype).dtype


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("which", ["LR", "SR"])
def test_svd_rectangular(dtype, which):
    rng = np.random.default_rng(12)
    A = rand_mat(rng, 2 * n, n, dtype)
    x0 = A @ rand_vec(rng, n, dtype)  # in range(A): see the solver's _default_x0
    tol = precision(dtype)
    (vj, lj, rj, ij), (vt, lt, rt, it) = both(A, x0, 4, which, krylovdim=15, tol=tol, maxiter=100)
    want = np.sort(np.linalg.svd(A, compute_uv=False))
    want = want[::-1] if which == "LR" else want
    assert it.converged >= 4 and counts(it) == counts(ij)
    assert np.allclose(vt, want[:4], atol=50 * tol)
    np.testing.assert_allclose(vt, vj, atol=1e-10)
    aligned(lt, lj, 1e-8)
    aligned(rt, rj, 1e-8)
    # the Krylov dimension was capped at the domain dimension
    assert tuple(it.residual.shape) == (4, 2 * n)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_svd_iterative_restarts(dtype):
    rng = np.random.default_rng(13)
    A, x0 = rand_mat(rng, 2 * N, N, dtype), rand_vec(rng, 2 * N, dtype)
    tol = precision(dtype)
    (vj, lj, rj, ij), (vt, lt, rt, it) = both(A, x0, 4, "LR", krylovdim=25, tol=tol, maxiter=100)
    want = np.linalg.svd(A, compute_uv=False)[:4]
    assert it.converged >= 4 and it.numiter > 1 and counts(it) == counts(ij)
    assert np.allclose(vt, want, atol=100 * tol)
    np.testing.assert_allclose(vt, vj, atol=1e-10)
    np.testing.assert_allclose(it.normres.numpy(), np.asarray(ij.normres), atol=1e-10)
    U, V = lt.T, rt.T
    assert np.linalg.norm(U.conj().T @ U - np.eye(4)) <= 1e-6
    assert np.linalg.norm(V.conj().T @ V - np.eye(4)) <= 1e-6
    assert np.linalg.norm(A @ V - U * vt) <= 100 * tol
    aligned(lt, lj, 1e-8)
    aligned(rt, rj, 1e-8)
    # info.residual is A ṽ_i − σ_i ũ_i
    np.testing.assert_allclose(it.residual.numpy(), (A @ V - U * vt).T, atol=1e-9)


@pytest.mark.parametrize("orth", ["cgs", "mgs", "cgs2", "mgs2", "cgsir", "mgsir"])
@pytest.mark.parametrize("eager", [False, True])
def test_svd_all_orthogonalizers_match_jax(orth, eager):
    rng = np.random.default_rng(16)
    A, x0 = rand_mat(rng, 80, 50, np.float64), rand_vec(rng, 80, np.float64)
    kw = dict(krylovdim=16, tol=1e-9, maxiter=60, eager=eager)
    vj, _, _, ij = kk.svdsolve(jnp.asarray(A), jnp.asarray(x0), 3, "LR", orth=getattr(kk, orth), **kw)
    vt, lt, rt, it = kt.svdsolve(torch.from_numpy(A), torch.from_numpy(x0), 3, "LR",
                                 orth=getattr(kt, orth), **kw)
    assert it.converged >= 3 and counts(it) == counts(ij)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-10)
    np.testing.assert_allclose(vt.numpy(), np.linalg.svd(A, compute_uv=False)[:3], atol=1e-8)


def test_svd_tuple_operator():
    """(f, fadjoint) operator encoding (reference src/apply.jl:14-19)."""
    rng = np.random.default_rng(14)
    A, x0 = rand_mat(rng, 2 * n, n, np.complex128), rand_vec(rng, 2 * n, np.complex128)
    Aj, At = jnp.asarray(A), torch.from_numpy(A)
    kw = dict(howmany=3, which="LR", krylovdim=15, tol=precision(np.complex128), maxiter=60)
    vj, _, _, ij = kk.svdsolve((lambda x: Aj @ x, lambda y: Aj.conj().T @ y), jnp.asarray(x0), **kw)
    vt, _, _, it = kt.svdsolve((lambda x: At @ x, lambda y: At.conj().T @ y), torch.from_numpy(x0), **kw)
    assert np.allclose(vt.numpy(), np.linalg.svd(A, compute_uv=False)[:3], atol=100 * kw["tol"])
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-10)
    assert counts(it) == counts(ij)


def test_svd_default_x0_and_which_validation():
    rng = np.random.default_rng(15)
    A = rand_mat(rng, n, n, np.float64)
    vj, _, _, ij = kk.svdsolve(A, howmany=2, krylovdim=n, tol=1e-10)
    vt, _, _, it = kt.svdsolve(torch.from_numpy(A), howmany=2, krylovdim=n, tol=1e-10)
    assert np.allclose(vt.numpy(), np.linalg.svd(A, compute_uv=False)[:2], atol=1e-8)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-10)
    assert counts(it) == counts(ij)
    with pytest.raises(ValueError):
        kt.svdsolve(torch.from_numpy(A), howmany=1, which="LM")
    with pytest.raises(ValueError, match="exceeds krylovdim"):
        kt.svdsolve(torch.from_numpy(A), howmany=6, krylovdim=4)
    with pytest.raises(ValueError, match="x0 is required"):
        kt.svdsolve(kt.as_operator(torch.from_numpy(A)))


def test_gkl_adjoint_compatibility_check():
    """Inconsistent (f, fadjoint) pairs are rejected at the start (reference
    src/factorizations/gkl.jl:192); a bare callable gets a derived adjoint."""
    rng = np.random.default_rng(300)
    A, Bm = torch.from_numpy(rng.standard_normal((20, 20))), torch.from_numpy(rng.standard_normal((20, 20)))
    x0 = torch.from_numpy(rng.standard_normal(20))
    with pytest.raises(ValueError, match="not compatible"):
        kt.svdsolve((lambda x: A @ x, lambda y: Bm.T @ y), x0, 2, "LR")
    with pytest.raises(ValueError, match="not compatible"):
        kt.lssolve((lambda x: A @ x, lambda y: Bm.T @ y), x0)
    s, _, _, info = kt.svdsolve((lambda x: A @ x, lambda y: A.T @ y), x0, 2, "LR", tol=1e-10)
    assert np.allclose(s.numpy(), np.linalg.svd(A.numpy(), compute_uv=False)[:2], atol=1e-8)
    # a bare callable gets its adjoint derived by with_adjoint_from, unchecked,
    # and solves as the matrix does
    s2, _, _, info2 = kt.svdsolve(lambda x: A @ x, x0, 2, "LR", tol=1e-10)
    sm, _, _, infom = kt.svdsolve(A, x0, 2, "LR", tol=1e-10)
    assert np.allclose(s2.numpy(), sm.numpy(), atol=1e-12)
    assert (info2.numops, info2.numiter) == (infom.numops, infom.numiter)
    xc, _ = kt.lssolve(lambda x: A @ x, x0, tol=1e-10)
    xm, _ = kt.lssolve(A, x0, tol=1e-10)
    assert np.allclose(xc.numpy(), xm.numpy(), atol=1e-10)


def test_svdsolve_numops_full_scale():
    """Square full-rank 10×10 map: GKL exhausts the domain at k = 10."""
    rng = np.random.default_rng(0)
    R, x0 = rng.standard_normal((10, 10)), rng.standard_normal(10)
    (vj, _, _, ij), (vt, _, _, it) = both(R, x0, 2, "LR", krylovdim=20, tol=1e-12)
    assert it.converged >= 2 and counts(it)[:2] == (20, 1) and counts(it) == counts(ij)


def test_svdsolve_numops_iterative_scale():
    """200×100 map, krylovdim 30: numops == 2·[30 + (numiter−1)·(30 − 18)]."""
    rng = np.random.default_rng(0)
    rng.standard_normal((100, 100))
    rng.standard_normal(100)
    R, x0 = rng.standard_normal((200, 100)), rng.standard_normal(200)
    (vj, _, _, ij), (vt, _, _, it) = both(R, x0, 2, "LR", krylovdim=30, maxiter=100, tol=1e-12)
    assert it.converged >= 2 and counts(it)[:2] == (108, 3) and counts(it) == counts(ij)
    np.testing.assert_allclose(vt, vj, atol=1e-10)


def test_svdsolve_not_converged_warns_and_counts(capsys):
    rng = np.random.default_rng(17)
    A, x0 = rand_mat(rng, 120, 90, np.float64), rand_vec(rng, 120, np.float64)
    (vj, _, _, ij), (vt, _, _, it) = both(A, x0, 5, "SR", krylovdim=12, maxiter=2, tol=1e-12,
                                          verbosity=1)
    assert counts(it) == counts(ij) and it.numiter == 2 and it.converged < 5
    assert "GKL svdsolve finished without convergence" in capsys.readouterr().out
    np.testing.assert_allclose(vt, vj, atol=1e-9)


def test_realsvdsolve_matches_jax_and_refuses_rlinear_pairs():
    """Over the real inner product a complex matrix is a real 2n×2n map whose
    singular values come in pairs, of which a single-vector Krylov method
    finds one each.  The adjoint guard of an ``(f, fadjoint)`` pair runs in
    the standard (complex) inner product in both packages, so an R-linear
    pair x ↦ A x + B conj(x) with its real adjoint is refused by both, while
    the same guard in the real inner product accepts it."""
    rng = np.random.default_rng(18)
    A = rand_mat(rng, n, n, np.complex128) + 3 * np.eye(n)
    x0 = rand_vec(rng, n, np.complex128)
    kw = dict(krylovdim=2 * n, tol=1e-10)
    vj, _, _, ij = kk.realsvdsolve(jnp.asarray(A), jnp.asarray(x0), 3, "LR", **kw)
    vt, lt, rt, it = kt.realsvdsolve(torch.from_numpy(A), torch.from_numpy(x0), 3, "LR", **kw)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-10)
    assert counts(it) == counts(ij)
    np.testing.assert_allclose(vt.numpy(), np.linalg.svd(A, compute_uv=False)[:3], atol=1e-8)

    Bm = 0.2 * rand_mat(rng, n, n, np.complex128)
    Aj, Bj, At, Bt = jnp.asarray(A), jnp.asarray(Bm), torch.from_numpy(A), torch.from_numpy(Bm)
    jpair = (lambda x: Aj @ x + Bj @ jnp.conj(x), lambda y: Aj.conj().T @ y + Bj.T @ jnp.conj(y))
    tpair = (lambda x: At @ x + Bt @ torch.conj(x), lambda y: At.conj().T @ y + Bt.T @ torch.conj(y))
    with pytest.raises(ValueError, match="not compatible"):
        kk.realsvdsolve(jpair, jnp.asarray(x0), 3, "LR", **kw)
    with pytest.raises(ValueError, match="not compatible"):
        kt.realsvdsolve(tpair, torch.from_numpy(x0), 3, "LR", **kw)
    from krylovkit_tpu_torch.ops.operator import check_adjoint_compatibility
    from krylovkit_tpu_torch.ops.vector import REAL
    check_adjoint_compatibility(kt.as_operator(tpair), torch.from_numpy(x0), REAL)


def test_svdsolve_alg_object_and_tol_override():
    rng = np.random.default_rng(19)
    A, x0 = rand_mat(rng, 60, 40, np.float64), rand_vec(rng, 60, np.float64)
    jalg = kk.GKL(krylovdim=14, tol=1e-3, maxiter=50)
    talg = convert.gkl_from_dict({**dataclasses.asdict(jalg), "orth": type(jalg.orth).__name__})
    vj, _, _, ij = kk.svdsolve(jnp.asarray(A), jnp.asarray(x0), 2, "LR", alg=jalg, tol=1e-9)
    vt, _, _, it = kt.svdsolve(torch.from_numpy(A), torch.from_numpy(x0), 2, "LR", alg=talg, tol=1e-9)
    assert counts(it) == counts(ij)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-10)
    np.testing.assert_allclose(it.normres.numpy(), np.asarray(ij.normres), atol=1e-10)


def test_restart_gated_off_is_identity():
    rng = np.random.default_rng(20)
    A, x0 = rand_mat(rng, 30, 20, np.float64), rand_vec(rng, 30, np.float64)
    op = kt.as_operator(torch.from_numpy(A))
    from krylovkit_tpu_torch.factorizations import gkl as tgf

    st = tgf.initialize(op, torch.from_numpy(x0), 8, torch.float64)
    for _ in range(8):
        st = tgf.expand(op, st, kt.cgs2)
    nconv, s, P, Q, res = tsvd._process(st.B, st.k, st.beta, "LR", 1e-12)
    U0, V0, B0 = st.U.clone(), st.V.clone(), st.B.clone()
    off = tsvd._restart(st, s, P, Q, st.beta, 4, 5, gate=False)
    assert off.k == 8
    np.testing.assert_array_equal(off.U.numpy(), U0.numpy())
    np.testing.assert_array_equal(off.V.numpy(), V0.numpy())
    np.testing.assert_array_equal(off.B.numpy(), B0.numpy())
    on_ = tsvd._restart(st, s, P, Q, st.beta, 4, 5, gate=True)
    assert on_.k == 4
    # broken arrow: A Ṽ = Ũ Σ + β u_k Q[k-1, :]
    Ut, Vt, Bn = on_.U.numpy(), on_.V.numpy(), on_.B.numpy()
    np.testing.assert_allclose(A @ Vt[:4].T, Ut[:5].T @ Bn[:5, :4], atol=1e-10)
    np.testing.assert_allclose(A.T @ Ut[:4].T, Vt[:4].T @ Bn[:4, :4].T, atol=1e-10)


# --------------------------------------------------------------------------
# The fused one-stream GKL (square float32 stencils)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("maxiter", [1, 5])
@pytest.mark.parametrize("orth", ["cgs", "cgs2"])
def test_fused_gkl_chain_matches_jax(interpret_mode, maxiter, orth):
    x = np.random.default_rng(51).standard_normal((32, 128)).astype(np.float32)
    jop, top = kk.StencilOperator(*CHAIN), convert.stencil_from_arrays(*CHAIN, device="cpu")
    kw = dict(krylovdim=18, maxiter=maxiter, tol=1e-6)
    vj, lj, rj, ij = kk.svdsolve(jop, jnp.asarray(x), 4, "LR", orth=getattr(kk, orth), **kw)
    vt, lt, rt, it = kt.svdsolve(top, torch.from_numpy(x), 4, "LR", orth=getattr(kt, orth), **kw)
    assert counts(it) == counts(ij)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-5)
    aligned(lt.numpy(), np.asarray(lj).reshape(4, -1).reshape(lt.shape), 2e-3)
    aligned(rt.numpy(), np.asarray(rj), 2e-3)
    # ... and the port's own unfused solve (mgs2: the fused gate refuses it)
    vu, lu, ru, iu = kt.svdsolve(top, torch.from_numpy(x), 4, "LR", orth=kt.mgs2, **kw)
    np.testing.assert_allclose(vt.numpy(), vu.numpy(), rtol=5e-4)
    assert (iu.numops, iu.numiter) == (it.numops, it.numiter)
    aligned(lt.numpy(), lu.numpy(), 2e-3)
    aligned(rt.numpy(), ru.numpy(), 2e-3)


def test_fused_gkl_grid_and_triplet_quality(interpret_mode):
    x = np.random.default_rng(52).standard_normal((32, 128)).astype(np.float32)
    jop, top = kk.GridStencilOperator(*GRID), convert.grid_stencil_from_arrays(*GRID, device="cpu")
    kw = dict(krylovdim=20, maxiter=25, tol=1e-3)
    vj, _, _, ij = kk.svdsolve(jop, jnp.asarray(x), 4, "LR", **kw)
    vt, lt, rt, it = kt.svdsolve(top, torch.from_numpy(x), 4, "LR", **kw)
    assert it.converged >= 2 and counts(it) == counts(ij)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=5e-5)
    for i in range(it.converged):
        u, v = lt[i], rt[i]
        np.testing.assert_allclose(float(torch.linalg.norm(u)), 1.0, rtol=1e-3)
        np.testing.assert_allclose(float(torch.linalg.norm(v)), 1.0, rtol=1e-3)
        assert float(torch.linalg.norm(top.normal(v) - vt[i] * u)) < 5e-3 * float(vt[0])
        assert float(torch.linalg.norm(top.adjoint(u) - vt[i] * v)) < 5e-3 * float(vt[0])
    assert float(vt[0]) <= 8.0  # ‖A‖ <= Σ|coeffs|


def test_unfused_paths_of_a_stencil_match_jax():
    """Eager mode and float64 vectors keep a stencil on the unfused path."""
    jop, top = kk.StencilOperator(*CHAIN), convert.stencil_from_arrays(*CHAIN, device="cpu")
    x = np.random.default_rng(54).standard_normal((16, 128))
    kw = dict(krylovdim=14, maxiter=8, tol=1e-8)
    vj, _, _, ij = kk.svdsolve(jop, jnp.asarray(x), 2, "LR", **kw)
    vt, _, _, it = kt.svdsolve(top, torch.from_numpy(x), 2, "LR", **kw)
    assert counts(it) == counts(ij)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-10)


def test_svd_complex_map_with_real_start_promotes():
    """A complex matrix and a real float64 start: the port's bases take the
    map's type and the singular values are ``numpy.linalg.svd``'s, with the
    counts of the same solve from a complex start.  Deviation: the JAX
    package keeps the start's type, drops the imaginary part of ``Aᴴ u`` and
    returns other values (its GKL is frozen)."""
    r = np.random.default_rng(0)
    A = r.standard_normal((100, 100)) + 1j * r.standard_normal((100, 100))
    x0 = np.random.default_rng(0).standard_normal(100)
    want = np.linalg.svd(A, compute_uv=False)[:3]
    S, U, V, info = kt.svdsolve(torch.from_numpy(A), torch.from_numpy(x0), 3, "LR", tol=1e-10)
    np.testing.assert_allclose(S.numpy(), want, rtol=1e-12)
    assert U.dtype == V.dtype == torch.complex128 and info.converged == 3
    res = A @ V.numpy().T - U.numpy().T * S.numpy()
    assert np.linalg.norm(res) < 1e-10
    Sc, _, _, ic = kt.svdsolve(torch.from_numpy(A), torch.from_numpy(x0.astype(complex)), 3, "LR",
                               tol=1e-10)
    Sj, _, _, ij = kk.svdsolve(jnp.asarray(A), jnp.asarray(x0.astype(complex)), 3, "LR", tol=1e-10)
    np.testing.assert_allclose(S.numpy(), np.asarray(Sj), rtol=1e-12)
    assert (info.numops, info.numiter) == (ic.numops, ic.numiter) == (
        int(ij.numops), int(ij.numiter))
    Sr, _, _, _ = kk.svdsolve(jnp.asarray(A), jnp.asarray(x0), 3, "LR", tol=1e-10)
    assert np.max(np.abs(np.asarray(Sr) - want)) > 1.0
