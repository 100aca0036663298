"""PyTorch port: the Krylov-Schur Arnoldi solvers (``schursolve``, the
non-Hermitian ``eigsolve``, ``realeigsolve``) against the JAX package on the
same numpy inputs, and against ``np.linalg.eigvals``.

Schur and eigenvectors are held to invariants and to ``|<v_jax, v_port>| ≈
1`` (QR sign conventions are free); values, residual norms and the counts
(``numops``, ``numiter``, ``converged``) to the JAX package's.  Float64
values agree to 1e-9; the float32 fused solves to 2e-4, the tolerance of the
JAX package's own fused-against-unfused test."""

import contextlib
import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import krylovkit_tpu as kk
from krylovkit_tpu.factorizations import krylov as jkf
from krylovkit_tpu.ops.pallas_spmv import banded_from_coo as j_banded_from_coo
import krylovkit_tpu_torch as kt
from krylovkit_tpu_torch import convert
from krylovkit_tpu_torch.factorizations import krylov as tkf
from krylovkit_tpu_torch.ops import basis as tbs
from krylovkit_tpu_torch.ops import projections as tpb
from krylovkit_tpu_torch.solvers import arnoldi as tarn

torch.set_num_threads(2)

NONSYM = ((-1, 0, 1), (-1.3, 2.0, -0.7))  # transport-diffusion stencil


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


def sortsel(w, which, hm):
    key = {"LM": -np.abs(w), "LR": -np.real(w), "SR": np.real(w), "LI": -np.imag(w),
           "SI": np.imag(w)}[which]
    return w[np.argsort(key, kind="stable")][:hm]


def match(got, want, tol):
    """Permutation-tolerant eigenvalue comparison (greedy nearest matching)."""
    got = np.asarray(got, complex).copy()
    want = np.asarray(want, complex)
    assert got.shape == want.shape
    atol = tol * max(1.0, float(np.max(np.abs(want))))
    for w in want:
        i = int(np.argmin(np.abs(got - w)))
        assert abs(got[i] - w) <= atol, (got, want)
        got[i] = np.inf


def counts(info):
    return int(info.numops), int(info.numiter), int(info.converged)


def talg(jalg):
    """The port's Arnoldi with the fields of the JAX package's."""
    return convert.arnoldi_from_dict(
        {**dataclasses.asdict(jalg), "orth": type(jalg.orth).__name__})


@pytest.fixture
def interpret_mode():
    old = jkf.fused_interpret
    jkf.fused_interpret = True
    try:
        yield
    finally:
        jkf.fused_interpret = old


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex64, np.complex128])
@pytest.mark.parametrize("which", ["LM", "LR", "SR"])
def test_arnoldi_full_matches_jax(dtype, which):
    # krylovdim = n: converges in one iteration
    n = 10
    rng = np.random.default_rng(4)
    A, x0 = rand_mat(rng, n, dtype), rand_vec(rng, n, dtype)
    prec = np.finfo(dtype).eps ** (2 / 3)
    kw = dict(howmany=2, which=which, ishermitian=False, krylovdim=n, tol=prec / 10)
    vj, _, ij = kk.eigsolve(jnp.asarray(A), jnp.asarray(x0), **kw)
    op, xt = convert.eig_problem_from_numpy(A, x0, "cpu")
    vt, et, it = kt.eigsolve(op, xt, **kw)
    assert vt.dtype == torch.promote_types(xt.dtype, torch.complex64)
    assert it.converged >= 2 and counts(it) == counts(ij)
    w = np.linalg.eigvals(A.astype(np.complex128))
    match(vt.numpy(), sortsel(w, which, 2), 10 * prec)
    match(vt.numpy(), np.asarray(vj), 10 * prec)
    for i in range(2):
        v = et[i].numpy()
        assert np.linalg.norm(A @ v - vt[i].numpy() * v) < 100 * prec


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("orth", ["cgs", "mgs", "cgs2", "mgs2", "cgsir", "mgsir"])
def test_arnoldi_iterative_all_orthogonalizers_match_jax(dtype, orth):
    N = 100
    rng = np.random.default_rng(5)
    A = rand_mat(rng, N, dtype) * np.sqrt(N)
    x0 = rand_vec(rng, N, dtype)
    jalg = kk.Arnoldi(krylovdim=25, maxiter=300, tol=1e-10, orth=getattr(kk, orth))
    vj, ej, ij = kk.eigsolve(jnp.asarray(A), jnp.asarray(x0), 3, "LM", ishermitian=False, alg=jalg)
    op, xt = convert.eig_problem_from_numpy(A, x0, "cpu")
    vt, et, it = kt.eigsolve(op, xt, 3, "LM", ishermitian=False, alg=talg(jalg))
    assert it.converged == 3 and counts(it) == counts(ij)
    w = np.linalg.eigvals(A)
    got = vt.numpy()
    for v in got:
        assert np.min(np.abs(w - v)) < 1e-8
    np.testing.assert_allclose(np.abs(got), np.abs(sortsel(w, "LM", 3)), atol=1e-8)
    np.testing.assert_allclose(got, np.asarray(vj), atol=1e-9)
    np.testing.assert_allclose(it.normres.numpy(), np.asarray(ij.normres), atol=1e-10)
    for i in range(3):
        v = et[i].numpy()
        assert np.linalg.norm(A @ v - got[i] * v) < 1e-8
        assert abs(np.linalg.norm(v) - 1) < 1e-10
        np.testing.assert_allclose(abs(np.vdot(np.asarray(ej[i]), v)), 1.0, atol=1e-8)
    assert tuple(it.residual.shape) == (3, N)


@pytest.mark.parametrize("which", ["LI", "SI"])
def test_arnoldi_which_imaginary(which):
    rng = np.random.default_rng(6)
    A = rand_mat(rng, 30, np.complex128) * 4
    x0 = rand_vec(rng, 30, np.complex128)
    kw = dict(howmany=2, which=which, ishermitian=False, krylovdim=20, maxiter=300, tol=1e-10)
    vj, _, ij = kk.eigsolve(jnp.asarray(A), jnp.asarray(x0), **kw)
    vt, _, it = kt.eigsolve(torch.from_numpy(A), torch.from_numpy(x0), **kw)
    match(vt.numpy(), sortsel(np.linalg.eigvals(A), which, 2), 1e-8)
    match(vt.numpy(), np.asarray(vj), 1e-8)
    assert counts(it) == counts(ij)


def test_arnoldi_eigsorter():
    rng = np.random.default_rng(7)
    A = rand_mat(rng, 40, np.float64) * 4
    x0 = rand_vec(rng, 40, np.float64)
    kw = dict(howmany=2, ishermitian=False, krylovdim=15, maxiter=100, tol=1e-10)
    # largest real part first, through a callback on the complex values
    vj, _, ij = kk.eigsolve(jnp.asarray(A), jnp.asarray(x0),
                            which=kk.EigSorter(by=lambda v: jnp.real(v), rev=True), **kw)
    vt, _, it = kt.eigsolve(torch.from_numpy(A), torch.from_numpy(x0),
                            which=kt.EigSorter(by=lambda v: torch.real(v), rev=True), **kw)
    w = np.linalg.eigvals(A)
    np.testing.assert_allclose(vt.numpy().real, np.sort(w.real)[::-1][:2], atol=1e-8)
    match(vt.numpy(), np.asarray(vj), 1e-8)
    assert counts(it) == counts(ij) and it.converged >= 2


def test_schursolve_real_matches_jax():
    # real input -> REAL Schur path: quasi-triangular T (2x2 blocks for
    # conjugate pairs), real Schur vectors, vals as an (re, im) pair
    rng = np.random.default_rng(8)
    A = rand_mat(rng, 50, np.float64) * 3
    x0 = rand_vec(rng, 50, np.float64)
    hm = 3  # spectrum by |.|: conj pair, real, conj pair -> 3 cuts cleanly
    kw = dict(howmany=hm, which="LM", krylovdim=20, maxiter=200, tol=1e-10)
    Tj, Vj, (rej, imj), ij = kk.schursolve(jnp.asarray(A), jnp.asarray(x0), **kw)
    T, vecs, (re, im), it = kt.schursolve(torch.from_numpy(A), torch.from_numpy(x0), **kw)
    assert it.converged >= hm and counts(it) == counts(ij)
    Tn, V = T.numpy(), vecs.numpy().T  # columns = Schur vectors, REAL
    assert V.dtype == np.float64 and Tn.dtype == np.float64
    assert np.linalg.norm(A @ V - V @ Tn) < 1e-8
    np.testing.assert_allclose(V.T @ V, np.eye(hm), atol=1e-10)
    assert np.max(np.abs(np.tril(Tn, -2))) < 1e-12
    lam = re.numpy() + 1j * im.numpy()
    match(lam, sortsel(np.linalg.eigvals(A), "LM", hm), 1e-8)
    np.testing.assert_allclose(lam, np.asarray(rej) + 1j * np.asarray(imj), atol=1e-9)
    np.testing.assert_allclose(it.normres.numpy(), np.asarray(ij.normres), atol=1e-10)
    # the invariant subspace agrees with JAX's: its projector is sign-free
    Vjn = np.asarray(Vj).T
    np.testing.assert_allclose(V @ V.T, Vjn @ Vjn.T, atol=1e-8)
    assert tuple(it.residual.shape) == (hm, 50)
    # a howmany that splits a conjugate pair shows as im[-1] != 0
    _, _, (_, im4), _ = kt.schursolve(torch.from_numpy(A), torch.from_numpy(x0),
                                      **{**kw, "howmany": 4})
    assert abs(float(im4[-1])) > 0.1


def test_schursolve_complex_matches_jax():
    rng = np.random.default_rng(8)
    A = rand_mat(rng, 50, np.complex128) * 3
    x0 = rand_vec(rng, 50, np.complex128)
    kw = dict(howmany=3, which="LM", krylovdim=20, maxiter=200, tol=1e-10)
    Tj, Vj, valsj, ij = kk.schursolve(jnp.asarray(A), jnp.asarray(x0), **kw)
    T, vecs, vals, it = kt.schursolve(torch.from_numpy(A), torch.from_numpy(x0), **kw)
    assert it.converged >= 3 and counts(it) == counts(ij)
    Tn, V = T.numpy(), vecs.numpy().T
    assert np.linalg.norm(A @ V - V @ Tn) < 1e-8
    np.testing.assert_allclose(V.conj().T @ V, np.eye(3), atol=1e-10)
    assert np.max(np.abs(np.tril(Tn, -1))) < 1e-12
    match(np.diag(Tn), sortsel(np.linalg.eigvals(A), "LM", 3), 1e-8)
    np.testing.assert_allclose(vals.numpy(), np.asarray(valsj), atol=1e-9)
    np.testing.assert_allclose(it.normres.numpy(), np.asarray(ij.normres), atol=1e-10)
    for i in range(3):  # nested invariant subspaces: each vector up to a phase
        np.testing.assert_allclose(abs(np.vdot(np.asarray(Vj[i]), V[:, i])), 1.0, atol=1e-8)


def test_schursolve_real_operator_promotes_complex_start():
    # a real matrix with a complex start vector runs the complex path
    rng = np.random.default_rng(9)
    A, x0 = rand_mat(rng, 30, np.float64) * 3, rand_vec(rng, 30, np.complex128)
    kw = dict(howmany=2, which="LR", krylovdim=15, maxiter=200, tol=1e-10)
    _, _, valsj, ij = kk.schursolve(jnp.asarray(A), jnp.asarray(x0), **kw)
    _, _, vals, it = kt.schursolve(torch.from_numpy(A), torch.from_numpy(x0), **kw)
    assert vals.dtype == torch.complex128 and counts(it) == counts(ij)
    np.testing.assert_allclose(vals.numpy(), np.asarray(valsj), atol=1e-9)


def _real_spectrum_matrix(rng):
    # similar to a real diagonal: dominant eigenvalues 5, -4, 3, -2
    D = np.diag(np.array([5.0, -4.0, 3.0, -2.0] + list(rng.standard_normal(26) * 0.5)))
    S = rng.standard_normal((30, 30)) * 0.2 + np.eye(30)
    return S @ D @ np.linalg.inv(S)


def test_realeigsolve_matches_jax():
    rng = np.random.default_rng(9)
    A = _real_spectrum_matrix(rng)
    x0 = rand_vec(rng, 30, np.float64)
    kw = dict(howmany=2, which="LM", krylovdim=25, maxiter=300, tol=1e-10)
    vj, ej, ij = kk.realeigsolve(jnp.asarray(A), jnp.asarray(x0), **kw)
    vt, et, it = kt.realeigsolve(torch.from_numpy(A), torch.from_numpy(x0), **kw)
    assert vt.dtype == torch.float64 and et.dtype == torch.float64
    match(vt.numpy(), np.array([5.0, -4.0]), 1e-7)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-9)
    assert counts(it) == counts(ij)
    np.testing.assert_allclose(it.normres.numpy(), np.asarray(ij.normres), atol=1e-10)
    for i in range(2):
        v = et[i].numpy()
        assert np.linalg.norm(A @ v - vt[i].item() * v) < 1e-6
        np.testing.assert_allclose(abs(np.asarray(ej[i]) @ v), 1.0, atol=1e-7)
    # ishermitian is accepted and ignored, as in the JAX package
    v2, _, _ = kt.realeigsolve(torch.from_numpy(A), torch.from_numpy(x0), ishermitian=False, **kw)
    np.testing.assert_array_equal(v2.numpy(), vt.numpy())


def test_realeigsolve_rejects_complex_pair():
    rng = np.random.default_rng(10)
    A = np.zeros((10, 10))
    A[0, 1], A[1, 0] = -3.0, 3.0  # dominant eigenvalues ±3i
    A += rng.standard_normal((10, 10)) * 0.05
    x0 = rand_vec(rng, 10, np.float64)
    kw = dict(howmany=2, which="LM", krylovdim=10, tol=1e-10)
    with pytest.raises(ValueError, match="not real"):
        kk.realeigsolve(jnp.asarray(A), jnp.asarray(x0), **kw)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(ValueError, match="not real"):
        kt.realeigsolve(torch.from_numpy(A), torch.from_numpy(x0), **kw)
    assert buf.getvalue().startswith(
        "realeigsolve: a complex conjugate pair entered the wanted window (max |imag| = ")
    with pytest.raises(ValueError, match="real linear map"):
        kt.realeigsolve(torch.from_numpy(A + 0j), torch.from_numpy(x0 + 0j), **kw)


def test_front_end_errors_and_defaults():
    A = torch.from_numpy(np.random.default_rng(11).standard_normal((20, 20)))
    x0 = torch.ones(20, dtype=torch.float64)
    with pytest.raises(ValueError, match="LI/SI invalid for real"):
        kt.eigsolve(A, x0, 2, "LI", ishermitian=False)
    with pytest.raises(ValueError, match="krylovdim"):
        kt.eigsolve(A, x0, howmany=8, krylovdim=5)
    with pytest.raises(ValueError, match="krylovdim"):
        kt.schursolve(A, x0, howmany=8, krylovdim=5)
    with pytest.raises(ValueError, match="krylovdim"):
        kt.realeigsolve(A, x0, howmany=8, krylovdim=5)
    with pytest.raises(ValueError, match="zero norm"):
        kt.schursolve(A, torch.zeros(20, dtype=torch.float64), 2)
    # no x0: the JAX package's default start vector (numpy seed 42)
    _, _, (re, im), it = kt.schursolve(A, None, 2, "LM", krylovdim=20, tol=1e-10)
    _, _, (rej, imj), ij = kk.schursolve(jnp.asarray(A.numpy()), None, 2, "LM", krylovdim=20,
                                         tol=1e-10)
    np.testing.assert_allclose(re.numpy(), np.asarray(rej), atol=1e-9)
    assert counts(it) == counts(ij)
    # an explicit algorithm struct wins over keywords
    alg = kt.Arnoldi(krylovdim=20, tol=1e-10)
    _, _, (re2, _), _ = kt.schursolve(A, None, 2, "LM", alg)
    np.testing.assert_array_equal(re2.numpy(), re.numpy())


def test_real_arnoldi_f32_matches_jax():
    """The float32 real-Schur path at the eps^(2/3) tolerance."""
    rng = np.random.default_rng(107)
    A = rng.standard_normal((60, 60)).astype(np.float32)
    x0 = rng.standard_normal(60).astype(np.float32)
    tol = float(np.finfo(np.float32).eps ** (2 / 3))
    kw = dict(ishermitian=False, krylovdim=25, maxiter=100, tol=tol)
    vj, _, ij = kk.eigsolve(jnp.asarray(A), jnp.asarray(x0), 3, "LM", **kw)
    vt, _, it = kt.eigsolve(torch.from_numpy(A), torch.from_numpy(x0), 3, "LM", **kw)
    ex = np.linalg.eigvals(A.astype(np.float64))
    ex = ex[np.argsort(-np.abs(ex))][:3]
    assert vt.dtype == torch.complex64 and it.converged >= 3 and int(ij.converged) >= 3
    match(vt.numpy(), ex, 10 * tol)
    match(vt.numpy(), np.asarray(vj), 10 * tol)
    # the third residual crosses tol within float32 rounding of a restart:
    # the two packages may stop one iteration apart
    assert abs(it.numiter - int(ij.numiter)) <= 1


@pytest.mark.parametrize("eager", [False, True])
def test_eager_and_breakdown_match_jax(eager):
    # a rank-deficient map: the Krylov space closes after 6 steps (breakdown)
    rng = np.random.default_rng(12)
    B = rng.standard_normal((40, 6))
    A = B @ rng.standard_normal((6, 40))
    x0 = B @ rng.standard_normal(6)
    jalg = kk.Arnoldi(krylovdim=15, maxiter=5, tol=1e-10, eager=eager)
    vj, _, ij = kk.eigsolve(jnp.asarray(A), jnp.asarray(x0), 2, "LM", alg=jalg)
    vt, _, it = kt.eigsolve(torch.from_numpy(A), torch.from_numpy(x0), 2, "LM", alg=talg(jalg))
    assert counts(it) == counts(ij) and it.numops <= 7
    match(vt.numpy(), np.asarray(vj), 1e-8)
    # and a well-posed iterative problem in eager mode
    A2, x2 = rand_mat(rng, 60, np.float64) * 5, rand_vec(rng, 60, np.float64)
    jalg = kk.Arnoldi(krylovdim=20, maxiter=100, tol=1e-9, eager=eager)
    vj, _, ij = kk.eigsolve(jnp.asarray(A2), jnp.asarray(x2), 2, "LR", alg=jalg)
    vt, _, it = kt.eigsolve(torch.from_numpy(A2), torch.from_numpy(x2), 2, "LR", alg=talg(jalg))
    assert counts(it) == counts(ij) and it.converged >= 2
    match(vt.numpy(), np.asarray(vj), 1e-8)


# ---------------------------------------------------------------------------
# the fused expansion in Arnoldi mode (K1 with hermitian=False, K2 in the
# Krylov-Schur restart) and the unfused stencil path
# ---------------------------------------------------------------------------


def _stencil_problem(seed, dtype, n=1 << 12):
    x0 = np.random.default_rng(seed).standard_normal((n // 128, 128)).astype(dtype)
    jop = kk.StencilOperator(*NONSYM)
    top, xt = convert.eig_problem_from_numpy(NONSYM, x0, "cpu")
    return jop, top, x0, xt


@pytest.mark.parametrize("orth", ["cgs", "cgs2"])
@pytest.mark.parametrize("maxiter", [1, 5])
def test_fused_schursolve_f32_matches_jax_fused(interpret_mode, maxiter, orth):
    jop, top, x0, xt = _stencil_problem(5, np.float32)
    jalg = kk.Arnoldi(krylovdim=18, maxiter=maxiter, tol=1e-5, orth=getattr(kk, orth))
    assert tkf.fused_available(top, xt, kt.STANDARD, kmax=19)
    Tj, Vj, (rej, imj), ij = kk.schursolve(jop, jnp.asarray(x0), 4, "LM", jalg)
    T, V, (re, im), it = kt.schursolve(top, xt, 4, "LM", talg(jalg))
    assert re.dtype == torch.float32 and V.dtype == torch.float32
    np.testing.assert_allclose(re.numpy(), np.asarray(rej), rtol=2e-4)
    # |im| ~ 0.05 beside |re| ~ 4: held to 1.2e-5 of |λ| (the values are
    # unconverged Ritz values, normres ~ 0.2)
    np.testing.assert_allclose(im.numpy(), np.asarray(imj), rtol=2e-4, atol=5e-5)
    assert (it.numops, it.numiter) == (int(ij.numops), int(ij.numiter))
    np.testing.assert_allclose(it.normres.numpy(), np.asarray(ij.normres), rtol=0.05, atol=1e-5)
    # Schur vectors agree up to sign and are orthonormal
    for a, b in zip(np.asarray(Vj), V.numpy()):
        np.testing.assert_allclose(abs(np.vdot(a, b)), 1.0, rtol=1e-3)
    G = V.reshape(4, -1) @ V.reshape(4, -1).T
    np.testing.assert_allclose(G.numpy(), np.eye(4), atol=5e-4)


def test_fused_launches_counted_on_cpu_are_zero_and_path_is_fused(monkeypatch):
    # the fused solve goes through fl.fused_step (its plain version on the
    # CPU) once per in-stream expansion, and through the in-place transform
    # once per processing round
    from krylovkit_tpu_torch.ops import fused_lanczos as fl

    _, top, _, xt = _stencil_problem(5, np.float32)
    steps, rots = [], []
    monkeypatch.setattr(fl, "fused_step",
                        lambda *a, f=fl.fused_step, **k: steps.append(a[4]) or f(*a, **k))
    monkeypatch.setattr(tbs, "transform_partial_inplace",
                        lambda V, U, m, f=tbs.transform_partial_inplace: rots.append(m) or f(V, U, m))
    _, _, _, it = kt.schursolve(top, xt, 4, "LM", krylovdim=18, maxiter=5, tol=1e-5)
    assert it.numiter == 5
    # one priming apply per cycle outside the stream, none in the tail
    assert len(steps) == it.numops - it.numiter
    # every round rotates rows < keep_max + 1 = (3*18 + 2*3)//5 + 2 = 14
    assert rots == [14] * it.numiter


def test_fused_realeigsolve_and_eigsolve_f32(interpret_mode):
    # the symmetric Laplacian keeps its real-Schur values real
    n = 1 << 12
    x0 = np.random.default_rng(6).standard_normal((n // 128, 128)).astype(np.float32)
    kw = dict(krylovdim=20, maxiter=30, tol=5e-3, orth=kk.cgs)
    jop = kk.parallel.laplacian_1d(n, jnp.float32)
    vj, _, ij = kk.realeigsolve(jop, jnp.asarray(x0), 2, "LM", **kw)
    top = kt.laplacian_1d(n, device="cpu")
    xt = torch.from_numpy(x0)
    vt, et, it = kt.realeigsolve(top, xt, 2, "LM", **{**kw, "orth": kt.cgs})
    assert it.converged >= 1 and (it.numops, it.numiter) == (int(ij.numops), int(ij.numiter))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=2e-4)
    for i in range(it.converged):
        r = top.normal(et[i]) - vt[i] * et[i]
        assert float(torch.linalg.vector_norm(r)) < 2e-2
    # eigsolve on the non-symmetric stencil: complex pairs out of the real loop
    jop, top, x0, xt = _stencil_problem(44, np.float32)
    kw = dict(ishermitian=False, krylovdim=18, maxiter=5, tol=1e-5)
    vj, _, ij = kk.eigsolve(jop, jnp.asarray(x0), 4, "LM", **kw)
    vt, et, it = kt.eigsolve(top, xt, 4, "LM", **kw)
    assert vt.dtype == torch.complex64 and et.dtype == torch.complex64
    np.testing.assert_allclose(np.abs(vt.numpy()), np.abs(np.asarray(vj)), rtol=5e-4)
    assert (it.numops, it.numiter) == (int(ij.numops), int(ij.numiter))
    assert tuple(et.shape) == (4, n // 128, 128)


@pytest.mark.parametrize("orth", ["cgs2", "cgs", "mgs2"])
def test_unfused_stencil_f64_matches_jax(orth):
    jop, top, x0, xt = _stencil_problem(5, np.float64)
    assert not tkf.fused_available(top, xt, kt.STANDARD, kmax=19)
    jalg = kk.Arnoldi(krylovdim=18, maxiter=5, tol=1e-8, orth=getattr(kk, orth))
    Tj, Vj, (rej, imj), ij = kk.schursolve(jop, jnp.asarray(x0), 4, "LM", jalg)
    T, V, (re, im), it = kt.schursolve(top, xt, 4, "LM", talg(jalg))
    np.testing.assert_allclose(re.numpy(), np.asarray(rej), rtol=1e-9)
    np.testing.assert_allclose(im.numpy(), np.asarray(imj), rtol=1e-9, atol=1e-10)
    assert counts(it) == counts(ij)
    # the two Schur vectors of a 2x2 block are fixed up to a quarter turn
    # (lanv2 equalizes the diagonal at θ or θ ± π/2, decided by rounding), which
    # swaps the pair's residual norms: compare them as a set
    np.testing.assert_allclose(np.sort(it.normres.numpy()), np.sort(np.asarray(ij.normres)),
                               rtol=1e-5, atol=1e-12)
    Vn, Vjn = V.numpy().reshape(4, -1), np.asarray(Vj).reshape(4, -1)
    np.testing.assert_allclose(Vn.T @ Vn, Vjn.T @ Vjn, atol=1e-7)


def test_banded_f32_with_projection_flag_matches_jax_default():
    # the same matrix as a banded operator, projections flag on: the unfused
    # loop goes K3's plain version + the projections' plain versions
    n = 1 << 12
    i = np.arange(n)
    rows = np.concatenate([i[1:], i, i[:-1]])
    cols = np.concatenate([i[1:] - 1, i, i[:-1] + 1])
    vals = np.concatenate([np.full(n - 1, -1.3), np.full(n, 2.0), np.full(n - 1, -0.7)]
                          ).astype(np.float32)
    x0 = np.random.default_rng(5).standard_normal((n // 128, 128)).astype(np.float32)
    jop = j_banded_from_coo(rows, cols, vals, n)
    top = kt.banded_from_coo(rows, cols, vals, n, device="cpu")
    assert top.offsets == (-1, 0, 1) == tuple(jop.offsets)
    kw = dict(krylovdim=18, maxiter=5, tol=1e-5)
    Tj, Vj, (rej, imj), ij = kk.schursolve(jop, jnp.asarray(x0), 4, "LM", **kw)
    calls = []
    orig = tpb.unproject_reference
    old = tbs.use_pallas_projections
    tbs.use_pallas_projections = True
    tpb.unproject_reference = lambda *a: calls.append(1) or orig(*a)
    try:
        T, V, (re, im), it = kt.schursolve(top, torch.from_numpy(x0), 4, "LM", **kw)
    finally:
        tbs.use_pallas_projections = old
        tpb.unproject_reference = orig
    assert len(calls) == 2 * it.numops  # cgs2: two sweeps per expansion
    np.testing.assert_allclose(re.numpy(), np.asarray(rej), rtol=2e-4)
    np.testing.assert_allclose(im.numpy(), np.asarray(imj), rtol=2e-4, atol=1e-6)
    assert (it.numops, it.numiter) == (int(ij.numops), int(ij.numiter))
    # and the stencil's fused solve finds the same values
    _, _, (re_s, _), it_s = kt.schursolve(convert.stencil_from_arrays(*NONSYM, device="cpu"),
                                          torch.from_numpy(x0), 4, "LM", **kw)
    np.testing.assert_allclose(re.numpy(), re_s.numpy(), rtol=2e-4)
    assert it.numops == it_s.numops


def test_fused_expansions_arnoldi_column_is_full_hessenberg():
    # hermitian=False writes the whole projection column; hermitian=True only
    # the (alpha, beta) pair, on the same stream
    _, top, _, xt = _stencil_problem(3, np.float32)
    m = 8
    out = {}
    for herm in (True, False):
        st = tkf.initialize(xt, m, torch.float32)
        st, sc, dops = tkf.fused_expansions(top, st, tkf.fused_scales_init(m + 1, device="cpu"),
                                            m, 1e-6, kt.STANDARD, hermitian=herm, dgks=True)
        assert (st.k, dops) == (m, m)
        out[herm] = st.H.numpy().copy()
    Hh, Ha = out[True], out[False]
    np.testing.assert_array_equal(np.diag(Hh), np.diag(Ha))
    np.testing.assert_array_equal(np.diag(Hh, -1), np.diag(Ha, -1))
    assert np.all(np.triu(Hh, 1) == 0) and np.abs(np.triu(Ha, 1)).max() > 0.1
    assert np.all(np.tril(Ha, -2) == 0)
    # the Arnoldi relation on the true basis: H is the stencil's projection,
    # its superdiagonal the stencil's other off-diagonal coefficient
    np.testing.assert_allclose(np.diag(Ha)[:m], 2.0, atol=0.2)


def test_arnoldi_log_text_matches_jax():
    A = torch.from_numpy(np.random.default_rng(13).standard_normal((20, 20)))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        kt.schursolve(A, torch.ones(20, dtype=torch.float64), 2, "LM", krylovdim=10, maxiter=2,
                      verbosity=kt.EACHITERATION)
    # an 8-entry array wraps over two lines: look at the lines that start a message
    heads = [ln for ln in buf.getvalue().splitlines() if ln.startswith("Arnoldi")]
    assert len(heads) == 2
    for i, ln in enumerate(heads):
        assert ln.startswith(f"Arnoldi schursolve in iteration {i + 1}: ")
        assert " values converged, normres = [" in ln


def test_block_safe_keep_and_guard():
    # T with a 2x2 block at (2, 3): keep = 3 would split it
    T = torch.diag(torch.tensor([5.0, 4.0, 1.0, 1.0, 0.5, 0.2]))
    T[2, 3], T[3, 2] = 2.0, -2.0
    assert tarn._block_safe_keep(T, 6, 3) == 4  # grown to hold the block
    assert tarn._block_safe_keep(T, 6, 2) == 2 and tarn._block_safe_keep(T, 6, 4) == 4
    assert tarn._block_safe_keep(T, 4, 3) == 2  # no room at the edge: dropped
    assert tarn._block_safe_keep(T, 6, 0) == 0
