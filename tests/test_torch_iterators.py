"""PyTorch port: the iterator API (``LanczosIterator`` with its 3-term
``keepvecs=False`` mode, ``ArnoldiIterator``, ``GKLIterator``,
``BlockLanczosIterator``, ``BiArnoldiIterator``) and the accessors
(``basis``, ``rayleighquotient``, ``residual``, ``normres``) against the JAX
package, one test for each of ``tests/test_factorize.py`` with the same
factorization contracts, plus the states carried across by
``convert.lanczos3_state_from_numpy``.

The projected matrices of the two packages agree to 1e-10 (float64,
complex128; the same steps on the same inputs); bases are held to their
invariants (orthonormality, ``A V = V H + r e'``), as the JAX test holds
them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import krylovkit_tpu as kk
from krylovkit_tpu.factorizations import iterators as jits
from krylovkit_tpu.factorizations import krylov as jkf
import krylovkit_tpu_torch as kt
from krylovkit_tpu_torch import convert
from krylovkit_tpu_torch.factorizations import krylov as tkf
from testsetup import hermitize, n, rand_mat, rand_vec

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _steps(it, k):
    """``k`` expansions; a JAX iterator's step compiled once for the ``k``
    (op by op each call compiles its loops anew)."""
    jax_side = type(it).__module__.startswith("krylovkit_tpu.")
    expand = jax.jit(it.expand) if jax_side else it.expand
    st = it.initialize()
    for _ in range(k):
        st = expand(st)
    return st


def _same_H(Ht, Hj, atol=1e-10):
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), atol=atol, rtol=0)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_lanczos_factorization_contract_matches_jax(dtype):
    rng = np.random.default_rng(81)
    A = hermitize(rand_mat(rng, n, n, dtype))
    x0 = rand_vec(rng, n, dtype)
    sj = _steps(kk.LanczosIterator(jnp.asarray(A), jnp.asarray(x0), krylovdim=8), 6)
    st = _steps(kt.LanczosIterator(_t(A), _t(x0), krylovdim=8), 6)
    assert st.k == int(sj.k) == 6
    _same_H(kt.rayleighquotient(st), jits.rayleighquotient(sj))
    assert float(kt.normres(st)) == pytest.approx(float(jits.normres(sj)), rel=1e-10)
    k = st.k
    V = kt.basis(st).numpy()
    np.testing.assert_allclose(V[: k + 1].conj() @ V[: k + 1].T, np.eye(k + 1), atol=1e-12)
    # tridiagonal factorization: A V = V T + β v_k e_k'
    H = st.H.numpy()
    T = np.tril(H) + np.tril(H, -1).conj().T
    resid = A @ V[:k].T - V[:k].T @ T[:k, :k]
    want = float(st.beta) * np.outer(V[k], np.eye(k)[k - 1]).T
    np.testing.assert_allclose(resid, want.T, atol=1e-10)
    np.testing.assert_allclose(kt.residual(st).numpy(), V[k])
    vj = np.asarray(jits.residual(sj))
    assert abs(np.vdot(vj, V[k])) == pytest.approx(1.0, abs=1e-10)


@pytest.mark.parametrize("dtype", [np.complex128, np.float64])
def test_arnoldi_factorization_contract_matches_jax(dtype):
    rng = np.random.default_rng(82)
    A = rand_mat(rng, n, n, dtype)
    x0 = rand_vec(rng, n, dtype)
    sj = _steps(kk.ArnoldiIterator(jnp.asarray(A), jnp.asarray(x0), krylovdim=8), 6)
    st = _steps(kt.ArnoldiIterator(_t(A), _t(x0), krylovdim=8), 6)
    _same_H(st.H, sj.H)
    k = st.k
    V = st.V.numpy()
    np.testing.assert_allclose(V[: k + 1].conj() @ V[: k + 1].T, np.eye(k + 1), atol=1e-12)
    H = st.H.numpy()
    np.testing.assert_allclose(A @ V[:k].T, V[: k + 1].T @ H[: k + 1, :k], atol=1e-10)


def test_lanczos_shrink_roundtrip_matches_jax():
    rng = np.random.default_rng(83)
    A = hermitize(rand_mat(rng, n, n, np.float64))
    x0 = rand_vec(rng, n, np.float64)
    itj = kk.LanczosIterator(jnp.asarray(A), jnp.asarray(x0), krylovdim=8)
    itt = kt.LanczosIterator(_t(A), _t(x0), krylovdim=8)
    sj, st = itj.shrink(_steps(itj, 6), 3), itt.shrink(_steps(itt, 6), 3)
    assert st.k == int(sj.k) == 3
    assert float(st.beta) == pytest.approx(float(sj.beta), rel=1e-12)
    _same_H(st.H, sj.H)
    # expanding again keeps the factorization valid
    for _ in range(2):
        sj, st = itj.expand(sj), itt.expand(st)
    _same_H(st.H, sj.H)
    k = st.k
    V = st.V.numpy()
    np.testing.assert_allclose(V[: k + 1].conj() @ V[: k + 1].T, np.eye(k + 1), atol=1e-10)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_gkl_factorization_contract_matches_jax(dtype):
    rng = np.random.default_rng(84)
    A = rand_mat(rng, 2 * n, n, dtype)
    Aj, At = jnp.asarray(A), _t(A)
    x0 = rand_vec(rng, 2 * n, dtype)
    sj = _steps(kk.GKLIterator((lambda x: Aj @ x, lambda y: Aj.conj().T @ y), jnp.asarray(x0),
                               krylovdim=8), 6)
    st = _steps(kt.GKLIterator((lambda x: At @ x, lambda y: At.conj().T @ y), _t(x0),
                               krylovdim=8), 6)
    _same_H(kt.rayleighquotient(st), jits.rayleighquotient(sj))
    k = st.k
    U, V, B = st.U.numpy(), st.V.numpy(), st.B.numpy()
    np.testing.assert_allclose(U[: k + 1].conj() @ U[: k + 1].T, np.eye(k + 1), atol=1e-12)
    np.testing.assert_allclose(V[:k].conj() @ V[:k].T, np.eye(k), atol=1e-12)
    np.testing.assert_allclose(A @ V[:k].T, U[: k + 1].T @ B[: k + 1, :k], atol=1e-10)
    np.testing.assert_allclose(A.conj().T @ U[:k].T, V[:k].T @ B[:k, :k].conj().T, atol=1e-10)
    np.testing.assert_allclose(kt.residual(st).numpy(), U[k])


def test_gkl_iterator_derives_the_adjoint_of_a_square_callable():
    rng = np.random.default_rng(86)
    A = rand_mat(rng, n, n, np.float64)
    At = _t(A)
    x0 = _t(rand_vec(rng, n, np.float64))
    s1 = _steps(kt.GKLIterator(lambda x: At @ x, x0, krylovdim=8), 5)
    s2 = _steps(kt.GKLIterator(At, x0, krylovdim=8), 5)
    _same_H(s1.B, s2.B.numpy(), atol=1e-12)


def test_blocklanczos_iterator_matches_jax():
    rng = np.random.default_rng(85)
    A = hermitize(rand_mat(rng, 20, 20, np.float64))
    X0 = np.stack([rand_vec(rng, 20, np.float64) for _ in range(3)])
    sj = _steps(kk.BlockLanczosIterator(jnp.asarray(A), jnp.asarray(X0), krylovdim=12), 3)
    st = _steps(kt.BlockLanczosIterator(_t(A), _t(X0), krylovdim=12), 3)
    assert st.k == int(sj.k) == 9
    _same_H(kt.rayleighquotient(st), jits.rayleighquotient(sj))
    k = st.k
    V = kt.basis(st).numpy()
    np.testing.assert_allclose(V[:k].conj() @ V[:k].T, np.eye(k), atol=1e-10)
    # the residual accessor is the current block
    assert kt.residual(st).shape == (3, 20)
    np.testing.assert_allclose(np.abs(kt.residual(st).numpy()), np.abs(np.asarray(jits.residual(sj))),
                               atol=1e-10)


def test_lanczos_keepvecs_false_3term_matches_jax():
    rng = np.random.default_rng(83)
    A = hermitize(rand_mat(rng, n, n, np.float64))
    x0 = rand_vec(rng, n, np.float64)
    it3 = kt.LanczosIterator(_t(A), _t(x0), krylovdim=10, orth=kt.cgs, keepvecs=False)
    itf = kt.LanczosIterator(_t(A), _t(x0), krylovdim=10, orth=kt.cgs)
    s3, sf = it3.initialize(), itf.initialize()
    # the 3-term state stores no basis, only the rolling (v_prev, v_cur) pair
    assert not hasattr(s3, "V") and isinstance(s3, tkf.Lanczos3State)
    for _ in range(8):
        s3, sf = it3.expand(s3), itf.expand(sf)
    H3, Hf = s3.H.numpy(), sf.H.numpy()
    T3 = np.tril(H3) + np.tril(H3, -1).T
    Tf = np.tril(Hf) + np.tril(Hf, -1).T
    np.testing.assert_allclose(T3[:8, :8], Tf[:8, :8], atol=1e-8)
    assert kt.rayleighquotient(s3).shape == H3.shape
    assert np.isclose(np.linalg.norm(kt.residual(s3).numpy()), 1.0, atol=1e-12)
    # against the JAX package's 3-term iterator, step for step
    sj = _steps(kk.LanczosIterator(jnp.asarray(A), jnp.asarray(x0), krylovdim=10, orth=kk.cgs,
                                   keepvecs=False), 8)
    _same_H(s3.H, sj.H)
    np.testing.assert_allclose(s3.v_cur.numpy(), np.asarray(sj.v_cur), atol=1e-10)
    np.testing.assert_allclose(s3.v_prev.numpy(), np.asarray(sj.v_prev), atol=1e-10)
    assert s3.k == int(sj.k) == 8


def test_lanczos_keepvecs_false_rejects_reorth():
    rng = np.random.default_rng(84)
    A = _t(hermitize(rand_mat(rng, n, n, np.float64)))
    with pytest.raises(ValueError, match="keepvecs"):
        kt.LanczosIterator(A, _t(rand_vec(rng, n, np.float64)), keepvecs=False, orth=kt.cgs2)
    it = kt.LanczosIterator(A, _t(rand_vec(rng, n, np.float64)), keepvecs=False, orth=kt.cgs)
    st = it.initialize()
    with pytest.raises(ValueError, match="shrink"):
        it.shrink(st, 2)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_biarnoldi_iterator_matches_jax(dtype):
    rng = np.random.default_rng(87)
    A = rand_mat(rng, n, n, dtype)
    v0, w0 = rand_vec(rng, n, dtype), rand_vec(rng, n, dtype)
    sj = _steps(kk.BiArnoldiIterator(jnp.asarray(A), jnp.asarray(v0), jnp.asarray(w0),
                                     krylovdim=8), 6)
    st = _steps(kt.BiArnoldiIterator(_t(A), _t(v0), _t(w0), krylovdim=8), 6)
    for (ft, fj), M in zip(zip(st, sj), (A, A.conj().T)):
        _same_H(ft.H, fj.H)
        k = ft.k
        V, H = ft.V.numpy(), ft.H.numpy()
        np.testing.assert_allclose(V[: k + 1].conj() @ V[: k + 1].T, np.eye(k + 1), atol=1e-12)
        np.testing.assert_allclose(M @ V[:k].T, V[: k + 1].T @ H[: k + 1, :k], atol=1e-10)
        assert float(kt.normres(ft)) == pytest.approx(float(jits.normres(fj)), rel=1e-10)
    # a bare callable: the left side's adjoint is derived from it
    At = _t(A)
    sd = _steps(kt.BiArnoldiIterator(lambda x: At @ x, _t(v0), _t(w0), krylovdim=8), 6)
    _same_H(sd[1].H, st[1].H.numpy(), atol=1e-12)


def test_iterators_promote_a_real_start_for_a_complex_operator():
    """A complex operator and a real start: the basis takes the operator's
    type, so the factorization holds (the JAX package keeps the start's type
    and drops the imaginary part of ``A v``)."""
    rng = np.random.default_rng(88)
    A = rand_mat(rng, n, n, np.complex128)
    H = hermitize(A)
    x0 = rand_vec(rng, n, np.float64)
    for it, M in ((kt.ArnoldiIterator(_t(A), _t(x0), krylovdim=8), A),
                  (kt.LanczosIterator(_t(H), _t(x0), krylovdim=8), H)):
        st = _steps(it, 6)
        V, Hs = st.V.numpy(), st.H.numpy()
        assert V.dtype == np.complex128
        if isinstance(it, kt.LanczosIterator):
            Hs = np.tril(Hs) + np.tril(Hs, -1).conj().T
            Hs[st.k, st.k - 1] = float(st.beta)
        np.testing.assert_allclose(M @ V[:6].T, V[:7].T @ Hs[:7, :6], atol=1e-10)


def test_lanczos3_state_from_numpy_matches_jax_fields():
    rng = np.random.default_rng(89)
    A = hermitize(rand_mat(rng, n, n, np.float64))
    x0 = rand_vec(rng, n, np.float64)
    sj = _steps(kk.LanczosIterator(jnp.asarray(A), jnp.asarray(x0), krylovdim=10, orth=kk.cgs,
                                   keepvecs=False), 4)
    assert isinstance(sj, jkf.Lanczos3State)
    st = convert.lanczos3_state_from_numpy(*(np.asarray(f) for f in sj), device="cpu")
    for name in jkf.Lanczos3State._fields:
        a, b = getattr(st, name), getattr(sj, name)
        if name == "k":
            assert a == int(b)
        else:
            assert a.dtype == torch.from_numpy(np.array(b)).dtype
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the copied arrays are the port's own: stepping both keeps them equal
    sj2 = jkf.expand_3term(lambda v: jnp.asarray(A) @ v, sj)
    st2 = tkf.expand_3term(lambda v: _t(A) @ v, st)
    _same_H(st2.H, sj2.H)
    np.testing.assert_allclose(st2.v_cur.numpy(), np.asarray(sj2.v_cur), atol=1e-12)
    assert float(st2.beta) == pytest.approx(float(sj2.beta), rel=1e-12)
