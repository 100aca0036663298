"""PyTorch port: ``bieigsolve`` (BiArnoldi, two-sided eigenproblems) against
the JAX package on the same numpy inputs, one test for each of
``tests/test_bieigsolve.py`` with its parametrisation, plus a banded float32
case (K3's plain version here) and the front-end's refusals.

The dense-matrix case over four scalar types × four orthogonalizers is in
``test_torch_bieigsolve_matrix.py``.  Values agree to 1e-10 (float64/complex128; 1e-4 relative in float32 and
complex64), matched greedily so a conjugate pair may come in either order;
``numops``, ``numiter`` and ``converged`` are equal on both sides.  Vectors
are held to invariants: their residuals, biorthogonality ``WᴴV ≈ diag``, and
``|⟨v_jax, v_port⟩| ≈ 1`` for the converged right vectors."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import krylovkit_tpu as kk
from krylovkit_tpu.ops.pallas_spmv import banded_from_coo as j_banded_from_coo
import krylovkit_tpu_torch as kt
from krylovkit_tpu_torch import convert
from testsetup import N, as_pytree, eig_close, n, precision, pytree_matvec, rand_mat, rand_vec

torch.set_num_threads(2)

def _t(x):
    return torch.from_numpy(np.asarray(x))


def _value_tol(dtype):
    return 1e-10 if np.dtype(dtype) in (np.float64, np.complex128) else 1e-4


def _parity(rj, rt, tol):
    """Values of the two packages within ``tol`` (relative to the largest),
    counts equal on both infos; returns the port's ``(vals, V, W, infoV)``
    with the vectors as numpy columns."""
    vj, (Vj, _), (ij, iwj) = rj
    vt, (Vt, Wt), (it, iwt) = rt
    assert eig_close(vt.numpy(), np.asarray(vj), tol), (vt.numpy(), np.asarray(vj))
    for a, b in ((ij, it), (iwj, iwt)):
        assert (b.numops, b.numiter, b.converged) == (
            int(a.numops), int(a.numiter), int(a.converged))
    Vt_, Vj_ = Vt.numpy().T, np.asarray(Vj).T
    for i in range(min(it.converged, Vt_.shape[1])):
        ov = abs(np.vdot(Vj_[:, i], Vt_[:, i])) / (
            np.linalg.norm(Vj_[:, i]) * np.linalg.norm(Vt_[:, i]))
        # a conjugate pair may come in either order
        ovc = abs(np.vdot(Vj_[:, i], Vt_[:, i].conj())) / (
            np.linalg.norm(Vj_[:, i]) * np.linalg.norm(Vt_[:, i]))
        assert max(ov, ovc) == pytest.approx(1.0, abs=1e-6 if tol < 1e-6 else 1e-2)
    return vt.numpy(), Vt_, Wt.numpy().T, it


def _solve_both(A, v0, w0, howmany, which, orth=None, **kw):
    jkw = dict(kw, **({"orth": getattr(kk, orth)} if orth else {}))
    tkw = dict(kw, **({"orth": getattr(kt, orth)} if orth else {}))
    rj = kk.bieigsolve(A, jnp.asarray(v0), jnp.asarray(w0), howmany, which, **jkw)
    rt = kt.bieigsolve(_t(A), _t(v0), _t(w0), howmany, which, **tkw)
    return rj, rt


def _biorthogonal(V, W, tol):
    G = W.conj().T @ V
    off = G - np.diag(np.diagonal(G))
    assert np.linalg.norm(off) <= tol * max(1.0, float(np.linalg.norm(np.diagonal(G))))
    assert np.all(np.abs(np.diagonal(G)) > 0)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_bieig_full_matches_jax(dtype):
    rng = np.random.default_rng(61)
    A = rand_mat(rng, n, n, dtype)
    v0, w0 = rand_vec(rng, n, dtype), rand_vec(rng, n, dtype)
    rj, rt = _solve_both(A, v0, w0, 3, "LM", krylovdim=n, tol=1e-10, maxiter=100)
    lam, V, W, info = _parity(rj, rt, 1e-10)
    wA = np.linalg.eigvals(A)
    assert info.converged >= 3
    assert eig_close(lam, wA[np.argsort(-np.abs(wA))][:3], 1e-7)
    for i in range(3):
        assert np.linalg.norm(A @ V[:, i] - lam[i] * V[:, i]) <= 1e-6
        assert np.linalg.norm(A.conj().T @ W[:, i] - np.conj(lam[i]) * W[:, i]) <= 1e-6
    _biorthogonal(V, W, 1e-6)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_bieig_iterative_matches_jax(dtype):
    rng = np.random.default_rng(62)
    A = rand_mat(rng, N, N, dtype) + np.diag(np.linspace(0, 2, N)).astype(dtype)
    v0, w0 = rand_vec(rng, N, dtype), rand_vec(rng, N, dtype)
    rj, rt = _solve_both(A, v0, w0, 2, "LM", krylovdim=25, tol=1e-9, maxiter=200)
    lam, V, W, info = _parity(rj, rt, 1e-10)
    assert info.converged >= 2 and info.numiter > 1  # restarted
    for i in range(2):
        nv, nw = np.linalg.norm(V[:, i]), np.linalg.norm(W[:, i])
        assert np.linalg.norm(A @ V[:, i] - lam[i] * V[:, i]) <= 1e-6 * max(nv, 1)
        assert np.linalg.norm(A.conj().T @ W[:, i] - np.conj(lam[i]) * W[:, i]) <= 1e-6 * max(nw, 1)
    # the residual vectors and norms of the info records agree with each other
    _, _, (iV, iW) = rt
    for info_, rn in ((iV, iV.normres), (iW, iW.normres)):
        r = info_.residual.numpy()
        np.testing.assert_allclose(np.linalg.norm(r, axis=1), rn.numpy(), rtol=1e-8, atol=1e-14)


def test_bieig_default_start_matches_jax():
    rng = np.random.default_rng(63)
    A = rand_mat(rng, n, n, np.float64)
    vj, _, (ij, _) = kk.bieigsolve(A, howmany=2, krylovdim=n, tol=1e-10, maxiter=60)
    vt, _, (it, _) = kt.bieigsolve(_t(A), howmany=2, krylovdim=n, tol=1e-10, maxiter=60)
    assert eig_close(vt.numpy(), np.asarray(vj), 1e-10)
    assert (it.numops, it.numiter, it.converged) == (
        int(ij.numops), int(ij.numiter), int(ij.converged))
    wA = np.linalg.eigvals(A)
    assert eig_close(vt.numpy(), wA[np.argsort(-np.abs(wA))][:2], 1e-7)
    # the numpy matrix with one start given: the other drawn as in the JAX package
    v0 = np.random.default_rng(42).standard_normal(n)
    vt2, _, _ = kt.bieigsolve(A, _t(v0), None, 2, krylovdim=n, tol=1e-10, maxiter=60)
    np.testing.assert_allclose(vt2.numpy(), vt.numpy(), rtol=1e-12)


@pytest.mark.parametrize("which", ["SI", "LI"])
def test_bieig_complex_imag_sorts_match_jax(which):
    rng = np.random.default_rng(65)
    A = rand_mat(rng, n, n, np.complex128)
    v0, w0 = rand_vec(rng, n, np.complex128), rand_vec(rng, n, np.complex128)
    rj, rt = _solve_both(A, v0, w0, 3, which, krylovdim=n, tol=1e-10, maxiter=30)
    lam, _, _, info = _parity(rj, rt, 1e-10)
    wA = np.linalg.eigvals(A)
    order = np.argsort(np.imag(wA)) if which == "SI" else np.argsort(-np.imag(wA))
    assert info.converged >= 3
    assert eig_close(lam, wA[order][:3], 1e-6)


def test_bieig_pytree_mode_matches_jax():
    rng = np.random.default_rng(66)
    A = rand_mat(rng, n, n, np.float64)
    v0, w0 = rand_vec(rng, n, np.float64), rand_vec(rng, n, np.float64)
    vj, (Vj, _), (ij, _) = kk.bieigsolve(
        (pytree_matvec(A), pytree_matvec(A.conj().T)), as_pytree(v0), as_pytree(w0), 2,
        "LM", krylovdim=n, tol=1e-10, maxiter=30)

    def matvec(M):
        Mt = _t(M)

        def f(x):
            w = Mt @ torch.cat([x["a"], x["b"]])
            return {"a": w[: n // 2], "b": w[n // 2:]}

        return f

    def tree(v):
        return {"a": _t(v[: n // 2]), "b": _t(v[n // 2:])}

    vt, (Vt, Wt), (it, _) = kt.bieigsolve((matvec(A), matvec(A.T)), tree(v0), tree(w0), 2, "LM",
                                          krylovdim=n, tol=1e-10, maxiter=30)
    assert eig_close(vt.numpy(), np.asarray(vj), 1e-10)
    assert (it.numops, it.numiter, it.converged) == (
        int(ij.numops), int(ij.numiter), int(ij.converged))
    assert it.converged >= 2
    v = torch.cat([Vt["a"][0], Vt["b"][0]]).numpy()
    vjv = np.concatenate([np.asarray(Vj["a"][0]), np.asarray(Vj["b"][0])])
    lam = complex(vt[0])
    assert np.linalg.norm(A.astype(complex) @ v - lam * v) <= 1e-6 * np.linalg.norm(v)
    assert abs(np.vdot(vjv, v)) / (np.linalg.norm(vjv) * np.linalg.norm(v)) == pytest.approx(1, abs=1e-6)
    # a bare callable: the adjoint is derived from it
    vd, _, (idd, _) = kt.bieigsolve(matvec(A), tree(v0), tree(w0), 2, "LM", krylovdim=n,
                                    tol=1e-10, maxiter=30)
    assert eig_close(vd.numpy(), vt.numpy(), 1e-10) and idd.numops == it.numops


def test_bieig_banded_float32_matches_jax():
    """The transport-diffusion tridiagonal as a banded operator (its adjoint
    the transposed planes), n = 4096, float32 ``(32, 128)`` vectors: K3's
    plain version here, the kernel both ways on the card."""
    nb = 4096
    i = np.arange(nb)
    rows = np.concatenate([i[1:], i, i[:-1]])
    cols = np.concatenate([i[1:] - 1, i, i[:-1] + 1])
    vals = np.concatenate([np.full(nb - 1, -1.3), np.full(nb, 2.0), np.full(nb - 1, -0.7)]
                          ).astype(np.float32)
    v0 = np.random.default_rng(1).standard_normal((nb // 128, 128)).astype(np.float32)
    w0 = np.random.default_rng(10).standard_normal((nb // 128, 128)).astype(np.float32)
    kw = dict(krylovdim=20, maxiter=3, tol=1e-30)
    vj, (Vj, Wj), (ij, _) = kk.bieigsolve(j_banded_from_coo(rows, cols, vals, nb),
                                          jnp.asarray(v0), jnp.asarray(w0), 4, "LM", **kw)
    top = kt.banded_from_coo(rows, cols, vals, nb, device="cpu")
    vt, (Vt, Wt), (it, _) = kt.bieigsolve(top, _t(v0), _t(w0), 4, "LM", **kw)
    assert (it.numops, it.numiter, it.converged) == (int(ij.numops), int(ij.numiter), 0)
    assert it.numiter == 3 and it.numops % 2 == 0
    np.testing.assert_allclose(np.abs(vt.numpy()), np.abs(np.asarray(vj)), rtol=1e-4)
    assert bool(torch.all(vt.abs() <= 4.0 + 1e-3))  # Gershgorin
    assert Vt.shape == (4, nb // 128, 128) and Vt.dtype == torch.complex64
    G = torch.einsum("ixy,jxy->ij", Wt.conj(), Vt)
    assert bool(torch.isfinite(G).all()) and bool((torch.diagonal(G).abs() > 0).all())


def test_bieig_front_end_refusals():
    rng = np.random.default_rng(67)
    A = _t(rand_mat(rng, n, n, np.float64))
    v0, w0 = _t(rand_vec(rng, n, np.float64)), _t(rand_vec(rng, n, np.float64))
    with pytest.raises(ValueError, match="exceeds krylovdim"):
        kt.bieigsolve(A, v0, w0, 5, krylovdim=4)
    with pytest.raises(ValueError, match="v0 and w0 are required"):
        kt.bieigsolve(lambda x: A @ x, v0, None, 2)
    with pytest.raises(NotImplementedError, match="no differentiation rule"):
        kt.bieigsolve(A.clone().requires_grad_(True), v0, w0, 2, krylovdim=n)
    # an explicit algorithm takes the keyword tol, as in the JAX package
    alg = kt.BiArnoldi(krylovdim=n, tol=1e-3, maxiter=30)
    _, _, (i1, _) = kt.bieigsolve(A, v0, w0, 2, alg=alg, tol=1e-10)
    _, _, (i2, _) = kt.bieigsolve(A, v0, w0, 2, alg=dataclasses.replace(alg, tol=1e-10))
    assert (i1.numops, i1.converged) == (i2.numops, i2.converged)


def test_biarnoldi_from_dict_matches_jax_fields():
    jalg = kk.BiArnoldi(krylovdim=17, maxiter=3, tol=1e-7, eager=True, verbosity=0)
    talg = convert.biarnoldi_from_dict({**dataclasses.asdict(jalg), "orth": "mgs2"})
    assert isinstance(talg, kt.BiArnoldi)
    for f in dataclasses.fields(jalg):
        if f.name != "orth":
            assert getattr(talg, f.name) == getattr(jalg, f.name), f.name
    assert talg.orth == kt.mgs2
    with pytest.raises(ValueError, match="unknown BiArnoldi fields"):
        convert.biarnoldi_from_dict({"reorth": "full"})
    # jax stays on the CPU in this suite
    assert jax.default_backend() == "cpu"
