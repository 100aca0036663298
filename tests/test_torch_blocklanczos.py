"""PyTorch port: Block Lanczos (``eigsolve`` with a ``Block`` start) and its
block QR against the JAX package on the CPU, mirroring
``tests/test_blocklanczos.py`` and ``tests/test_block_inner.py``.

The same numpy inputs, made from a seed, go to both packages.  Tolerances:
values rtol 1e-10 (float64, complex128); ``numops``, ``numiter`` and
``converged`` equal; residual norms compared as a set within 1e-3 of each
other or 1e-2·tol, since the basis of a repeated eigenvalue's eigenspace is
any rotation of it (the two packages' residual vectors inside one
eigenspace differ); block QR factors to 1e-12.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import krylovkit_tpu as kk
from chip_smoke import poisson_coo
from krylovkit_tpu.factorizations.blocklanczos import block_qr as j_block_qr
from krylovkit_tpu.ops import basis as jbs
from krylovkit_tpu.ops.pallas_spmv import banded_from_coo as j_banded_from_coo
from krylovkit_tpu.ops.vector import VectorSpace as JSpace
import krylovkit_tpu_torch as kt
from krylovkit_tpu_torch import convert
from krylovkit_tpu_torch.factorizations.blocklanczos import block_qr as t_block_qr
from krylovkit_tpu_torch.ops import basis as tbs
from testsetup import N, hermitize, mat_with_eigrepition, n, precision, rand_mat, rand_vec

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def assert_same(got, want, tol):
    vt, _, it = got
    vj, _, ij = want
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.sort(it.normres.numpy()), np.sort(np.asarray(ij.normres)),
                               rtol=1e-3, atol=1e-2 * tol)
    assert (it.numops, it.numiter, it.converged) == (
        int(ij.numops), int(ij.numiter), int(ij.converged))


def _blocks(rng, m, dtype, b):
    xs = [rand_vec(rng, m, dtype) for _ in range(b)]
    return kk.Block([jnp.asarray(x) for x in xs]), convert.block_from_numpy(xs, "cpu")


def test_block_qr_rank_detection_matches_jax():
    rng = np.random.default_rng(51)
    X = rng.standard_normal((4, 20))
    X[3] = X[0] + X[1]  # rank 3
    Qj, Cj, rj = j_block_qr(jnp.asarray(X), 1e-10)
    Qt, Ct, rt = t_block_qr(_t(X), 1e-10)
    assert rt == int(rj) == 3
    np.testing.assert_allclose(Qt.numpy(), np.asarray(Qj), atol=1e-12)
    np.testing.assert_allclose(Ct.numpy(), np.asarray(Cj), atol=1e-12)
    assert np.allclose(Qt.numpy()[3], 0)
    np.testing.assert_allclose(Ct.numpy().T @ Qt.numpy(), X, atol=1e-10)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_block_eigsolve_degenerate_matches_jax(dtype):
    """Top eigenvalue of multiplicity 3: the block method finds all of it
    (reference mat_with_eigrepition, test/testsetup.jl:46-58)."""
    rng = np.random.default_rng(52)
    A = mat_with_eigrepition(rng, N, 2, dtype)
    Xj, Xt = _blocks(rng, N, dtype, 4)
    kw = dict(krylovdim=40, tol=1e-9, maxiter=100)
    want = kk.eigsolve(A, Xj, 4, "LR", **kw)
    got = kt.eigsolve(_t(A), Xt, 4, "LR", **kw)
    assert_same(got, want, 1e-9)
    vals, vecs, info = got
    np.testing.assert_allclose(vals.numpy(), np.linalg.eigvalsh(A)[::-1][:4], atol=1e-7)
    assert info.converged >= 4 and vecs.shape == (4, N)
    for i in range(4):
        v = vecs[i].numpy()
        assert np.linalg.norm(A @ v - float(vals[i]) * v) <= 1e-6
    # residual vectors Σ_j X[j]·(S U)[j, i] carry the residual norms
    np.testing.assert_allclose(np.linalg.norm(info.residual.numpy(), axis=1),
                               info.normres.numpy(), rtol=1e-6, atol=1e-14)


def test_block_eigsolve_full_small_matches_jax():
    rng = np.random.default_rng(53)
    A = hermitize(rand_mat(rng, n, n, np.float64))
    Xj, Xt = _blocks(rng, n, np.float64, 2)
    kw = dict(krylovdim=n, tol=1e-10, maxiter=50)
    got = kt.eigsolve(_t(A), Xt, 3, "SR", **kw)
    assert_same(got, kk.eigsolve(A, Xj, 3, "SR", **kw), 1e-10)
    np.testing.assert_allclose(got[0].numpy(), np.linalg.eigvalsh(A)[:3], atol=1e-8)


def test_block_explicit_alg_matches_jax():
    rng = np.random.default_rng(54)
    A = mat_with_eigrepition(rng, n, 1, np.float64)
    Xj, Xt = _blocks(rng, n, np.float64, 2)
    jalg = kk.BlockLanczos(krylovdim=n, tol=1e-10, maxiter=50)
    talg = convert.blocklanczos_from_dict({**dataclasses.asdict(jalg), "orth": "cgs2"})
    assert talg.qr_tol == jalg.qr_tol == -1.0
    got = kt.eigsolve(_t(A), Xt, 2, "LR", alg=talg)
    assert_same(got, kk.eigsolve(A, Xj, 2, "LR", alg=jalg), 1e-10)
    np.testing.assert_allclose(got[0].numpy(), np.linalg.eigvalsh(A)[::-1][:2], atol=1e-8)


def test_block_dispatch_and_guards_match_jax():
    """A ``BlockLanczos`` without a ``Block`` raises; a ``Block`` with a
    Lanczos ``alg`` runs BlockLanczos from the keywords; an explicit
    ``qr_tol`` reaches the block QR."""
    rng = np.random.default_rng(55)
    A = hermitize(rand_mat(rng, n, n, np.float64))
    x = rand_vec(rng, n, np.float64)
    for pkg, conv in ((kk, jnp.asarray), (kt, _t)):
        with pytest.raises(ValueError, match="BlockLanczos requires a Block starting value x0"):
            pkg.eigsolve(conv(A), conv(x), 1, "LR", alg=pkg.BlockLanczos())
        with pytest.raises(ValueError, match="howmany=4 exceeds krylovdim=3"):
            pkg.eigsolve(conv(A), pkg.Block([conv(x), conv(x[::-1].copy())]), 4, "LR", krylovdim=3)
    Xj, Xt = _blocks(rng, n, np.float64, 3)
    kw = dict(krylovdim=n, tol=1e-10, maxiter=20)
    want = kk.eigsolve(A, Xj, 2, "SR", alg=kk.Lanczos(), **kw)
    got = kt.eigsolve(_t(A), Xt, 2, "SR", alg=kt.Lanczos(), **kw)
    assert_same(got, want, 1e-10)
    jalg = kk.BlockLanczos(krylovdim=n, tol=1e-10, maxiter=20, qr_tol=1e-6)
    talg = convert.blocklanczos_from_dict({**dataclasses.asdict(jalg), "orth": "cgs2"})
    assert_same(kt.eigsolve(_t(A), Xt, 2, "SR", alg=talg), kk.eigsolve(A, Xj, 2, "SR", alg=jalg),
                1e-10)
    assert len(Xt) == Xt.size == 3 and torch.equal(Xt[1], Xt.stacked[1])


def test_block_lanczos_banded_poisson_matches_jax():
    """The banded 2-D Poisson on a 16×16 grid, block of 4 from
    ``default_rng(5)``, ``"LR"``: the degenerate pairs λ(i, j) = λ(j, i)."""
    nx = 16
    coo = poisson_coo(np, nx, np.float64)
    rng = np.random.default_rng(5)
    xs = [rng.standard_normal((2, 128)) for _ in range(4)]
    kw = dict(krylovdim=30, tol=1e-8, maxiter=300)
    want = kk.eigsolve(j_banded_from_coo(*coo, nx * nx), kk.Block([jnp.asarray(x) for x in xs]),
                       4, "LR", **kw)
    got = kt.eigsolve(kt.banded_from_coo(*coo, nx * nx, device="cpu"),
                      convert.block_from_numpy(xs, "cpu"), 4, "LR", **kw)
    assert_same(got, want, 1e-8)
    th = np.pi * np.arange(1, nx + 1) / (nx + 1)
    lam = np.sort((4 - 2 * np.cos(th)[:, None] - 2 * np.cos(th)[None, :]).ravel())[::-1]
    np.testing.assert_allclose(got[0].numpy(), lam[:4], atol=1e-8)
    assert got[1].shape == (4, 2, 128)


def _h_spaces(H):
    """⟨x, y⟩_H = xᴴ H y in both packages (reference ``InnerProductVec``)."""
    Hj, Ht = jnp.asarray(H), _t(H)
    return (JSpace(inner_fn=lambda x, y: x.conj() @ (Hj @ y)),
            kt.VectorSpace(inner_fn=lambda x, y: x.conj() @ (Ht @ y)))


def _hpd(rng, m, dtype):
    C = rand_mat(rng, m, m, dtype)
    return (C @ C.conj().T + np.eye(m, dtype=dtype)).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_gram_and_block_qr_custom_inner_match_jax(dtype):
    """``bs.gram`` and a rank-deficient ``block_qr`` in ⟨·,·⟩_H (reference
    test/block.jl, "block_inner" and "block_qr!" for an abstract inner
    product)."""
    rng = np.random.default_rng(72)
    H = _hpd(rng, n, dtype)
    js, ts = _h_spaces(H)
    X = np.stack([rand_vec(rng, n, dtype) for _ in range(5)])
    X[2] = sum(c * w for c, w in zip(X[3:], rand_vec(rng, 2, dtype)))
    Y = np.stack([rand_vec(rng, n, dtype) for _ in range(4)])
    np.testing.assert_allclose(tbs.gram(_t(X), _t(Y), ts).numpy(),
                               np.asarray(jbs.gram(jnp.asarray(X), jnp.asarray(Y), js)), atol=1e-12)
    tol = precision(dtype)
    Qj, Cj, rj = j_block_qr(jnp.asarray(X), tol, js)
    Qt, Ct, rt = t_block_qr(_t(X), tol, ts)
    assert rt == int(rj) == 4
    np.testing.assert_allclose(Qt.numpy(), np.asarray(Qj), atol=1e-10)
    np.testing.assert_allclose(Ct.numpy(), np.asarray(Cj), atol=1e-10)
    Qm = Qt.numpy().T
    np.testing.assert_allclose(Qm[:, :4].conj().T @ H @ Qm[:, :4], np.eye(4), atol=1e-8)
    np.testing.assert_allclose(Qm @ Ct.numpy(), X.T, atol=1e-8)


def test_block_reorthogonalize_custom_inner_matches_jax():
    """One CGS sweep of a block against an H-orthonormal block QR factor
    leaves an H-orthogonal remainder, equal to the JAX package's to 1e-10
    (reference test/block.jl, "block_reorthogonalize!" for an abstract inner
    product)."""
    rng = np.random.default_rng(73)
    dtype = np.complex128
    H = _hpd(rng, n, dtype)
    js, ts = _h_spaces(H)
    X1 = np.stack([rand_vec(rng, n, dtype) for _ in range(4)])
    X0 = np.stack([rand_vec(rng, n, dtype) for _ in range(3)])
    Qj, _, rj = j_block_qr(jnp.asarray(X1), precision(dtype), js)
    Qt, _, rt = t_block_qr(_t(X1), precision(dtype), ts)
    assert rt == int(rj) == 4
    Yj = np.stack([x - np.tensordot(np.asarray(jbs.project(Qj, jnp.asarray(x), rt, js)), np.asarray(Qj),
                                    axes=[[0], [0]]) for x in X0])
    Yt = torch.stack([x - torch.tensordot(tbs.project(Qt, x, rt, ts), Qt, dims=([0], [0]))
                      for x in _t(X0)])
    np.testing.assert_allclose(Yt.numpy(), Yj, atol=1e-10)
    assert np.linalg.norm(tbs.gram(Yt, Qt, ts).numpy()) < 1e-8


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_blocklanczos_eigsolve_custom_inner_matches_jax(dtype):
    """``M = H⁻¹A`` is self-adjoint in ⟨·,·⟩_H: Block Lanczos in that space
    gives eig(H⁻¹A)."""
    rng = np.random.default_rng(74)
    H = _hpd(rng, n, dtype)
    A = rand_mat(rng, n, n, dtype)
    M = np.linalg.solve(H, (A + A.conj().T) / 2)
    js, ts = _h_spaces(H)
    Xj, Xt = _blocks(rng, n, dtype, 2)
    Mj, Mt = jnp.asarray(M), _t(M)
    kw = dict(krylovdim=n, tol=precision(dtype), maxiter=10)
    want = kk.eigsolve(lambda x: Mj @ x, Xj, howmany=2, which="LR", space=js, **kw)
    got = kt.eigsolve(lambda x: Mt @ x, Xt, howmany=2, which="LR", space=ts, **kw)
    assert_same(got, want, precision(dtype))
    w = np.sort(np.real(np.linalg.eigvals(M)))[::-1][:2]
    np.testing.assert_allclose(np.sort(got[0].numpy())[::-1], w, atol=1e-7)
