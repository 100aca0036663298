"""PyTorch port: stacked-basis kernels, the plain version of the in-place
transform kernel, and the orthogonalizers, against the JAX package.
Float64 cases agree to 1e-12; the float32 transform to atol 1e-5 with its
tail rows bit-identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import krylovkit_tpu.ops.basis as jbs
import krylovkit_tpu.ops.orthonormal as jon
from krylovkit_tpu_torch import _build
from krylovkit_tpu_torch.ops import basis as tbs
from krylovkit_tpu_torch.ops import orthonormal as ton

torch.set_num_threads(2)


def _basis(kmax=13, R=16, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    V = rng.standard_normal((kmax, R, 128)).astype(dtype)
    x = rng.standard_normal((R, 128)).astype(dtype)
    return V, x


@pytest.mark.parametrize("kmax", [5, 8, 13, 31, 70, 200])
def test_buckets_match_jax(kmax):
    assert tbs.buckets_for(kmax) == jbs.buckets_for(kmax)
    buckets = jbs.buckets_for(kmax)
    for k in range(1, kmax + 1):
        assert tbs.bucket_for(k, kmax) == buckets[int(jbs.bucket_index(k, buckets))]


@pytest.mark.parametrize("k", [1, 6, 13])
def test_project_unproject_match_jax(k):
    V, x = _basis()
    c = np.random.default_rng(1).standard_normal(13)
    c[k:] = 0
    Vt, xt, ct = map(torch.from_numpy, (V, x, c))
    for jf, tf in ((jbs.project, tbs.project), (jbs.project_bucketed, tbs.project_bucketed)):
        np.testing.assert_allclose(
            tf(Vt, xt, k).numpy(), np.asarray(jf(jnp.asarray(V), jnp.asarray(x), k)),
            rtol=1e-12, atol=1e-12,
        )
    np.testing.assert_allclose(
        tbs.unproject(Vt, ct).numpy(), np.asarray(jbs.unproject(jnp.asarray(V), jnp.asarray(c))),
        rtol=1e-12, atol=1e-12,
    )
    np.testing.assert_allclose(
        tbs.unproject_bucketed(Vt, ct, k).numpy(),
        np.asarray(jbs.unproject_bucketed(jnp.asarray(V), jnp.asarray(c), k)),
        rtol=1e-12, atol=1e-12,
    )


def test_transform_gram_batch_inner_match_jax():
    V, _ = _basis(seed=2)
    W, _ = _basis(seed=3)
    U = np.random.default_rng(4).standard_normal((13, 13))
    Vt, Wt, Ut = map(torch.from_numpy, (V, W, U))
    np.testing.assert_allclose(
        tbs.transform(Vt, Ut).numpy(), np.asarray(jbs.transform(jnp.asarray(V), jnp.asarray(U))),
        rtol=1e-12, atol=1e-12,
    )
    np.testing.assert_allclose(
        tbs.gram(Vt, Wt).numpy(), np.asarray(jbs.gram(jnp.asarray(V), jnp.asarray(W))),
        rtol=1e-12,
    )
    np.testing.assert_allclose(
        tbs.batch_inner(Vt, Wt).numpy(),
        np.asarray(jbs.batch_inner(jnp.asarray(V), jnp.asarray(W))), rtol=1e-12,
    )


@pytest.mark.parametrize("kmax,R,m_out", [(11, 16, 6), (31, 32, 20), (31, 32, 4)])
def test_transform_inplace_reference_matches_pallas(kmax, R, m_out):
    rng = np.random.default_rng(7)
    V = rng.standard_normal((kmax, R, 128)).astype(np.float32)
    U = rng.standard_normal((kmax, kmax)).astype(np.float32)
    want = np.asarray(
        jbs._pallas_transform_inplace(jnp.asarray(V), jnp.asarray(U), m_out, interpret=True)
    )
    got = tbs.transform_partial_inplace_reference(torch.from_numpy(V.copy()),
                                                  torch.from_numpy(U), m_out).numpy()
    np.testing.assert_allclose(got[:m_out], want[:m_out], atol=1e-5)
    # rows >= m_out: bit-identical to the input (tail preservation contract)
    assert np.array_equal(got[m_out:], V[m_out:])
    assert np.array_equal(got[m_out:], want[m_out:])


def test_transform_partial_routes_cpu_tensors_to_plain_version():
    V, _ = _basis(kmax=9, R=8, seed=8, dtype=np.float32)
    eye = torch.eye(9)
    before = dict(_build.launches)
    Vt = torch.from_numpy(V.copy())
    out = tbs.transform_partial(Vt, eye, 4)
    assert out.data_ptr() == Vt.data_ptr()  # in place
    assert np.array_equal(out.numpy(), V)  # identity: bit-exact on every row
    assert dict(_build.launches) == before  # no kernel on the CPU
    # a basis the kernel does not take gets the full product, as in JAX
    flat = torch.from_numpy(V.reshape(9, -1)[:, :100].copy())
    U = torch.from_numpy(np.random.default_rng(9).standard_normal((9, 9)).astype(np.float32))
    np.testing.assert_allclose(
        tbs.transform_partial(flat, U, 4).numpy(),
        np.asarray(jbs.transform_partial(jnp.asarray(flat.numpy()), jnp.asarray(U.numpy()), 4)),
        rtol=1e-5, atol=1e-5,
    )
    with pytest.raises(ValueError):
        tbs.transform_partial_inplace(Vt, eye[:4], 4)


ORTHS = ["cgs", "mgs", "cgs2", "mgs2", "cgsir", "mgsir"]


@pytest.mark.parametrize("k", [1, 7])
@pytest.mark.parametrize("orth", ORTHS)
def test_orthonormalize_matches_jax(orth, k):
    rng = np.random.default_rng(10)
    kmax = 12
    Q, _ = np.linalg.qr(rng.standard_normal((4 * 128, kmax)))
    V = Q.T.reshape(kmax, 4, 128).copy()
    # w nearly in span(V[:k]) so the refinement loops of the IR variants run
    w = (Q[:, :k] @ rng.standard_normal(k) + 1e-6 * rng.standard_normal(4 * 128)).reshape(4, 128)
    vj, bj, cj = jon.orthonormalize(jnp.asarray(w), jnp.asarray(V), k, getattr(jon, orth))
    vt, bt, ct = ton.orthonormalize(torch.from_numpy(w), torch.from_numpy(V), k,
                                    getattr(ton, orth))
    np.testing.assert_allclose(float(bt), float(bj), rtol=1e-10)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-8, atol=1e-10)
    assert np.all(ct.numpy()[k:] == 0)


def test_mask_coeffs_and_append_scaled_match_jax():
    """``mask_coeffs`` (zero ``c[j]`` for ``j >= k``; the masking of
    ``tests/test_pallas.py:89-97``'s unproject check) and ``append_scaled``
    (``y + α·(V c)``) against the JAX package's, float64 to 1e-12; the
    masked coefficients are exact."""
    V, y = _basis(seed=5)
    c = np.random.default_rng(6).standard_normal(13)
    Vt, yt, ct = map(torch.from_numpy, (V, y, c))
    for k in (0, 1, 4, 13):
        cm = tbs.mask_coeffs(ct, k)
        np.testing.assert_array_equal(cm.numpy(), np.asarray(jbs.mask_coeffs(jnp.asarray(c), k)))
        for alpha in (1.0, -0.5):
            np.testing.assert_allclose(
                tbs.append_scaled(yt, Vt, cm, alpha).numpy(),
                np.asarray(jbs.append_scaled(jnp.asarray(y), jnp.asarray(V), jnp.asarray(cm),
                                             alpha)),
                rtol=1e-12, atol=1e-12)
    # a pytree basis: leaf by leaf
    tree = tbs.append_scaled((yt, yt[:2]), (Vt, Vt[:, :2]), ct, 2.0)
    jtree = jbs.append_scaled((jnp.asarray(y), jnp.asarray(y[:2])),
                              (jnp.asarray(V), jnp.asarray(V[:, :2])), jnp.asarray(c), 2.0)
    for a, b in zip(tree, jtree):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-12)
