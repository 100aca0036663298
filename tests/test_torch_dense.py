"""PyTorch port: the masked dense projected-problem layer against the JAX
package, in float64.  Eigenvalues to 1e-12, eigenvectors up to sign; the
sort permutation must be identical, ties (the sentinel eigenvalues)
included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import krylovkit_tpu.dense as jd
from krylovkit_tpu.algorithms import EigSorter as JSorter
from krylovkit_tpu_torch import dense as td
from krylovkit_tpu_torch.algorithms import EigSorter

torch.set_num_threads(2)


def _sym(m, seed):
    A = np.random.default_rng(seed).standard_normal((m, m))
    return A + A.T


@pytest.mark.parametrize("k", [1, 5, 12])
def test_eigh_active_matches_jax(k):
    T = _sym(12, k)
    wj, Uj, vj = (np.asarray(a) for a in jd.eigh_active(jnp.asarray(T), k))
    wt, Ut, vt = (a.numpy() for a in td.eigh_active(torch.from_numpy(T), k))
    assert np.array_equal(vt, vj) and vt.sum() == k
    np.testing.assert_allclose(wt[vt], wj[vj], rtol=1e-12, atol=1e-12)
    # inactive (sentinel) eigenvalues equal too; vectors agree up to sign
    np.testing.assert_allclose(wt[~vt], wj[~vj], rtol=1e-12)
    for i in np.flatnonzero(vt):
        np.testing.assert_allclose(abs(Ut[:, i] @ Uj[:, i]), 1.0, rtol=1e-10)
    assert np.all(Ut[k:] == 0)


def test_masking_helpers_match_jax():
    T = _sym(9, 3)
    for k in (0, 4, 9):
        s_j = float(jd.spectrum_sentinel(jnp.asarray(T), k))
        s_t = float(td.spectrum_sentinel(torch.from_numpy(T), k))
        np.testing.assert_allclose(s_t, s_j, rtol=1e-14)  # row sums, any order
        np.testing.assert_array_equal(
            td.embed_active(torch.from_numpy(T), k, s_j).numpy(),
            np.asarray(jd.embed_active(jnp.asarray(T), k, s_j)),
        )
        np.testing.assert_allclose(
            td.active_support(torch.from_numpy(T), k).numpy(),
            np.asarray(jd.active_support(jnp.asarray(T), k)), rtol=1e-14,
        )
        np.testing.assert_array_equal(td.active_mask(9, k).numpy(), np.asarray(jd.active_mask(9, k)))


@pytest.mark.parametrize("which", ["LM", "SM", "LR", "SR", "sorter"])
def test_sort_perm_stable_with_sentinel_ties(which):
    # many exact ties, as the sentinel eigenvalues of a masked buffer give
    vals = np.array([3.0, -7.0, 9.0, 9.0, 9.0, -3.0, 9.0, 0.5, 9.0, 2.0])
    valid = np.array([1, 1, 0, 0, 0, 1, 0, 1, 0, 1], bool)
    wj, wt = which, which
    if which == "sorter":
        wj = JSorter(lambda v: v ** 2, rev=True)
        wt = EigSorter(lambda v: v ** 2, rev=True)
    pj = np.asarray(jd.sort_perm(jnp.asarray(vals), jnp.asarray(valid), wj))
    pt = td.sort_perm(torch.from_numpy(vals), torch.from_numpy(valid), wt).numpy()
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(
        td.which_key(torch.from_numpy(vals), wt).numpy(), np.asarray(jd.which_key(jnp.asarray(vals), wj))
    )


def test_which_key_rejects_unknown():
    with pytest.raises(ValueError):
        td.which_key(torch.zeros(3), "XX")


@pytest.mark.parametrize("k", [3, 8])
def test_geneigh_active_matches_jax(k):
    A = _sym(8, 20)
    Bm = np.random.default_rng(21).standard_normal((8, 8))
    Bm = Bm @ Bm.T + 8 * np.eye(8)
    wj, Xj, vj = (np.asarray(a) for a in jd.geneigh_active(jnp.asarray(A), jnp.asarray(Bm), k))
    wt, Xt, vt = (a.numpy() for a in td.geneigh_active(torch.from_numpy(A), torch.from_numpy(Bm), k))
    assert np.array_equal(vt, vj)
    np.testing.assert_allclose(wt[vt], wj[vj], rtol=1e-10)
    Ba = Bm[:k, :k]
    for i in np.flatnonzero(vt):
        np.testing.assert_allclose(abs(Xt[:k, i] @ Ba @ Xj[:k, i]), 1.0, rtol=1e-8)
