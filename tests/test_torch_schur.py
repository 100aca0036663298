"""PyTorch port: the dense Schur layer of the Arnoldi solvers (Hessenberg
reduction, complex and real Schur forms, their reordering and eigenvectors)
against the JAX package on the same numpy inputs.

QR sign conventions may differ between the two, so ``Q`` and the vectors
are held to invariants (``QᴴQ = I``, ``QᴴHQ = T``, residuals of the
eigenvectors) and the eigenvalues to the JAX functions' and numpy's:
float64 to 1e-10, float32 to 1e-4.  ``lanv2_rotation`` is scalar
arithmetic and must match closely."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import krylovkit_tpu.dense as jd
from krylovkit_tpu.dense.hessenberg import hessenberg_reduce as j_hessenberg_reduce
from krylovkit_tpu.algorithms import EigSorter as JSorter
from krylovkit_tpu_torch import dense as td
from krylovkit_tpu_torch.algorithms import EigSorter

torch.set_num_threads(2)

M, K = 12, 8  # buffer size, active size

# the JAX sort and its eigenvalues, compiled once per (which, k) for the
# module's cases (op by op each call traces and compiles its loops anew)
j_sort_schur_real = jax.jit(jd.sort_schur_real, static_argnums=(2, 3))
j_real_schur_eigvals = jax.jit(jd.real_schur_eigvals, static_argnums=(1,))


def rand_mat(rng, m, dtype):
    a = rng.standard_normal((m, m))
    if np.dtype(dtype).kind == "c":
        a = a + 1j * rng.standard_normal((m, m))
    return (a / np.sqrt(m)).astype(dtype)


def embed(Ak, m=M):
    """The active block in a larger buffer whose inactive corner is garbage
    that the kernels must ignore."""
    out = np.zeros((m, m), Ak.dtype)
    k = Ak.shape[0]
    out[:k, :k] = Ak
    out[k:, k:] += rand_mat(np.random.default_rng(99), m - k, Ak.dtype) * 7
    return out


def match(got, want, tol):
    """Permutation-tolerant eigenvalue comparison (greedy nearest matching)."""
    got = np.asarray(got, complex).copy()
    want = np.asarray(want, complex)
    assert got.shape == want.shape
    atol = tol * max(1.0, float(np.max(np.abs(want), initial=0.0)))
    for w in want:
        i = int(np.argmin(np.abs(got - w)))
        assert abs(got[i] - w) <= atol, (got, want)
        got[i] = np.inf


def tol_of(dtype):
    return 1e-10 if np.finfo(dtype).bits == 64 else 1e-4


@pytest.mark.parametrize("dtype", [np.float64, np.complex128, np.float32])
def test_hessenberg_reduce_matches_jax(dtype):
    A = rand_mat(np.random.default_rng(0), M, dtype) * 3
    Hj, Qj = (np.asarray(a) for a in j_hessenberg_reduce(jnp.asarray(A)))
    Ht, Qt = (a.numpy() for a in td.hessenberg_reduce(torch.from_numpy(A)))
    tol = tol_of(dtype)
    assert Ht.dtype == A.dtype
    assert np.abs(np.tril(Ht, -2)).max() == 0.0
    np.testing.assert_allclose(Qt.conj().T @ Qt, np.eye(M), atol=tol)
    np.testing.assert_allclose(Qt.conj().T @ A @ Qt, Ht, atol=10 * tol)
    # the same reflectors in the same order: the factors agree entrywise
    np.testing.assert_allclose(Ht, Hj, atol=10 * tol)
    np.testing.assert_allclose(Qt, Qj, atol=10 * tol)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128, np.float32])
@pytest.mark.parametrize("kind", ["hessenberg", "general", "kschur"])
def test_schur_active_matches_jax(dtype, kind):
    rng = np.random.default_rng(3)
    Ak = rand_mat(rng, K, dtype) * 3
    if kind == "hessenberg":
        Ak = np.triu(Ak, -1)
    elif kind == "kschur":
        # triangular + spike row + one Hessenberg column, as after a restart
        Ak = np.triu(Ak)
        Ak[K - 2, : K - 2] = rng.standard_normal(K - 2)
        Ak[K - 1, K - 2] = 0.7
    A = embed(Ak)
    Tj, _, okj = jd.schur_active(jnp.asarray(A), K)
    T, Q, ok = td.schur_active(torch.from_numpy(A), K)
    Tn, Qn = T.numpy(), Q.numpy()
    tol = tol_of(dtype)
    assert ok and bool(okj)
    assert Tn.dtype == np.result_type(dtype, np.complex64)
    np.testing.assert_allclose(Qn.conj().T @ Qn, np.eye(M), atol=tol)
    # Q is block-diagonal and the similarity holds on the active block
    assert np.max(np.abs(Qn[K:, :K])) < tol and np.max(np.abs(Qn[:K, K:])) < tol
    np.testing.assert_allclose(Qn[:K, :K].conj().T @ Ak @ Qn[:K, :K], Tn[:K, :K], atol=10 * tol)
    assert np.max(np.abs(np.tril(Tn[:K, :K], -1))) == 0.0
    match(np.diag(Tn)[:K], np.linalg.eigvals(Ak.astype(np.complex128)), 10 * tol)
    match(td.schur_eigvals(T).numpy()[:K], np.asarray(jd.schur_eigvals(Tj))[:K], 10 * tol)


def test_schur_active_defective():
    """A Jordan-like (defective) block must still deflate, as in JAX."""
    Ak = np.eye(6) + np.diag(np.ones(5), 1)
    Ak[5, 0] = 1e-3
    A = embed(Ak)
    Tj, _, okj = jd.schur_active(jnp.asarray(A), 6)
    T, _, ok = td.schur_active(torch.from_numpy(A), 6)
    assert ok and bool(okj)
    match(np.diag(T.numpy())[:6], np.linalg.eigvals(Ak), 1e-8)
    match(np.diag(T.numpy())[:6], np.diag(np.asarray(Tj))[:6], 1e-8)


@pytest.mark.parametrize("k", [0, 1, 2])
def test_schur_active_tiny_blocks(k):
    A = embed(rand_mat(np.random.default_rng(5), max(k, 1), np.float64)[:k, :k])
    T, Q, ok = td.schur_active(torch.from_numpy(A), k)
    assert ok
    match(np.diag(T.numpy())[:k], np.linalg.eigvals(A[:k, :k]) if k else np.zeros(0), 1e-12)
    Tr, Qr, okr = td.real_schur_active(torch.from_numpy(A), k)
    assert okr
    np.testing.assert_allclose(Qr.numpy().T @ Qr.numpy(), np.eye(M), atol=1e-12)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_triangular_eigvecs_matches_jax(dtype):
    Ak = rand_mat(np.random.default_rng(4), K, dtype) * 2
    T, _, _ = td.schur_active(torch.from_numpy(embed(Ak)), K)
    X = td.triangular_eigvecs(T, K).numpy()
    Xj = np.asarray(jd.triangular_eigvecs(jnp.asarray(T.numpy()), K))
    Tn = T.numpy()[:K, :K]
    lam = np.diag(Tn)
    for i in range(K):
        r = Tn @ X[:K, i] - lam[i] * X[:K, i]
        assert np.linalg.norm(r) < 1e-10
        assert abs(np.linalg.norm(X[:, i]) - 1) < 1e-12
    # same triangular factor in, same vectors out (no sign freedom: x_i = 1)
    np.testing.assert_allclose(X, Xj, atol=1e-10)
    np.testing.assert_array_equal(X[:, K:], np.eye(M)[:, K:])


@pytest.mark.parametrize("which", ["LM", "SR", "LI", "sorter"])
def test_sort_schur_matches_jax(which):
    Ak = rand_mat(np.random.default_rng(5), K, np.complex128) * 2
    T, Q, _ = td.schur_active(torch.from_numpy(embed(Ak)), K)
    wt, wj = which, which
    if which == "sorter":
        wt = EigSorter(by=lambda v: torch.real(v), rev=True)
        wj = JSorter(by=lambda v: jnp.real(v), rev=True)
    key = td.which_key(torch.diagonal(T), wt)
    keyj = jd.which_key(jnp.asarray(np.diag(T.numpy())), wj)
    np.testing.assert_allclose(key.numpy(), np.asarray(keyj), rtol=1e-14)
    key = torch.where(torch.arange(M) < K, key, torch.full_like(key, float("inf")))
    T0, Q0 = T.clone(), Q.clone()
    T2, Q2, key2 = td.sort_schur(T, Q, key)
    assert torch.equal(T, T0) and torch.equal(Q, Q0)  # inputs untouched
    Tj2, Qj2, keyj2 = jd.sort_schur(jnp.asarray(T.numpy()), jnp.asarray(Q.numpy()),
                                    jnp.asarray(key.numpy()))
    T2n, Q2n = T2.numpy(), Q2.numpy()
    assert np.all(np.diff(key2.numpy()[:K]) >= 0)
    np.testing.assert_allclose(Q2n[:K, :K].conj().T @ Ak @ Q2n[:K, :K], T2n[:K, :K], atol=1e-10)
    assert np.max(np.abs(np.tril(T2n[:K, :K], -1))) == 0.0
    match(np.diag(T2n)[:K], np.linalg.eigvals(Ak), 1e-10)
    # the same rotations on the same input: entrywise agreement with JAX
    np.testing.assert_allclose(key2.numpy(), np.asarray(keyj2), rtol=1e-14)
    np.testing.assert_allclose(T2n, np.asarray(Tj2), atol=1e-10)
    np.testing.assert_allclose(Q2n, np.asarray(Qj2), atol=1e-10)


def test_partition_schur_matches_jax():
    Ak = rand_mat(np.random.default_rng(6), K, np.complex128) * 2
    T, Q, _ = td.schur_active(torch.from_numpy(embed(Ak, K)), K)
    select = np.array([0, 1, 0, 0, 1, 1, 0, 1], bool)
    T2, Q2, nsel = td.partition_schur(T, Q, torch.from_numpy(select))
    Tj2, _, nj = jd.partition_schur(jnp.asarray(T.numpy()), jnp.asarray(Q.numpy()),
                                    jnp.asarray(select))
    assert nsel == int(nj) == 4
    d = np.diag(T.numpy())
    # stable: the selected eigenvalues lead, each group in its old order
    np.testing.assert_allclose(np.diag(T2.numpy()), np.concatenate([d[select], d[~select]]),
                               atol=1e-10)
    np.testing.assert_allclose(T2.numpy(), np.asarray(Tj2), atol=1e-10)
    Q2n = Q2.numpy()
    np.testing.assert_allclose(Q2n.conj().T @ Ak @ Q2n, T2.numpy(), atol=1e-10)


def test_lanv2_rotation_matches_jax():
    rng = np.random.default_rng(7)
    blocks = [rng.standard_normal(4) for _ in range(20)]
    blocks += [np.array(b, float) for b in
               [(1, 2, -2, 1), (1, 0, 0, 2), (0, 0, 0, 0), (3, 1, 0, 3), (2, 0, 5, 2), (1, 1, -1, 1)]]
    for a, b, c, d in blocks:
        csj, snj = (float(v) for v in jd.lanv2_rotation(*(jnp.float64(v) for v in (a, b, c, d))))
        cs, sn = (float(v) for v in td.lanv2_rotation(
            *(torch.tensor(v, dtype=torch.float64) for v in (a, b, c, d))))
        np.testing.assert_allclose([cs, sn], [csj, snj], atol=1e-14)
        G = np.array([[cs, -sn], [sn, cs]])
        S = G.T @ np.array([[a, b], [c, d]]) @ G
        if ((a - d) / 2) ** 2 + b * c >= 0:
            assert abs(S[1, 0]) < 1e-12 * max(1, np.abs(S).max())  # triangularized
        else:
            assert abs(S[0, 0] - S[1, 1]) < 1e-12 * max(1, np.abs(S).max())  # standard form


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("k", [3, 9, 16])
def test_real_schur_active_random(k, dtype):
    rng = np.random.default_rng(k)
    m = 16
    H = np.zeros((m, m), dtype)
    H[:k, :k] = rng.standard_normal((k, k))
    Tj, _, okj = jd.real_schur_active(jnp.asarray(H), k)
    T, Q, ok = td.real_schur_active(torch.from_numpy(H), k)
    Tn, Qn = T.numpy(), Q.numpy()
    tol = tol_of(dtype)
    assert ok and bool(okj) and Tn.dtype == dtype
    np.testing.assert_allclose(Qn.T @ Qn, np.eye(m), atol=tol)
    np.testing.assert_allclose(Qn[:k, :k].T @ H[:k, :k] @ Qn[:k, :k], Tn[:k, :k], atol=30 * tol)
    # quasi-triangular, no two adjacent 2x2 blocks overlapping
    assert np.abs(np.tril(Tn, -2)).max() == 0.0
    sub = np.abs(np.diagonal(Tn, -1)[: k - 1]) > 0
    assert not np.any(sub[:-1] & sub[1:])
    re, im = td.real_schur_eigvals(T, k)
    lam = re.numpy()[:k] + 1j * im.numpy()[:k]
    match(lam, np.linalg.eigvals(H[:k, :k].astype(np.float64)), 100 * tol)
    rej, imj = jd.real_schur_eigvals(Tj, k)
    match(lam, np.asarray(rej)[:k] + 1j * np.asarray(imj)[:k], 100 * tol)
    np.testing.assert_array_equal(td.block_starts(T, k).numpy(),
                                  np.asarray(jd.block_starts(jnp.asarray(Tn), k)))


def test_real_schur_rotation_blocks():
    # an orthogonal similarity of a block-diagonal of rotations: all pairs
    rng = np.random.default_rng(1)
    k = 10
    R = np.zeros((k, k))
    for i, t in enumerate(rng.uniform(0.3, 2.8, k // 2)):
        R[2 * i: 2 * i + 2, 2 * i: 2 * i + 2] = [[np.cos(t), -np.sin(t)], [np.sin(t), np.cos(t)]]
    P = np.linalg.qr(rng.standard_normal((k, k)))[0]
    H = P @ R @ P.T
    T, Q, ok = td.real_schur_active(torch.from_numpy(H), k)
    re, im = td.real_schur_eigvals(T, k)
    match(re.numpy() + 1j * im.numpy(), np.linalg.eigvals(H), 1e-10)
    Tj, _, _ = jd.real_schur_active(jnp.asarray(H), k)
    rej, imj = jd.real_schur_eigvals(Tj, k)
    match(re.numpy() + 1j * im.numpy(), np.asarray(rej) + 1j * np.asarray(imj), 1e-10)
    # every eigenvalue is complex: 5 standardized 2x2 blocks
    assert int(td.block_starts(T, k).sum()) == 5 == int(np.sum(np.asarray(jd.block_starts(Tj, k))))
    Tn = T.numpy()
    for i in range(0, k, 2):
        assert abs(Tn[i, i] - Tn[i + 1, i + 1]) < 1e-12 and Tn[i, i + 1] * Tn[i + 1, i] < 0


def _block_keys(lam, im, which, k):
    keyfn = {"LM": lambda v: -np.abs(v), "SM": lambda v: np.abs(v),
             "LR": lambda v: -v.real, "SR": lambda v: v.real}[which]
    keys = keyfn(lam)
    i, kl = 0, []
    while i < k:
        kl.append(keys[i])
        i += 2 if im[i] != 0 else 1
    return np.array(kl)


@pytest.mark.parametrize("which", ["LM", "LR", "SR"])
def test_sort_schur_real_matches_jax(which):
    rng = np.random.default_rng(2)
    m, k = 14, 12
    H = np.zeros((m, m))
    H[:k, :k] = rng.standard_normal((k, k))
    T, Q, _ = td.real_schur_active(torch.from_numpy(H), k)
    Ts, Qs = td.sort_schur_real(T, Q, which, k)
    Tsn, Qsn = Ts.numpy(), Qs.numpy()
    np.testing.assert_allclose(Qsn.T @ Qsn, np.eye(m), atol=1e-12)
    np.testing.assert_allclose(Qsn[:k, :k].T @ H[:k, :k] @ Qsn[:k, :k], Tsn[:k, :k], atol=1e-9)
    re, im = (a.numpy() for a in td.real_schur_eigvals(Ts, k))
    kl = _block_keys(re[:k] + 1j * im[:k], im, which, k)
    assert np.all(kl[:-1] <= kl[1:] + 1e-10)
    # the JAX sort of the same (T, Q): same schedule, same eigenvalue order
    Tjs, Qjs = j_sort_schur_real(jnp.asarray(T.numpy()), jnp.asarray(Q.numpy()), which, k)
    rej, imj = (np.asarray(a) for a in j_real_schur_eigvals(Tjs, k))
    np.testing.assert_allclose(re[:k], rej[:k], atol=1e-10)
    np.testing.assert_allclose(np.abs(im[:k]), np.abs(imj[:k]), atol=1e-10)
    np.testing.assert_allclose(Tsn, np.asarray(Tjs), atol=1e-9)
    np.testing.assert_allclose(Qsn, np.asarray(Qjs), atol=1e-9)


@pytest.mark.parametrize("seed", range(5))
def test_sort_schur_real_stress(seed):
    """Adversarial orderings for the odd-even block-transposition schedule:
    reverse-sorted spectra (every block travels the full distance), mixed
    1x1/2x2 block patterns; checks the similarity invariant, orthogonality,
    standard form of the surviving 2x2 blocks, the key ordering, and the
    eigenvalue order against the JAX sort."""
    rng = np.random.default_rng(100 + seed)
    m, k = 31, 28
    H = np.zeros((m, m))
    # descending real parts: the LR sort reverses everything
    H[:k, :k] = rng.standard_normal((k, k)) + np.diag(np.linspace(k, 1, k))
    T, Q, ok = td.real_schur_active(torch.from_numpy(H), k)
    assert ok
    exact = np.linalg.eigvals(H[:k, :k])
    for which in ("SR", "LR", "LM", "SM"):
        Ts, Qs = td.sort_schur_real(T, Q, which, k)
        Tsn, Qsn = Ts.numpy(), Qs.numpy()
        assert np.abs(Qsn.T @ Qsn - np.eye(m)).max() < 1e-11
        assert np.abs(Qsn[:k, :k].T @ H[:k, :k] @ Qsn[:k, :k] - Tsn[:k, :k]).max() < 1e-8
        assert np.abs(np.tril(Tsn[:k, :k], -2)).max() == 0.0
        sub = np.abs(np.diagonal(Tsn, -1)[: k - 1]) > 0
        assert not np.any(sub[:-1] & sub[1:])
        for i in np.nonzero(sub)[0]:
            assert abs(Tsn[i, i] - Tsn[i + 1, i + 1]) < 1e-8 * max(1, abs(Tsn[i, i]))
        re, im = (a.numpy() for a in td.real_schur_eigvals(Ts, k))
        lam = re[:k] + 1j * im[:k]
        match(lam, exact, 1e-6)
        kl = _block_keys(lam, im, which, k)
        assert np.all(kl[:-1] <= kl[1:] + 1e-9)
        Tjs, _ = j_sort_schur_real(jnp.asarray(T.numpy()), jnp.asarray(Q.numpy()), which, k)
        rej, imj = (np.asarray(a) for a in j_real_schur_eigvals(Tjs, k))
        np.testing.assert_allclose(re[:k], rej[:k], atol=1e-7)
        np.testing.assert_allclose(np.abs(im[:k]), np.abs(imj[:k]), atol=1e-7)


def test_triangular_eigvecs_real_matches_jax():
    rng = np.random.default_rng(3)
    m, k = 14, 11
    H = np.zeros((m, m))
    H[:k, :k] = rng.standard_normal((k, k))
    T, _, _ = td.real_schur_active(torch.from_numpy(H), k)
    Xre, Xim = td.triangular_eigvecs_real(T, k)
    re, im = td.real_schur_eigvals(T, k)
    Tn = T.numpy()
    X = Xre.numpy() + 1j * Xim.numpy()
    lam = re.numpy() + 1j * im.numpy()
    R = Tn[:k, :k] @ X[:k, :k] - X[:k, :k] * lam[None, :k]
    assert np.abs(R).max() < 1e-10
    # conjugate-pair convention: adjacent columns are conjugates
    for i in np.nonzero(td.block_starts(T, k).numpy())[0]:
        assert np.abs(X[:, i + 1] - X[:, i].conj()).max() < 1e-12
    Xrej, Ximj = jd.triangular_eigvecs_real(jnp.asarray(Tn), k)
    np.testing.assert_allclose(Xre.numpy(), np.asarray(Xrej), atol=1e-10)
    np.testing.assert_allclose(Xim.numpy(), np.asarray(Ximj), atol=1e-10)


@pytest.mark.parametrize("which", ["LM", "SM", "LR", "SR", "LI", "SI", "sorter"])
def test_which_key_complex_and_ri_match_jax(which):
    rng = np.random.default_rng(8)
    re, im = rng.standard_normal(9), rng.standard_normal(9)
    wt, wj = which, which
    if which == "sorter":
        wt = EigSorter(by=lambda v: torch.abs(v - 1), rev=False)
        wj = JSorter(by=lambda v: jnp.abs(v - 1), rev=False)
    want = np.asarray(jd.which_key(jnp.asarray(re + 1j * im), wj))
    got = td.which_key(torch.from_numpy(re + 1j * im), wt).numpy()
    got_ri = td.which_key_ri(torch.from_numpy(re), torch.from_numpy(im), wt).numpy()
    want_ri = np.asarray(jd.which_key_ri(jnp.asarray(re), jnp.asarray(im), wj))
    np.testing.assert_allclose(got, want, rtol=1e-14)
    np.testing.assert_allclose(got_ri, want_ri, rtol=1e-14)
    np.testing.assert_allclose(got_ri, got, rtol=1e-14)
    assert got.dtype == np.float64
