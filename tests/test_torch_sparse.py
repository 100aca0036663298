"""PyTorch port: the ELL operator (``ops/sparse.py``), ``ell_to_banded`` and
the complex ``BandedOperator`` against the JAX package on the CPU,
mirroring the ELL cases of ``tests/test_sparse_and_spaces.py``.

The same numpy inputs, made from a seed, go to both packages.  Tolerances:
the packing (``_coo_to_ell``) and the banded planes of ``ell_to_banded``
bit for bit; applies 1e-12 of ``Σ|a_ij||x_j|`` in float64/complex128 and
1e-6 in float32/complex64 (the two sum a row's products in different
orders); solves as in the other parity files (values rtol 1e-10, counts
equal).  The dict-vector and sharded-mesh cases are not mirrored here:
pytree vectors are in ``tests/test_torch_pytree.py`` and
``tests/test_torch_pytree_drivers.py``, the sharded ones in
``tests/test_torch_parallel_sparse.py`` and ``tests/test_torch_sharded.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import krylovkit_tpu as kk
from chip_smoke import poisson_coo
from krylovkit_tpu.ops import sparse as jsp
from krylovkit_tpu.ops.pallas_spmv import banded_from_coo as j_banded_from_coo
from krylovkit_tpu.ops.pallas_spmv import ell_to_banded as j_ell_to_banded
import krylovkit_tpu_torch as kt
from krylovkit_tpu_torch import convert
from krylovkit_tpu_torch.ops import sparse as tsp
from testsetup import rand_mat, rand_vec

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _tol(dtype):
    return 1e-6 if np.dtype(dtype) in (np.float32, np.complex64) else 1e-12


def _random_coo(rng, n_rows, n_cols, nnz, dtype):
    """Unsorted COO triplets with duplicate entries and empty rows."""
    rows = rng.integers(0, n_rows - 2, nnz)  # the last two rows stay empty
    cols = rng.integers(0, n_cols, nnz)
    rows, cols = np.concatenate([rows, rows[:7]]), np.concatenate([cols, cols[:7]])
    return rows, cols, rand_vec(rng, rows.size, dtype)


@pytest.mark.parametrize("shape,nnz", [((30, 20), 90), ((64, 64), 300), ((5, 40), 12),
                                       ((200, 150), 1000)])
@pytest.mark.parametrize("dtype", [np.float64, np.complex64])
def test_coo_to_ell_is_bit_equal_to_jax(shape, nnz, dtype):
    rng = np.random.default_rng(100 + nnz)
    rows, cols, vals = _random_coo(rng, *shape, nnz, dtype)
    jc, jv = jsp._coo_to_ell(rows, cols, vals, *shape)
    tc, tv = tsp._coo_to_ell(rows, cols, vals, *shape)
    assert tc.dtype == jc.dtype == np.int32 and tv.dtype == jv.dtype
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tv, jv)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex128])
def test_ell_matvec_matches_jax_and_dense(dtype):
    rng = np.random.default_rng(101)
    A = rand_mat(rng, 30, 20, dtype)
    A[np.abs(A) < 0.15] = 0
    jop = jsp.from_dense(A)
    top = kt.sparse.from_dense(A, device="cpu")
    assert top.shape == jop.shape == (30, 20)
    np.testing.assert_array_equal(top.cols.numpy(), np.asarray(jop.cols))
    np.testing.assert_array_equal(top.vals.numpy(), np.asarray(jop.vals))
    np.testing.assert_array_equal(top.adj.cols.numpy(), np.asarray(jop.adj.cols))
    x = rand_vec(rng, 20, dtype)
    y = rand_vec(rng, 30, dtype)
    for got, want, M, v in ((top.normal(_t(x)), jop.normal(jnp.asarray(x)), A, x),
                            (top.apply_adjoint(_t(y)), jop.apply_adjoint(jnp.asarray(y)),
                             A.conj().T, y)):
        scale = np.abs(M) @ np.abs(v)
        assert got.dtype == _t(v).dtype
        assert np.all(np.abs(got.numpy() - np.asarray(want)) <= _tol(dtype) * scale)
        assert np.all(np.abs(got.numpy() - M @ v) <= _tol(dtype) * scale)


def test_ell_from_arrays_carries_the_jax_planes():
    rng = np.random.default_rng(102)
    A = rand_mat(rng, 25, 25, np.complex128)
    A[np.abs(A) < 0.2] = 0
    jop = jsp.from_dense(A)
    top = convert.ell_from_arrays(np.asarray(jop.cols), np.asarray(jop.vals), jop.n_cols,
                                  np.asarray(jop.adj.cols), np.asarray(jop.adj.vals), device="cpu")
    x = rand_vec(rng, 25, np.complex128)
    np.testing.assert_allclose(top.apply_adjoint(top.normal(_t(x))).numpy(),
                               np.asarray(jop.apply_adjoint(jop.normal(jnp.asarray(x)))), atol=1e-12)
    assert top.adj.shape == (25, 25)


def test_ell_eigsolve_laplacian_matches_jax():
    N_ = 200
    rows = np.concatenate([np.arange(N_), np.arange(N_ - 1), np.arange(1, N_)])
    cols = np.concatenate([np.arange(N_), np.arange(1, N_), np.arange(N_ - 1)])
    vals = np.concatenate([2 * np.ones(N_), -np.ones(N_ - 1), -np.ones(N_ - 1)])
    x0 = np.random.default_rng(0).standard_normal(N_)
    kw = dict(ishermitian=True, tol=1e-10, krylovdim=30, maxiter=200)
    vj, _, ij = kk.eigsolve(jsp.from_coo(rows, cols, vals, (N_, N_)), jnp.asarray(x0), 3, "SR", **kw)
    vt, _, it = kt.eigsolve(kt.sparse.from_coo(rows, cols, vals, (N_, N_), device="cpu"), _t(x0), 3,
                            "SR", **kw)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-10)
    assert (it.numops, it.numiter, it.converged) == (int(ij.numops), int(ij.numiter), int(ij.converged))
    np.testing.assert_allclose(vt.numpy(), 2 - 2 * np.cos(np.pi * np.arange(1, 4) / (N_ + 1)), atol=1e-8)


def test_ell_linsolve_matches_jax():
    rng = np.random.default_rng(102)
    A = rand_mat(rng, 50, 50, np.float64)
    A[np.abs(A) < 0.1] = 0
    A = A + 3 * np.eye(50)
    b = rand_vec(rng, 50, np.float64)
    xj, ij = kk.linsolve(jsp.from_dense(A), jnp.asarray(b), tol=1e-10, krylovdim=40)
    xt, it = kt.linsolve(kt.sparse.from_dense(A, device="cpu"), _t(b), tol=1e-10, krylovdim=40)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-10, atol=1e-12)
    assert (it.numops, it.numiter, it.converged) == (int(ij.numops), int(ij.numiter), 1)
    assert np.linalg.norm(A @ xt.numpy() - b) <= 1e-8


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_ell_to_banded_matches_jax(dtype):
    """The 2-D Poisson matrix on a 12×12 grid (stored zeros added to test
    their removal): the offsets and planes of the JAX package's conversion,
    and of ``banded_from_coo`` on the same COO."""
    nx = 12
    i = np.arange(3)
    coo = [np.concatenate([a, b]) for a, b in zip(poisson_coo(np, nx, dtype),
                                                   (i, i + 5, np.zeros(3, dtype)))]
    n_ = nx * nx
    jb = j_ell_to_banded(jsp.from_coo(*coo, (n_, n_)))
    tb = kt.ell_to_banded(kt.sparse.from_coo(*coo, (n_, n_), device="cpu"))
    ref = kt.banded_from_coo(coo[0][:-3], coo[1][:-3], coo[2][:-3], n_, device="cpu")
    assert tb.offsets == jb.offsets == ref.offsets == (-nx, -1, 0, 1, nx)
    np.testing.assert_array_equal(tb.diags.numpy(), np.asarray(jb.diags))
    np.testing.assert_array_equal(tb.diags.numpy(), ref.diags.numpy())
    np.testing.assert_array_equal(tb.adj.diags.numpy(), np.asarray(jb.adj.diags))
    with pytest.raises(ValueError, match="offset decomposition requires a square matrix"):
        kt.ell_to_banded(kt.sparse.from_dense(np.ones((3, 4)), device="cpu"))


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_complex_banded_operator_matches_jax(dtype):
    """Complex planes: the JAX package applies them by XLA's shift-and-add,
    the port by the plain version on every device."""
    rng = np.random.default_rng(103)
    n_ = 300
    offsets = (-7, -1, 0, 2)
    A = np.zeros((n_, n_), dtype)
    for d in offsets:
        A += np.diag(rand_vec(rng, n_ - abs(d), dtype), k=d)
    rows, cols = np.nonzero(A)
    jop = j_banded_from_coo(rows, cols, A[rows, cols], n_)
    top = kt.banded_from_coo(rows, cols, A[rows, cols], n_, device="cpu")
    assert top.diags.dtype == _t(A).dtype
    x = rand_vec(rng, n_, dtype)
    for got, want, M in ((top.normal(_t(x)), jop.normal(jnp.asarray(x)), A),
                         (top.apply_adjoint(_t(x)), jop.apply_adjoint(jnp.asarray(x)), A.conj().T)):
        scale = np.abs(M) @ np.abs(x)
        assert np.all(np.abs(got.numpy() - np.asarray(want)) <= _tol(dtype) * scale)
    # a real vector on complex planes computes in the complex type
    xr = rng.standard_normal(n_).astype(np.float32 if dtype == np.complex64 else np.float64)
    assert top.normal(_t(xr)).dtype == _t(A).dtype
