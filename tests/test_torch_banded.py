"""PyTorch port: the banded SpMV (kernel K3's plain version) and
``BandedOperator`` against the JAX package's ``ops/pallas_spmv.py``, on the
CPU.  The JAX side runs its Pallas kernel in interpret mode
(``_spmv_pallas(..., interpret=True)``) or its ``BandedOperator.normal``.

Tolerances, relative to ``scale = max_i Σ_p |d_p[i]|·|x[i+δ_p]|``: float32
1e-5·scale (the two sum in float32, in offset order, the Pallas kernel with
its own rounding of the rolled window), float64 and complex128 1e-12·scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krylovkit_tpu.ops.pallas_spmv import _spmv_pallas
from krylovkit_tpu.ops.pallas_spmv import banded_from_coo as j_banded_from_coo
from krylovkit_tpu.ops.pallas_spmv import banded_from_dense as j_banded_from_dense
import krylovkit_tpu_torch as kt
from krylovkit_tpu_torch import convert
from krylovkit_tpu_torch.ops import banded as bd
from krylovkit_tpu_torch.ops.operator import probe_dtype

torch.set_num_threads(2)

# the offsets of tests/test_pallas.py's kernel test: both lane-aligned and
# straddling ones, on both sides of the diagonal
PALLAS_OFFSETS = (-130, -127, -1, 0, 1, 3, 127, 129, 256)


def _banded_dense(rng, n, offsets, dtype):
    A = np.zeros((n, n), dtype)
    for d in offsets:
        v = rng.standard_normal(n - abs(d))
        if np.dtype(dtype).kind == "c":
            v = v + 1j * rng.standard_normal(n - abs(d))
        A += np.diag(v.astype(dtype), k=d)
    return A


def _scale(A, x):
    return float(np.max(np.abs(A) @ np.abs(x)))


def _vec(rng, n, dtype):
    x = rng.standard_normal(n)
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.standard_normal(n)
    return x.astype(dtype)


def test_plain_spmv_matches_pallas_kernel_interpret():
    rng = np.random.default_rng(5)
    n = 2048  # R = 16 rows of 128 lanes; TR = 4 → 4 tiles incl. 2 middle ones
    A = _banded_dense(rng, n, PALLAS_OFFSETS, np.float32)
    jop = j_banded_from_dense(A)
    x = rng.standard_normal(n).astype(np.float32)
    yj = np.asarray(_spmv_pallas(jnp.asarray(x).reshape(n // 128, 128), jop.diags,
                                 jop.offsets, TR=4, interpret=True))
    yt = bd.banded_spmv_reference(torch.from_numpy(x).reshape(n // 128, 128),
                                  torch.from_numpy(np.asarray(jop.diags)), jop.offsets, n)
    assert yt.shape == (n // 128, 128) and yt.dtype == torch.float32
    np.testing.assert_allclose(yt.numpy(), yj, rtol=0, atol=1e-5 * _scale(A, x))


@pytest.mark.parametrize("dtype,n", [(np.float32, 2048), (np.float64, 300),
                                     (np.complex128, 300), (np.float64, 1)])
def test_banded_operator_matches_jax(dtype, n):
    rng = np.random.default_rng(6)
    offsets = (-2, 0, 5) if n > 1 else (0,)
    A = _banded_dense(rng, n, offsets if n < 2048 else PALLAS_OFFSETS, dtype)
    jop = j_banded_from_dense(A)
    top = kt.banded_from_dense(A, device="cpu")
    assert top.offsets == jop.offsets and top.n == jop.n and top.shape == (n, n)
    assert top.nnz == jop.nnz == np.count_nonzero(A)
    assert top.diags.shape == tuple(jop.diags.shape) and top.diags.dtype == torch.from_numpy(A).dtype
    np.testing.assert_array_equal(top.diags.numpy(), np.asarray(jop.diags))
    tol = (1e-5 if dtype == np.float32 else 1e-12)
    x = _vec(rng, n, dtype)
    for jf, tf, M in ((jop.normal, top.normal, A), (jop.adjoint, top.adjoint, A.conj().T)):
        yj = np.asarray(jf(jnp.asarray(x)))
        yt = tf(torch.from_numpy(x))
        assert yt.shape == (n,)
        np.testing.assert_allclose(yt.numpy(), yj, rtol=0, atol=tol * _scale(M, x))
        np.testing.assert_allclose(yt.numpy(), M @ x, rtol=0, atol=tol * _scale(M, x))


def test_adjoint_plan_is_transposed_conjugated_coo():
    rng = np.random.default_rng(7)
    n = 200
    A = _banded_dense(rng, n, (-3, 0, 1, 7), np.complex128)
    top = kt.banded_from_dense(A, device="cpu")
    jop = j_banded_from_dense(A)
    assert top.adj.offsets == jop.adj.offsets == (-7, -1, 0, 3)
    np.testing.assert_array_equal(top.adj.diags.numpy(), np.asarray(jop.adj.diags))
    assert top.adj.adj is None
    assert kt.banded_from_dense(A, with_adjoint=False, device="cpu").adjoint is None


def test_banded_from_coo_sums_duplicates_and_limits_offsets():
    rows = np.array([0, 0, 1, 2, 2])
    cols = np.array([0, 0, 2, 1, 2])
    vals = np.array([1.0, 2.0, 3.0, 4.0, 5.0])
    jop = j_banded_from_coo(rows, cols, vals, 3)
    top = kt.banded_from_coo(rows, cols, vals, 3, device="cpu")
    np.testing.assert_array_equal(top.diags.numpy(), np.asarray(jop.diags))
    x = torch.tensor([1.0, 10.0, 100.0], dtype=torch.float64)
    assert top.normal(x).tolist() == [3.0, 300.0, 540.0]
    wide = np.arange(5)
    with pytest.raises(ValueError, match="max_offsets"):
        kt.banded_from_coo(np.zeros(5, int), wide, np.ones(5), 5, max_offsets=4, device="cpu")


def test_banded_from_arrays_carries_jax_planes():
    rng = np.random.default_rng(8)
    n = 384
    A = _banded_dense(rng, n, (-129, -1, 0, 2), np.float64)
    jop = j_banded_from_dense(A)
    top = convert.banded_from_arrays(jop.offsets, np.asarray(jop.diags), n,
                                     jop.adj.offsets, np.asarray(jop.adj.diags), device="cpu")
    x = rng.standard_normal(n)
    np.testing.assert_allclose(top.normal(torch.from_numpy(x)).numpy(), A @ x, atol=1e-12 * _scale(A, x))
    np.testing.assert_allclose(top.adjoint(torch.from_numpy(x)).numpy(), A.T @ x,
                               atol=1e-12 * _scale(A, x))


def test_mixed_precision_and_result_type():
    # float32 planes on a float64 vector compute in float64, as _spmv_xla does
    rng = np.random.default_rng(9)
    A = _banded_dense(rng, 256, (-1, 0, 1), np.float32)
    top = kt.banded_from_dense(A, device="cpu")
    x = torch.from_numpy(rng.standard_normal(256))
    assert top.normal(x).dtype == torch.float64
    assert probe_dtype(top, x) == torch.float64
    assert probe_dtype(top, x.float()) == torch.float32
    with pytest.raises(ValueError, match="entries"):
        top.normal(torch.zeros(255))
