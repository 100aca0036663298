"""PyTorch port: the 1-D Laplacian kernel's plain version (kernel K4) and
``laplacian_1d_pallas`` against the JAX package's ``ops/pallas_stencil.py``
in Pallas interpret mode, on the CPU.  Both compute
``(2x[i] − x[i−1]) − x[i+1]`` in the same order: exact to 1e-14 of the
input's scale in float64 (in fact bit-equal), 1e-6 in float32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krylovkit_tpu.ops.pallas_stencil import laplacian_1d_pallas as j_laplacian_1d_pallas
import krylovkit_tpu_torch as kt
from krylovkit_tpu_torch.ops import stencil_1d as s1

torch.set_num_threads(2)


@pytest.mark.parametrize("dtype,n,tile_rows", [(np.float64, 2048, 4), (np.float64, 256, 2),
                                               (np.float32, 1024, 4)])
def test_plain_matches_pallas_kernel_interpret(dtype, n, tile_rows):
    jop = j_laplacian_1d_pallas(n, jnp.dtype(dtype), tile_rows=tile_rows, interpret=True)
    top = kt.laplacian_1d_pallas(n, torch.from_numpy(np.zeros(1, dtype)).dtype, device="cpu")
    x = np.random.default_rng(0).standard_normal((n // 128, 128)).astype(dtype)
    yj = np.asarray(jop.normal(jnp.asarray(x)))
    yt = top.normal(torch.from_numpy(x))
    # the JAX operator's contract: a flat (n,) result from an (R, 128) input
    assert yj.shape == (n,) and tuple(yt.shape) == (n,)
    assert yt.dtype == torch.from_numpy(x).dtype
    tol = 1e-14 if dtype == np.float64 else 1e-6
    np.testing.assert_allclose(yt.numpy(), yj, rtol=0, atol=tol * np.max(np.abs(x)))
    A = 2 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)
    np.testing.assert_allclose(yt.numpy(), A @ x.reshape(n), rtol=0, atol=4 * tol * np.max(np.abs(x)))
    # the adjoint is the same map
    np.testing.assert_array_equal(top.adjoint(torch.from_numpy(x)).numpy(), yt.numpy())


def test_flat_result_whatever_the_shape():
    n = 512
    op = kt.laplacian_1d_pallas(n, device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(n).astype(np.float32))
    for shape in ((n,), (n // 128, 128), (2, 2, 128)):
        y = op.normal(x.reshape(shape))
        assert tuple(y.shape) == (n,)
        assert torch.equal(y, s1.laplacian_1d_flat_reference(x))


def test_contract_errors():
    with pytest.raises(ValueError, match="multiple of 128"):
        kt.laplacian_1d_pallas(300, device="cpu")
    with pytest.raises(ValueError, match="float32 or float64"):
        kt.laplacian_1d_pallas(256, torch.complex64, device="cpu")
    with pytest.raises(ValueError, match="entries"):
        kt.laplacian_1d_pallas(256, device="cpu").normal(torch.zeros(128))
