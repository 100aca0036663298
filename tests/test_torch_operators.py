"""PyTorch port: stencil operators against the JAX package (same inputs, made
with numpy from a seed).  Tolerances: bit-equal in float64 (same terms, same
order), 1e-6 relative in float32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krylovkit_tpu.ops.operator import GridStencilOperator as JGrid
from krylovkit_tpu.ops.operator import StencilOperator as JStencil
from krylovkit_tpu.parallel import laplacian_1d as j_laplacian_1d
from krylovkit_tpu.parallel import poisson_2d as j_poisson_2d
from krylovkit_tpu_torch import convert
from krylovkit_tpu_torch.ops import operator as top
from krylovkit_tpu_torch.parallel import laplacian_1d, poisson_2d

torch.set_num_threads(2)

POISSON_OFF = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))
POISSON_CF = (4.0, -1.0, -1.0, -1.0, -1.0)


def _chain(offsets, coeffs):
    return JStencil(offsets, coeffs), convert.stencil_from_arrays(offsets, coeffs, "cpu")


def _grid(grid, offsets2, coeffs):
    return JGrid(grid, offsets2, coeffs), convert.grid_stencil_from_arrays(
        grid, offsets2, coeffs, "cpu"
    )


CASES = {
    "chain": (lambda: _chain((-3, -1, 0, 2), (0.5, -1.0, 2.0, 0.25)), 512),
    "chain_multirow": (lambda: _chain((-200, 0, 200), (-1.0, 2.5, -0.5)), 1024),
    "laplacian_1d": (lambda: (j_laplacian_1d(1024), laplacian_1d(1024, device="cpu")), 1024),
    "poisson_2d": (lambda: _grid((6, 256), POISSON_OFF, POISSON_CF), 6 * 256),
    "poisson_2d_builder": (
        lambda: (j_poisson_2d(8, 256), poisson_2d(8, 256, device="cpu")), 8 * 256
    ),
    "grid_asymmetric": (
        lambda: _grid((8, 128), ((0, 0), (-2, 3), (1, -3), (2, 1)), (1.5, -0.3, 0.7, 0.2)),
        8 * 128,
    ),
}


def _compare(got, want, dtype):
    if dtype == np.float64:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.max(np.abs(want)))


@pytest.mark.parametrize("layout", ["flat", "rows128"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", sorted(CASES))
def test_stencil_apply_matches_jax(case, dtype, layout):
    make, n = CASES[case]
    jop, top_ = make()
    x = np.random.default_rng(3).standard_normal(n).astype(dtype)
    if layout == "rows128":
        x = x.reshape(n // 128, 128)
    for jf, tf in ((jop.normal, top_.normal), (jop.adjoint, top_.adjoint)):
        want = np.asarray(jf(jnp.asarray(x)))
        got = tf(torch.from_numpy(x)).numpy()
        assert got.shape == x.shape and got.dtype == x.dtype
        _compare(got, want, dtype)


def test_stencil_metadata_matches_jax():
    jop, top_ = _chain((-3, -1, 0, 2), (0.5, -1.0, 2.0, 0.25))
    assert top_.offsets == jop.offsets and top_.coeffs == jop.coeffs
    jg, tg = _grid((6, 256), POISSON_OFF, POISSON_CF)
    assert (tg.grid, tg.offsets2, tg.coeffs) == (jg.grid, jg.offsets2, jg.coeffs)
    jl, tl = j_laplacian_1d(64), laplacian_1d(64, device="cpu")
    assert (tl.offsets, tl.coeffs) == (jl.offsets, jl.coeffs)


def test_matrix_operator_and_probe_dtype():
    rng = np.random.default_rng(4)
    A = rng.standard_normal((20, 20))
    x = rng.standard_normal(20)
    op = convert.matrix_from_numpy(A, "cpu")
    np.testing.assert_allclose(op.normal(torch.from_numpy(x)).numpy(), A @ x, rtol=1e-12)
    np.testing.assert_allclose(op.adjoint(torch.from_numpy(x)).numpy(), A.T @ x, rtol=1e-12)
    assert top.probe_dtype(op, torch.from_numpy(x.astype(np.float32))) == torch.float64
    st = laplacian_1d(256, device="cpu")
    x32 = torch.zeros((2, 128), dtype=torch.float32)
    assert top.probe_dtype(st, x32) == torch.float32
    assert top.probe_dtype(st, x32.to(torch.complex64)) == torch.complex64


def test_as_operator_encodings():
    f = lambda x: 2 * x  # noqa: E731
    op = top.as_operator(f)
    assert op.adjoint is None and torch.equal(op(torch.ones(3)), 2 * torch.ones(3))
    pair = top.as_operator((f, lambda y: 3 * y))
    assert torch.equal(pair.apply_adjoint(torch.ones(2)), 3 * torch.ones(2))
    with pytest.raises(ValueError):
        top.as_operator((f,))
    with pytest.raises(ValueError):
        top.MatrixOperator(torch.ones(3))


def test_cuda_request_without_card_is_an_error(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        laplacian_1d(1024)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        poisson_2d(8, 128, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.vector_from_numpy(np.ones(4))
