"""PyTorch port: ``bieigsolve`` on a dense matrix over float32, float64,
complex64 and complex128 × every orthogonalizer, against the JAX package
(``tests/test_bieigsolve.py::test_bieig_full_matrix``), with the bars of
``test_torch_bieigsolve.py``: values within 1e-10 (1e-4 relative in
float32/complex64), counts equal, residuals and biorthogonality at
``500·eps^(2/3)``."""

import numpy as np
import pytest
import torch

from test_torch_bieigsolve import _biorthogonal, _parity, _solve_both, _value_tol
from testsetup import n, precision, rand_mat, rand_vec

torch.set_num_threads(2)

ORTHS = ["cgs2", "mgs2", "cgsir", "mgsir"]


@pytest.mark.parametrize("orth", ORTHS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex64, np.complex128])
def test_bieig_full_matrix_matches_jax(dtype, orth):
    rng = np.random.default_rng(64)
    A = rand_mat(rng, n, n, dtype)
    v0, w0 = rand_vec(rng, n, dtype), rand_vec(rng, n, dtype)
    tol = precision(dtype)
    rj, rt = _solve_both(A, v0, w0, 3, "LM", orth, krylovdim=n, tol=tol, maxiter=30)
    lam, V, W, info = _parity(rj, rt, _value_tol(dtype))
    assert info.converged >= 3
    wA = np.linalg.eigvals(A.astype(np.complex128))
    atol = 500 * tol * max(1.0, float(np.abs(wA).max()))
    for lam_i in lam[:3]:
        assert np.min(np.abs(wA - lam_i)) <= atol
    for i in range(3):
        assert np.linalg.norm(A @ V[:, i] - lam[i] * V[:, i]) <= 500 * tol
        assert np.linalg.norm(A.conj().T @ W[:, i] - np.conj(lam[i]) * W[:, i]) <= 500 * tol
    _biorthogonal(V[:, :3], W[:, :3], 500 * tol)
