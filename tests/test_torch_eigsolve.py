"""PyTorch port: the unfused Lanczos path in float64 and the ``eigsolve``
front-end, against the JAX package and ``np.linalg.eigh``.  Values rtol
1e-10, counts equal; the front-end's unported branches raise."""

import dataclasses
import io
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import krylovkit_tpu as kk
from krylovkit_tpu.factorizations import krylov as jkf
from krylovkit_tpu.parallel import laplacian_1d as j_laplacian_1d
from krylovkit_tpu.solvers.lanczos import eigsolve_lanczos as j_eigsolve_lanczos
import krylovkit_tpu_torch as kt
from krylovkit_tpu_torch import convert
from krylovkit_tpu_torch.factorizations import krylov as tkf
from krylovkit_tpu_torch.ops.vector import STANDARD

torch.set_num_threads(2)


@pytest.fixture
def unfused():
    # the port has no switch: its float64 vectors already select the unfused path
    old = jkf.use_fused_expansion
    jkf.use_fused_expansion = False
    yield
    jkf.use_fused_expansion = old


@pytest.mark.parametrize("orth", ["cgs2", "cgs", "mgs2"])
@pytest.mark.parametrize("maxiter", [1, 4])
def test_unfused_f64_matches_jax(unfused, maxiter, orth):
    n = 1 << 12
    x0 = np.random.default_rng(3).standard_normal((n // 128, 128))
    jalg = kk.Lanczos(krylovdim=30, maxiter=maxiter, orth=getattr(kk, orth))
    talg = convert.lanczos_from_dict({**dataclasses.asdict(jalg), "orth": orth})
    jop = j_laplacian_1d(n, jnp.float64)
    vj, ej, ij = jax.jit(lambda x: j_eigsolve_lanczos(jop, x, 4, "LM", jalg))(jnp.asarray(x0))
    top = convert.stencil_from_arrays(jop.offsets, jop.coeffs, "cpu")
    xt = convert.vector_from_numpy(x0, "cpu")
    assert not tkf.fused_available(top, xt, STANDARD, kmax=31)
    vt, et, it = kt.eigsolve_lanczos(top, xt, 4, "LM", talg)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-10)
    assert (it.numops, it.numiter, it.converged) == (
        int(ij.numops), int(ij.numiter), int(ij.converged))
    for a, b in zip(np.asarray(ej), et.numpy()):
        np.testing.assert_allclose(abs(float(np.vdot(a, b))), 1.0, atol=1e-8)


@pytest.mark.parametrize("which", ["LM", "SR", "LR"])
def test_dense_matrix_eigsolve_matches_eigh_and_jax(which):
    rng = np.random.default_rng(5)
    n = 200
    A = rng.standard_normal((n, n))
    A = A + A.T
    x0 = rng.standard_normal(n)
    vt, et, it = kt.eigsolve(torch.from_numpy(A), torch.from_numpy(x0), 3, which)
    vj, ej, ij = kk.eigsolve(jnp.asarray(A), jnp.asarray(x0), 3, which)
    w = np.linalg.eigh(A)[0]
    order = {"LM": np.argsort(-np.abs(w)), "SR": np.argsort(w), "LR": np.argsort(-w)}[which]
    np.testing.assert_allclose(vt.numpy(), w[order[:3]], rtol=1e-10)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-10)
    assert it.converged == 3 and int(ij.converged) == 3
    for i in range(3):
        v = et[i].numpy()
        np.testing.assert_allclose(np.linalg.norm(A @ v - vt[i].item() * v), 0, atol=1e-8)
    # the numpy-matrix route, with no x0: the JAX default start vector
    vn, _, _ = kt.eigsolve(A, torch.from_numpy(x0), 3, which)
    np.testing.assert_allclose(vn.numpy(), vt.numpy(), rtol=1e-12)
    vd, _, _ = kt.eigsolve(torch.from_numpy(A), None, 3, which)
    np.testing.assert_allclose(vd.numpy(), vt.numpy(), rtol=1e-10)


def test_unported_branches_raise():
    A = torch.from_numpy(np.random.default_rng(6).standard_normal((20, 20)))
    x0 = torch.ones(20, dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="Arnoldi"):
        kt.eigsolve(A, x0, 2)  # not Hermitian → Arnoldi
    with pytest.raises(NotImplementedError, match="BlockLanczos"):
        kt.eigsolve(A + A.T, x0, 2, alg=kt.BlockLanczos())
    with pytest.raises(NotImplementedError, match="selective"):
        kt.eigsolve(A + A.T, x0, 2, alg=kt.Lanczos(reorth="selective"))
    with pytest.raises(NotImplementedError, match="AD"):
        kt.eigsolve(A + A.T, x0.clone().requires_grad_(True), 2)
    with pytest.raises(ValueError):
        kt.eigsolve(A + A.T, x0, 2, "LI")
    with pytest.raises(ValueError):
        kt.eigsolve(A + A.T, torch.zeros(20, dtype=torch.float64), 2)
    with pytest.raises(ValueError):
        kt.eigsolve_lanczos(kt.as_operator(A + A.T), x0, 40, "LM", kt.Lanczos(krylovdim=30))


def test_lanczos_from_dict_roundtrip():
    names = {"cgs": "ClassicalGramSchmidt", "cgs2": "ClassicalGramSchmidt2",
             "mgs2": "ModifiedGramSchmidt2", "ClassicalGramSchmidtIR": "ClassicalGramSchmidtIR"}
    for orth, cls in names.items():
        jalg = kk.Lanczos(krylovdim=17, maxiter=3, tol=1e-7, eager=True, verbosity=0)
        talg = convert.lanczos_from_dict({**dataclasses.asdict(jalg), "orth": orth})
        assert (talg.krylovdim, talg.maxiter, talg.tol, talg.eager, talg.verbosity,
                talg.reorth) == (17, 3, 1e-7, True, 0, "full")
        assert type(talg.orth).__name__ == cls
    assert convert.lanczos_from_dict({"orth": "cgsir"}).orth == kt.cgsir
    with pytest.raises(ValueError):
        convert.lanczos_from_dict({"orth": {}})
    with pytest.raises(ValueError):
        convert.lanczos_from_dict({"bogus": 1})


def test_warning_text_matches_jax():
    n = 1 << 11
    x0 = np.ones((n // 128, 128), np.float64)
    alg_t = kt.Lanczos(krylovdim=10, maxiter=1)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        kt.eigsolve_lanczos(kt.laplacian_1d(n, device="cpu"), torch.from_numpy(x0), 2, "LM", alg_t)
    assert buf.getvalue().splitlines() == [
        "Lanczos eigsolve stopped without convergence: 0 of 2 values converged after 1 iterations"
    ]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        kt.eigsolve_lanczos(kt.laplacian_1d(n, device="cpu"), torch.from_numpy(x0), 2, "LM",
                            kt.Lanczos(krylovdim=10, maxiter=1, verbosity=kt.EACHITERATION))
    lines = buf.getvalue().splitlines()
    assert lines[0].startswith("Lanczos eigsolve in iteration 1: 0 values converged, normres = ")
    assert lines[1].startswith(
        "Lanczos eigsolve finished after 1 iterations: 0 values converged, numops = 10")
