"""PyTorch port: the GKL bidiagonalization (``factorizations/gkl.py``) and the
projected SVD (``dense/svd.py``) against the JAX package on the same numpy
inputs.

Float64 states agree to 1e-10; the fused float32 expansion (the JAX kernel in
interpret mode, the port's plain fused step) to 1e-5 relative in ``B`` and
the scales and 1e-4 in the bases."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import krylovkit_tpu as kk
from krylovkit_tpu import dense as jdense
from krylovkit_tpu.factorizations import gkl as jgf
from krylovkit_tpu.factorizations import krylov as jkf
from krylovkit_tpu.ops.operator import as_operator as j_as_operator
from krylovkit_tpu.ops.vector import STANDARD as JSTD
import krylovkit_tpu_torch as kt
from krylovkit_tpu_torch import convert, dense as tdense
from krylovkit_tpu_torch.factorizations import gkl as tgf
from krylovkit_tpu_torch.factorizations import krylov as tkf
from krylovkit_tpu_torch.ops import operator as top_
from krylovkit_tpu_torch.ops.vector import STANDARD as TSTD, scalartype
from testsetup import n, rand_mat, rand_vec

torch.set_num_threads(2)

CHAIN = ((-2, 0, 1), (0.4, 1.0, -0.8))  # non-symmetric: A != Aᵀ
GRID = ((32, 128), ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)), (4.0, -1.5, -0.5, -1.2, -0.8))


@pytest.fixture
def interpret_mode():
    old = jkf.fused_interpret
    jkf.fused_interpret = True
    try:
        yield
    finally:
        jkf.fused_interpret = old


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex64, np.complex128])
@pytest.mark.parametrize("k", [0, 1, 5, 9])
def test_svd_active_matches_jax(dtype, k):
    rng = np.random.default_rng(2)
    B = rand_mat(rng, 9, 9, dtype)
    sj, Uj, Vhj, validj = jdense.svd_active(jnp.asarray(B), k)
    s, U, Vh, valid = tdense.svd_active(torch.from_numpy(B), k)
    tol = 50 * np.finfo(dtype).eps
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), rtol=tol, atol=tol)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(validj))
    assert int(valid.sum()) == k
    if k:
        want = np.linalg.svd(B[:k, :k], compute_uv=False)
        np.testing.assert_allclose(np.sort(s.numpy()[valid.numpy()])[::-1], want, rtol=tol, atol=tol)
    # the factorization holds on the active block; inactive rows/columns are zero
    rec = (U.numpy() * s.numpy()) @ Vh.numpy()
    np.testing.assert_allclose(rec[:k, :k], B[:k, :k], atol=20 * tol)
    assert not U.numpy()[k:].any() and not Vh.numpy()[:, k:].any()


def _pair(A):
    Aj, At = jnp.asarray(A), torch.from_numpy(A)
    jop = j_as_operator((lambda x: Aj @ x, lambda y: Aj.conj().T @ y))
    top = kt.as_operator((lambda x: At @ x, lambda y: At.conj().T @ y))
    return jop, top


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("orth", ["cgs", "mgs", "cgs2", "mgs2", "cgsir", "mgsir"])
def test_gkl_factorization_contract_and_jax_state(dtype, orth):
    rng = np.random.default_rng(84)
    A = rand_mat(rng, 2 * n, n, dtype)
    x0 = rand_vec(rng, 2 * n, dtype)
    jop, top = _pair(A)
    cdt = torch.from_numpy(x0).dtype
    jst = jgf.initialize(jop, jnp.asarray(x0), 8, jnp.asarray(x0).dtype)
    tst = tgf.initialize(top, torch.from_numpy(x0), 8, cdt)
    assert tst.V.shape == (9, n) and tst.U.shape == (9, 2 * n) and tst.V.dtype == cdt
    # one compiled JAX step for the six (op by op each call compiles its loops anew)
    jexpand = jax.jit(lambda st: jgf.expand(jop, st, getattr(kk, orth)))
    for _ in range(6):
        jst = jexpand(jst)
        tst = tgf.expand(top, tst, getattr(kt, orth))
    k = tst.k
    assert k == int(jst.k) == 6
    U, V, B = tst.U.numpy(), tst.V.numpy(), tst.B.numpy()
    np.testing.assert_allclose(B, np.asarray(jst.B), atol=1e-10)
    np.testing.assert_allclose(U, np.asarray(jst.U), atol=1e-10)
    np.testing.assert_allclose(V, np.asarray(jst.V), atol=1e-10)
    np.testing.assert_allclose(float(tst.beta), float(jst.beta), rtol=1e-12)
    assert np.allclose(U[: k + 1].conj() @ U[: k + 1].T, np.eye(k + 1), atol=1e-12)
    assert np.allclose(V[:k].conj() @ V[:k].T, np.eye(k), atol=1e-12)
    # A V = U[:k+1] B[:k+1, :k]   and   Aᴴ U[:k] = V B[:k,:k]ᴴ
    assert np.allclose(A @ V[:k].T, U[: k + 1].T @ B[: k + 1, :k], atol=1e-10)
    assert np.allclose(A.conj().T @ U[:k].T, V[:k].T @ B[:k, :k].conj().T, atol=1e-10)


def test_gkl_initialize_zero_start_warns(capsys):
    _, top = _pair(np.eye(4))
    tgf.initialize(top, torch.zeros(4, dtype=torch.float64), 3, torch.float64, verbosity=1)
    assert "starting vector x0 has zero norm" in capsys.readouterr().out


def test_probe_adjoint_shapes_and_dtypes():
    rng = np.random.default_rng(1)
    A = rand_mat(rng, 7, 4, np.float32)
    # a matrix promotes; a callable pair answers for what it is given
    for op, dt in ((kt.as_operator(torch.from_numpy(A)), torch.complex64),
                   (_pair(A)[1], torch.float32)):
        v = top_.probe_adjoint(op, torch.zeros(7, dtype=dt))
        assert v.device.type == "meta" and tuple(v.shape) == (4,) and v.dtype == dt
    assert scalartype(v, torch.zeros(2, dtype=torch.complex128)) == torch.complex128
    grid = convert.grid_stencil_from_arrays(*GRID, device="cpu")
    v = top_.probe_adjoint(grid, torch.zeros((32, 128)))
    assert tuple(v.shape) == (32, 128) and v.dtype == torch.float32
    band = kt.banded_from_dense(np.eye(256, dtype=np.float32), device="cpu")
    v = top_.probe_adjoint(band, torch.zeros((2, 128)))
    assert tuple(v.shape) == (2, 128) and v.dtype == torch.float32
    # a bare callable gets its adjoint derived (torch.func.vjp)
    derived = top_.require_adjoint(kt.as_operator(lambda x: 2 * x), torch.zeros(5))
    assert torch.equal(derived.apply_adjoint(torch.arange(5.0)), 2 * torch.arange(5.0))


def test_check_adjoint_compatibility():
    rng = np.random.default_rng(300)
    A, Bm = torch.from_numpy(rng.standard_normal((20, 20))), torch.from_numpy(rng.standard_normal((20, 20)))
    x0 = torch.from_numpy(rng.standard_normal(20))
    top_.check_adjoint_compatibility(kt.as_operator((lambda x: A @ x, lambda y: A.T @ y)), x0)
    with pytest.raises(ValueError, match="not compatible"):
        top_.check_adjoint_compatibility(kt.as_operator((lambda x: A @ x, lambda y: Bm.T @ y)), x0)
    with pytest.raises(ValueError, match="norm zero"):
        top_.check_adjoint_compatibility(kt.as_operator((lambda x: A @ x, lambda y: A.T @ y)),
                                         torch.zeros(20, dtype=torch.float64))


# --------------------------------------------------------------------------
# The fused one-stream expansion over both bases
# --------------------------------------------------------------------------

def _ops(kind):
    if kind == "chain":
        return (kk.StencilOperator(*CHAIN), convert.stencil_from_arrays(*CHAIN, device="cpu"),
                (32, 128))
    return (kk.GridStencilOperator(*GRID), convert.grid_stencil_from_arrays(*GRID, device="cpu"),
            (32, 128))


def _assert_states_close(tst, tscU, tscV, jst, jscU, jscV):
    assert tst.k == int(jst.k)
    np.testing.assert_allclose(tst.B.numpy(), np.asarray(jst.B), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(tst.beta), float(jst.beta), rtol=1e-5)
    for tsc, jsc in ((tscU, jscU), (tscV, jscV)):
        np.testing.assert_allclose(tsc.s.numpy(), np.asarray(jsc.s), rtol=1e-5)
        np.testing.assert_allclose(tsc.L.numpy(), np.asarray(jsc.L), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(tsc.Hs.numpy(), np.asarray(jsc.Hs), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tst.U.numpy(), np.asarray(jst.U), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tst.V.numpy(), np.asarray(jst.V), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", ["chain", "grid"])
def test_fused_gkl_expansions_match_jax(interpret_mode, kind):
    """From a fresh start (whose first domain half-step has no live row) and
    again from the JAX package's state mid-build."""
    jop, top, shape = _ops(kind)
    x = np.random.default_rng(51).standard_normal(shape).astype(np.float32)
    m, btol = 12, 1e-5
    jst0 = jgf.initialize(jop, jnp.asarray(x), m, jnp.float32)
    jsc0 = jkf.fused_scales_init(m + 1)
    tst0 = tgf.initialize(top, torch.from_numpy(x), m, torch.float32)
    tsc0 = tkf.fused_scales_init(m + 1, device="cpu")
    assert tgf.fused_kernel_available(top, torch.from_numpy(x), TSTD, m + 1)

    jst1, jsU1, jsV1, jops1 = jgf.fused_expansions(jop, jst0, jsc0, jsc0, 5, jnp.float32(btol), JSTD)
    tst1, tsU1, tsV1, tops1 = tgf.fused_expansions(top, tst0, tsc0, tsc0, 5, btol, TSTD)
    assert tops1 == int(jops1) == 10
    _assert_states_close(tst1, tsU1, tsV1, jst1, jsU1, jsV1)

    jst2, jsU2, jsV2, jops2 = jgf.fused_expansions(jop, jst1, jsU1, jsV1, m, jnp.float32(btol), JSTD)
    tmid = convert.gkl_state_from_numpy(np.asarray(jst1.U), np.asarray(jst1.V), np.asarray(jst1.B),
                                        int(jst1.k), np.asarray(jst1.beta), "cpu")
    tmU = convert.fused_scales_from_numpy(*(np.asarray(a) for a in jsU1), device="cpu")
    tmV = convert.fused_scales_from_numpy(*(np.asarray(a) for a in jsV1), device="cpu")
    tst2, tsU2, tsV2, tops2 = tgf.fused_expansions(top, tmid, tmU, tmV, m, btol, TSTD)
    assert tops2 == int(jops2) == 2 * (m - 5)
    _assert_states_close(tst2, tsU2, tsV2, jst2, jsU2, jsV2)

    # the factorization contract in the true bases v_j = Σ_i L[i,j]·row_i
    k = tst2.k
    Ut = (tsU2.L.T @ tst2.U.reshape(m + 1, -1))[: k + 1].numpy()
    Vt = (tsV2.L.T @ tst2.V.reshape(m + 1, -1))[:k].numpy()
    np.testing.assert_allclose(Ut @ Ut.T, np.eye(k + 1), atol=2e-5)
    np.testing.assert_allclose(Vt @ Vt.T, np.eye(k), atol=2e-5)
    AV = np.stack([top.normal(torch.from_numpy(v.reshape(shape))).numpy().ravel() for v in Vt])
    Bk = tst2.B.numpy()
    np.testing.assert_allclose(AV.T, Ut.T @ Bk[: k + 1, :k], atol=5e-5)


def test_fused_gkl_stops_at_btol(interpret_mode):
    """A residual within ``btol`` ends the loop: no step, no apply counted
    beyond the priming one that the count leaves out."""
    jop, top, shape = _ops("chain")
    x = np.random.default_rng(53).standard_normal(shape).astype(np.float32)
    jst0 = jgf.initialize(jop, jnp.asarray(x), 6, jnp.float32)
    tst0 = tgf.initialize(top, torch.from_numpy(x), 6, torch.float32)
    jst, _, _, jops = jgf.fused_expansions(jop, jst0, jkf.fused_scales_init(7), jkf.fused_scales_init(7),
                                           6, jnp.float32(10.0), JSTD)
    tsc = tkf.fused_scales_init(7, device="cpu")
    tst, _, _, tops = tgf.fused_expansions(top, tst0, tsc, tsc, 6, 10.0, TSTD)
    assert tst.k == int(jst.k) == 0 and tops == int(jops) == 0
    np.testing.assert_allclose(float(tst.beta), float(jst.beta))


def test_fused_gkl_gate_matches_jax(interpret_mode):
    x = np.ones((32, 128), np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    lap = ((-1, 0, 1), (-1.0, 2.0, -1.0))
    cases = [
        (kk.StencilOperator(*lap), convert.stencil_from_arrays(*lap, device="cpu"), xj, xt, 31),
        (kk.StencilOperator(*lap), convert.stencil_from_arrays(*lap, device="cpu"), xj, xt, 64),
        (j_as_operator(lambda v: 2 * v), kt.as_operator(lambda v: 2 * v), xj, xt, 31),
        (kk.GridStencilOperator(*GRID), convert.grid_stencil_from_arrays(*GRID, device="cpu"),
         xj, xt, 21),
        (kk.GridStencilOperator(*GRID), convert.grid_stencil_from_arrays(*GRID, device="cpu"),
         jnp.ones((16, 128), jnp.float32), torch.ones((16, 128)), 21),  # not the whole grid
        (kk.StencilOperator(*lap), convert.stencil_from_arrays(*lap, device="cpu"),
         jnp.ones((32, 128), jnp.float64), torch.ones((32, 128), dtype=torch.float64), 31),
    ]
    want = [True, False, False, True, False, False]
    for (jop, top, xj_, xt_, kmax), w in zip(cases, want):
        assert tgf.fused_kernel_available(top, xt_, TSTD, kmax) is w
        assert bool(jgf.fused_kernel_available(jop, xj_, JSTD, kmax)) is w
    custom = kt.VectorSpace(inner_fn=lambda a, b: torch.vdot(a.reshape(-1), b.reshape(-1)))
    assert not tgf.fused_kernel_available(cases[0][1], xt, custom, 31)
