"""PyTorch port: the plain version of the fused step kernel and the fused
stepper's scalar half, against the JAX package (its Pallas kernel in
interpret mode).  Tolerances as tests/test_fused_lanczos.py: 2e-4·scale for
vectors, rtol 2e-4 / atol 2e-3 for the reductions; rows other than kp1
bit-identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import krylovkit_tpu.factorizations.krylov as jkf
import krylovkit_tpu.ops.pallas_fused_lanczos as jpf
from krylovkit_tpu.ops.operator import GridStencilOperator as JGrid
from krylovkit_tpu.ops.operator import StencilOperator as JStencil
from krylovkit_tpu.ops.vector import STANDARD as JSTANDARD
from krylovkit_tpu_torch import _build, convert
from krylovkit_tpu_torch.factorizations import krylov as tkf
from krylovkit_tpu_torch.ops import fused_lanczos as tfl
from krylovkit_tpu_torch.ops.vector import STANDARD
from krylovkit_tpu_torch.parallel import laplacian_1d

torch.set_num_threads(2)

POISSON_OFF = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))
POISSON_CF = (4.0, -1.0, -1.0, -1.0, -1.0)


def _inputs(kmax, R, seed):
    rng = np.random.default_rng(seed)
    V = rng.standard_normal((kmax, R, 128)).astype(np.float32)
    y = rng.standard_normal((R, 128)).astype(np.float32)
    g = rng.standard_normal(kmax + 1).astype(np.float32)
    return V, y, g


def _compare_step(jop, top_, kmax, R, B, kp1, with_drift, tile_rows, seed):
    V, y, g = _inputs(kmax, R, seed)
    jspec = jpf.spec_for(jop)
    tspec = tfl.spec_for(top_)
    assert tuple(tspec) == tuple(jspec)
    T = jpf.choose_tile(R, tile_rows, jspec.h)
    Vn, yn, raw, _, _ = jpf.fused_step(
        jnp.asarray(V), jnp.asarray(y), jpf.boundary_cache(jnp.asarray(V), T, jspec.h),
        jpf.boundary_cache(jnp.asarray(y), T, jspec.h), jnp.asarray(g), jnp.int32(kp1),
        B, jspec, tile_rows=tile_rows, interpret=True, with_drift=with_drift,
    )
    Vn, yn, raw = np.asarray(Vn), np.asarray(yn), np.asarray(raw)
    Vt = torch.from_numpy(V.copy())
    ynt, rawt = tfl.fused_step_reference(Vt, torch.from_numpy(y), torch.from_numpy(g),
                                         kp1, B, tspec, with_drift)
    Vt, ynt, rawt = Vt.numpy(), ynt.numpy(), rawt.numpy()
    sc = float(np.max(np.abs(yn)))
    keep = np.arange(kmax) != kp1
    assert np.array_equal(Vt[keep], V[keep])
    assert np.array_equal(Vn[keep], V[keep])
    np.testing.assert_allclose(Vt[kp1], Vn[kp1], atol=2e-4 * sc)
    np.testing.assert_allclose(ynt, yn, atol=2e-4 * sc)
    k = kp1 - 1
    assert rawt.shape == ((2 * B if with_drift else B) + 2,)
    live = min(k + 1, B)
    np.testing.assert_allclose(rawt[:live], raw[:live], rtol=2e-4, atol=2e-3)
    if with_drift:
        np.testing.assert_allclose(rawt[B:B + live], raw[B:B + live], rtol=2e-4, atol=2e-3)
    nr = len(rawt)
    np.testing.assert_allclose(rawt[nr - 2:], raw[nr - 2:nr], rtol=2e-4)


@pytest.mark.parametrize("with_drift", [False, True])
@pytest.mark.parametrize("B,kp1", [(8, 8), (16, 12), (31, 30)])
def test_fused_step_reference_matches_pallas_chain(B, kp1, with_drift):
    offs, cf = (-1, 0, 1), (-1.0, 2.0, -1.0)
    _compare_step(JStencil(offs, cf), convert.stencil_from_arrays(offs, cf, "cpu"),
                  31, 32, B, kp1, with_drift, 8, seed=0)


@pytest.mark.parametrize("with_drift", [False, True])
def test_fused_step_reference_matches_pallas_grid(with_drift):
    grid = (32, 256)  # mrow = 2, h = 2
    _compare_step(JGrid(grid, POISSON_OFF, POISSON_CF),
                  convert.grid_stencil_from_arrays(grid, POISSON_OFF, POISSON_CF, "cpu"),
                  13, 64, 8, 9, with_drift, 16, seed=23)


def test_fused_step_reference_multirow_chain():
    offs, cf = (-200, -1, 0, 1, 200), (0.3, -1.0, 2.0, -1.0, -0.2)
    _compare_step(JStencil(offs, cf), convert.stencil_from_arrays(offs, cf, "cpu"),
                  13, 32, 6, 6, True, 8, seed=5)


@pytest.mark.parametrize("kind", ["chain", "grid"])
def test_stencil_apply_spec_matches_operator(kind):
    if kind == "chain":
        op = convert.stencil_from_arrays((-130, -1, 0, 3), (0.5, -1.0, 2.0, 0.25), "cpu")
        R = 16
    else:
        op = convert.grid_stencil_from_arrays((8, 256), POISSON_OFF, POISSON_CF, "cpu")
        R = 16
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((R, 128)).astype(np.float32))
    np.testing.assert_allclose(
        tfl.stencil_apply_spec(x, tfl.spec_for(op)).numpy(), op.normal(x).numpy(),
        rtol=1e-6, atol=1e-5,
    )


def test_fused_step_wrapper_uses_plain_version_on_cpu():
    V, y, g = _inputs(9, 16, 3)
    spec = tfl.spec_for(laplacian_1d(16 * 128, device="cpu"))
    before = dict(_build.launches)
    Va, Vb = torch.from_numpy(V.copy()), torch.from_numpy(V.copy())
    ya, ra = tfl.fused_step(Va, torch.from_numpy(y), torch.from_numpy(g), 5, 5, spec, True)
    yb, rb = tfl.fused_step_reference(Vb, torch.from_numpy(y), torch.from_numpy(g), 5, 5,
                                      spec, True)
    assert torch.equal(Va, Vb) and torch.equal(ya, yb) and torch.equal(ra, rb)
    assert dict(_build.launches) == before
    with pytest.raises(ValueError):
        tfl.fused_step(Va, torch.from_numpy(y), torch.from_numpy(g), 9, 5, spec)


def test_specs_match_jax():
    for offs in [(-1, 0, 1), (-128, 0, 128), (-200, 0, 200), (-33 * 128, 0)]:
        cf = (1.0,) * len(offs)
        js, ts = jpf.spec_for(JStencil(offs, cf)), tfl.spec_for(
            convert.stencil_from_arrays(offs, cf, "cpu"))
        assert (js is None and ts is None) or tuple(js) == tuple(ts)
        assert tfl.supported_stencil(offs) == jpf.supported_stencil(offs)
    jg = JStencil((-2, 0, 1), (1.0, 2.0, 3.0))
    tg = convert.stencil_from_arrays((-2, 0, 1), (1.0, 2.0, 3.0), "cpu")
    assert tuple(tfl.adjoint_spec(tg)) == tuple(jpf.adjoint_spec(jg))
    for R in (16, 24, 64, 96):
        assert tfl.choose_tile(R) == jpf.choose_tile(R)


@pytest.mark.parametrize("dgks", [False, True])
@pytest.mark.parametrize("k", [0, 3, 9])
def test_step_coeffs_match_jax(k, dgks):
    rng = np.random.default_rng(11 + k)
    kmax = 12
    r, d = (rng.standard_normal(kmax).astype(np.float32) for _ in range(2))
    rp, q = np.float32(0.7), np.float32(2.5)
    Lm = np.triu(rng.standard_normal((kmax, kmax))).astype(np.float32) * 0.1 + np.eye(
        kmax, dtype=np.float32)
    s = rng.uniform(0.5, 2, kmax).astype(np.float32)
    Hs = rng.standard_normal((kmax, kmax)).astype(np.float32)
    M = np.eye(kmax, dtype=np.float32)
    jsc = jkf.FusedScales(*(jnp.asarray(a) for a in (Lm, s, Hs, M)))
    tsc = tkf.FusedScales(*(torch.from_numpy(a) for a in (Lm, s, Hs, M)))
    jout = jkf._step_coeffs(jnp.asarray(r), jnp.asarray(d), jnp.asarray(rp), jnp.asarray(q),
                            jsc, k, dgks)
    tout = tkf._step_coeffs(torch.from_numpy(r), torch.from_numpy(d), torch.tensor(rp),
                            torch.tensor(q), tsc, k, dgks)
    for a, b in zip(tout[:4], jout[:4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    for a, b in zip(tout[4].__dict__.values(), jout[4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


def test_fused_gate_matches_jax():
    n = 1 << 12
    cases = [
        (np.ones((n // 128, 128), np.float32), True),
        (np.ones((n,), np.float32), False),
        (np.ones((n // 128, 128), np.float64), False),
        (np.ones((8, 128), np.float32), False),
    ]
    from krylovkit_tpu.parallel import laplacian_1d as jlap

    old = jkf.fused_interpret
    jkf.fused_interpret = True
    try:
        for x, want in cases:
            got_j = jkf.fused_available(jlap(x.size, jnp.float32), jnp.asarray(x), JSTANDARD)
            got_t = tkf.fused_available(laplacian_1d(x.size, device="cpu"), torch.from_numpy(x),
                                        STANDARD)
            assert got_t == got_j == want
    finally:
        jkf.fused_interpret = old
    x = torch.ones((n // 128, 128))
    op = laplacian_1d(n, device="cpu")
    assert not tkf.fused_available(op, x, STANDARD, kmax=127)
    assert not tkf.fused_available(laplacian_1d(n, dirichlet=False, device="cpu"), x, STANDARD)
    assert not tkf.fused_available(op, x.to("meta"), STANDARD)
    grid = convert.grid_stencil_from_arrays((32, 128), POISSON_OFF, POISSON_CF, "cpu")
    assert tkf.fused_available(grid, torch.ones((32, 128)), STANDARD)
    assert not tkf.fused_available(grid, torch.ones((16, 128)), STANDARD)
