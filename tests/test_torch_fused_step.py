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


ADVECTION_CF = (4.0, -1.5, -0.5, -1.2, -0.8)  # non-symmetric: A != Aᵀ


def _dense_of(apply, shape):
    n = shape[0] * shape[1]
    eye = torch.eye(n, dtype=torch.float32)
    return torch.stack([apply(eye[i].reshape(shape)).reshape(n) for i in range(n)], dim=1).numpy()


@pytest.mark.parametrize("kind", ["chain", "chain_far", "grid", "grid_wide"])
def test_adjoint_spec_is_the_transpose(kind):
    """``stencil_apply_spec`` of ``adjoint_spec(op)`` against the dense
    transpose of the operator, against the port's ``op.adjoint`` and against
    the JAX package's adjoint spec (entries are sums of at most two float32
    products: exact to 1e-6)."""
    if kind == "chain":
        args, shape, jcls = ((-2, 0, 1), (0.4, 1.0, -0.8)), (4, 128), JStencil
        top = convert.stencil_from_arrays(*args, "cpu")
    elif kind == "chain_far":
        args, shape, jcls = ((-130, -1, 0, 3), (0.5, -1.0, 2.0, 0.25)), (4, 128), JStencil
        top = convert.stencil_from_arrays(*args, "cpu")
    elif kind == "grid":
        args, shape, jcls = ((4, 128), POISSON_OFF, ADVECTION_CF), (4, 128), JGrid
        top = convert.grid_stencil_from_arrays(*args, "cpu")
    else:
        args, shape, jcls = ((2, 256), POISSON_OFF, ADVECTION_CF), (4, 128), JGrid
        top = convert.grid_stencil_from_arrays(*args, "cpu")
    spec_n, spec_a = tfl.spec_for(top), tfl.adjoint_spec(top)
    assert tuple(spec_a) == tuple(jpf.adjoint_spec(jcls(*args)))
    A = _dense_of(top.normal, shape)
    assert np.abs(A - A.T).max() > 0.1
    np.testing.assert_allclose(_dense_of(lambda x: tfl.stencil_apply_spec(x, spec_n), shape), A,
                               atol=1e-6)
    At = _dense_of(lambda x: tfl.stencil_apply_spec(x, spec_a), shape)
    np.testing.assert_allclose(At, A.T, atol=1e-6)
    np.testing.assert_allclose(_dense_of(top.adjoint, shape), A.T, atol=1e-6)


@pytest.mark.parametrize("B", [1, 12, 23])
def test_fused_step_reference_matches_pallas_adjoint_grid(B):
    """The codomain half-step of fused GKL: the adjoint spec of a
    non-symmetric grid stencil, drift on, ``kp1 = B``."""
    grid = (32, 256)
    jop = JGrid(grid, POISSON_OFF, ADVECTION_CF)
    top_ = convert.grid_stencil_from_arrays(grid, POISSON_OFF, ADVECTION_CF, "cpu")
    V, y, g = _inputs(25, 64, 31 + B)
    jspec, tspec = jpf.adjoint_spec(jop), tfl.adjoint_spec(top_)
    assert tuple(jspec) == tuple(tspec)
    T = jpf.choose_tile(64, 16, jspec.h)
    # the JAX kernel launches a bucket of rows; rows past kp1 carry zero
    # coefficients, as in its GKL expansion
    Bj = next(b for b in (4, 8, 12, 16, 20, 24, 25) if b >= B)
    gj = g.copy()
    gj[B:25] = 0
    Vn, yn, raw, _, _ = jpf.fused_step(
        jnp.asarray(V), jnp.asarray(y), jpf.boundary_cache(jnp.asarray(V), T, jspec.h),
        jpf.boundary_cache(jnp.asarray(y), T, jspec.h), jnp.asarray(gj), jnp.int32(B),
        Bj, jspec, tile_rows=16, interpret=True, with_drift=True,
    )
    Vt = torch.from_numpy(V.copy())
    ynt, rawt = tfl.fused_step_reference(Vt, torch.from_numpy(y), torch.from_numpy(g), B, B,
                                         tspec, True)
    sc = float(np.max(np.abs(np.asarray(yn))))
    np.testing.assert_allclose(Vt[B].numpy(), np.asarray(Vn)[B], atol=2e-4 * sc)
    np.testing.assert_allclose(ynt.numpy(), np.asarray(yn), atol=2e-4 * sc)
    raw = np.asarray(raw)
    np.testing.assert_allclose(rawt[:B].numpy(), raw[:B], rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(rawt[B:2 * B].numpy(), raw[Bj:Bj + B], rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(rawt[2 * B:].numpy(), raw[2 * Bj:2 * Bj + 2], rtol=2e-4)


@pytest.mark.parametrize("kind", ["chain", "grid"])
def test_fused_step_reference_no_live_row_matches_pallas(kind):
    """The first domain half-step of fused GKL: no live row (``B = 0``,
    ``kp1 = 0``), so ``w' = γ·y`` and ``raw = [rp | q]``.  The JAX kernel runs
    its smallest bucket there with zero coefficients.  Tolerances as the
    other steps: 2e-4·scale on vectors, 2e-4 relative on the two sums."""
    if kind == "chain":
        offs, cf = (-2, 0, 1), (0.4, 1.0, -0.8)
        jop, top_ = JStencil(offs, cf), convert.stencil_from_arrays(offs, cf, "cpu")
    else:
        grid = (32, 256)
        jop = JGrid(grid, POISSON_OFF, ADVECTION_CF)
        top_ = convert.grid_stencil_from_arrays(grid, POISSON_OFF, ADVECTION_CF, "cpu")
    V, y, g = _inputs(13, 64, 77)
    jspec, tspec = jpf.spec_for(jop), tfl.spec_for(top_)
    assert tuple(jspec) == tuple(tspec)
    T = jpf.choose_tile(64, 16, jspec.h)
    gj = g.copy()
    gj[:13] = 0
    Vn, yn, raw, _, _ = jpf.fused_step(
        jnp.asarray(V), jnp.asarray(y), jpf.boundary_cache(jnp.asarray(V), T, jspec.h),
        jpf.boundary_cache(jnp.asarray(y), T, jspec.h), jnp.asarray(gj), jnp.int32(0),
        4, jspec, tile_rows=16, interpret=True, with_drift=True,
    )
    Vt = torch.from_numpy(V.copy())
    # the port's coefficients are not read at B = 0: leave them non-zero
    ynt, rawt = tfl.fused_step(Vt, torch.from_numpy(y), torch.from_numpy(g), 0, 0, tspec, True)
    assert rawt.shape == (2,)
    assert np.array_equal(Vt[1:].numpy(), V[1:])
    sc = float(np.max(np.abs(np.asarray(yn))))
    np.testing.assert_allclose(Vt[0].numpy(), g[13] * y, rtol=1e-6)
    np.testing.assert_allclose(Vt[0].numpy(), np.asarray(Vn)[0], atol=2e-4 * sc)
    np.testing.assert_allclose(ynt.numpy(), np.asarray(yn), atol=2e-4 * sc)
    np.testing.assert_allclose(rawt.numpy(), np.asarray(raw)[8:10], rtol=2e-4)
    # without drift the packing is the same two sums
    _, raw_nd = tfl.fused_step_reference(torch.from_numpy(V.copy()), torch.from_numpy(y),
                                         torch.from_numpy(g), 0, 0, tspec, False)
    assert torch.equal(raw_nd, rawt)


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


@pytest.mark.parametrize("dgks", [False, True])
def test_stepper_returns_projection_column(dgks):
    # advance and tail hand back the full projection column h (j <= k), the
    # column the fused GMRES cycle builds its shifted Hessenberg from
    import jax

    kmax, R = 8, 16
    jop = JGrid((16, 128), POISSON_OFF, POISSON_CF)
    top_ = convert.grid_stencil_from_arrays((16, 128), POISSON_OFF, POISSON_CF, "cpu")
    x = np.random.default_rng(3).standard_normal((R, 128)).astype(np.float32)
    V = np.zeros((kmax, R, 128), np.float32)
    V[0] = x / np.linalg.norm(x)
    jprime, jadvance, jtail = jkf.make_fused_stepper(jop, kmax, dgks, JSTANDARD)
    tprime, tadvance, ttail = tkf.make_fused_stepper(top_, kmax, dgks, STANDARD)
    old = jkf.fused_interpret
    jkf.fused_interpret = True
    try:
        jc = jprime(jnp.asarray(V), jnp.int32(0), jkf.fused_scales_init(kmax))
        tc = tprime(torch.from_numpy(V.copy()), 0, tkf.fused_scales_init(kmax))
        # one compiled JAX step for the six (op by op each call compiles anew)
        jadvance = jax.jit(jadvance)
        for k in range(kmax - 2):
            jc, ja, jb, jh = jadvance(jc)
            tc, ta, tb, th = tadvance(tc)
            assert th.shape == (kmax,) and not torch.any(th[k + 1:])
            np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=2e-4, atol=2e-5)
            np.testing.assert_allclose(float(ta), float(ja), rtol=2e-4)
            assert float(th[k]) == float(ta)
        _, _, _, _, jh = jtail(jc, jax.tree_util.tree_structure(jnp.asarray(V)), jnp.bool_(True))
        _, _, ta, _, th = ttail(tc, True)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=2e-4, atol=2e-5)
        assert ttail(tc, False)[4] is None
    finally:
        jkf.fused_interpret = old
