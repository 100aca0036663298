"""PyTorch port: sharded solves (``VectorSpace(psum_axis=...)``, the
distribution layer) against the JAX package's sharded solves on the CPU.

One group of 4 gloo ranks on the CPU is spawned for the module
(``chip_smoke.start_ranks``, a 120 s collective timeout) and runs every
scenario of ``chip_smoke.sharded_cases`` here, while the module's fixture
computes the JAX side of every scenario (cached); each is its own test,
and every rank must return the same bits.  The JAX side runs the same problems
on 4 of the conftest's virtual CPU devices: GSPMD for the ELL and
``sharded_laplacian_1d`` solves (``tests/test_sharded_sparse.py``,
``tests/test_sparse_and_spaces.py:85,109,155``), ``shard_map`` with
``psum_axis`` and the fused kernel in interpret mode for the fused Lanczos
(``tests/test_fused_lanczos.py:775,809,829``), and the batched GMRES of
``__graft_entry__.py`` on a ``batch 2 × vec 2`` mesh.

Tolerances: float64 values within 1e-10 and ``numops``, ``numiter``,
``converged`` equal; the float32 fused solves keep the JAX test's rtol 2e-4
(two roundings of one kernel) with equal counts; the float32 stencil apply
the JAX test's atol 1e-5.  In this process: the glued K1 twin with external
halos against the unsharded step and the fused gates under a sharded
space.  The differentiable routes on a sharded space are in
``tests/test_torch_sharded_ad.py``.
"""

from functools import lru_cache, partial

import numpy as np
import pytest
import torch

import chip_smoke
import krylovkit_tpu as kk
import krylovkit_tpu.parallel as jpar
import krylovkit_tpu_torch as kt
from krylovkit_tpu_torch.factorizations import gkl as tgf
from krylovkit_tpu_torch.factorizations import krylov as tkf
from krylovkit_tpu_torch.ops import fused_lanczos as tfl
from krylovkit_tpu_torch.ops.vector import VectorSpace
from krylovkit_tpu_torch.parallel.mesh import MeshAxis

WORLD = 4
SCENARIOS = ("eigsolve_ell", "lssolve_lsmr", "svdsolve_gkl", "eigsolve_laplacian",
             "cg_laplacian", "schursolve_real", "fused_chain_cgs", "fused_chain_cgs2",
             "fused_grid", "stencil_apply", "gmres_batched", "fused_gmres", "project_k5",
             "zero_block_x0")
POISSON = (((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)), (4.0, -1.0, -1.0, -1.0, -1.0))


@pytest.fixture(scope="module")
def ranks():
    """The ranks' results; the JAX side of every scenario (cached) is
    computed while they run."""
    handle = chip_smoke.start_ranks(WORLD, "sharded_cases", dev="cpu", timeout=400,
                                    names=SCENARIOS)
    try:
        for ref in (_jax_ell_eigsolve, _jax_lssolve, _jax_svdsolve, _jax_laplacian_eigsolve,
                    _jax_laplacian_cg, _jax_real_arnoldi, _jax_batched_gmres, _jax_fused_gmres):
            ref()
        _jax_ell_eigsolve(zero_block=True)
        for kind in ("chain_cgs", "chain_cgs2", "grid"):
            _jax_sharded_fused(kind)
    finally:
        res = chip_smoke.collect_ranks(handle)
    return chip_smoke.same_on_every_rank(np, res)


def _case(ranks, name):
    out = ranks[name]
    assert "error" not in out, out.get("error")
    return out


def _mesh(D=WORLD, batch=1):
    import jax

    if len(jax.devices()) < D:
        pytest.skip(f"needs {D} virtual devices")
    return jpar.make_mesh(D, batch=batch)


def _put(x, mesh, spec=("vec",)):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(*spec)))


def _host(info):
    """A JAX solve's counts as host ints."""
    return tuple(int(c) for c in (info.numops, info.numiter, info.converged))


@lru_cache(maxsize=None)
def _jax_ell_eigsolve(zero_block=False):
    """The ELL eigsolve of scenario ``eigsolve_ell`` (4 "LM"), or of
    ``zero_block_x0`` (2 "LM", x0 zero on rank 0's block): ``(vals,
    counts)``."""
    n = 104 * 8
    rows, cols, vals = jpar.banded_coo(n, halfband=4, seed=11, spd=True)
    mesh = _mesh()
    op = jpar.sharded_ell_from_coo(rows, cols, vals, (n, n), mesh)
    x0 = np.random.default_rng(13 if zero_block else 12).standard_normal(n)
    if zero_block:
        x0[: n // WORLD] = 0.0
    vals, _, info = kk.eigsolve(op, _put(x0, mesh), 2 if zero_block else 4, "LM",
                                ishermitian=True, tol=1e-10, krylovdim=30, maxiter=200)
    return np.asarray(vals), _host(info)


def test_sharded_eigsolve_ell_matches_jax(ranks):
    out = _case(ranks, "eigsolve_ell")
    vals, counts = _jax_ell_eigsolve()
    np.testing.assert_allclose(out["vals"], vals, rtol=0, atol=1e-10)
    assert (out["numops"], out["numiter"], out["converged"]) == counts
    assert out["converged"] >= 4


def test_sharded_zero_block_start_solves_on_every_rank(ranks):
    """x0 is zero on rank 0's block: the zero-start guard reads the global
    norm, so no rank raises alone and the solve matches the JAX one."""
    out = _case(ranks, "zero_block_x0")
    vals, counts = _jax_ell_eigsolve(zero_block=True)
    np.testing.assert_allclose(out["vals"], vals, rtol=0, atol=1e-10)
    assert (out["numops"], out["numiter"], out["converged"]) == counts


@lru_cache(maxsize=None)
def _jax_lssolve():
    m, n = 96 * 8, 48 * 8
    rows, cols, vals = jpar.rect_sparse_coo(m, n, nnz_per_row=6, seed=21)
    mesh = _mesh()
    op = jpar.sharded_ell_from_coo(rows, cols, vals, (m, n), mesh)
    b = np.random.default_rng(22).standard_normal(m)
    x, info = kk.lssolve(op, _put(b, mesh), tol=1e-12, maxiter=3 * n)
    return np.asarray(x), _host(info), (rows, cols, vals, b)


def test_sharded_lssolve_lsmr_matches_jax(ranks):
    out = _case(ranks, "lssolve_lsmr")
    m, n = 96 * 8, 48 * 8
    x, counts, (rows, cols, vals, b) = _jax_lssolve()
    np.testing.assert_allclose(out["x"], x, rtol=0, atol=1e-10)
    assert (out["numops"], out["numiter"], out["converged"]) == counts
    A = np.zeros((m, n))
    A[rows, cols] = vals
    np.testing.assert_allclose(out["x"], np.linalg.lstsq(A, b, rcond=None)[0], rtol=0, atol=1e-7)


@lru_cache(maxsize=None)
def _jax_svdsolve():
    m, n = 64 * 8, 40 * 8
    rows, cols, vals = jpar.rect_sparse_coo(m, n, nnz_per_row=5, seed=31)
    mesh = _mesh()
    op = jpar.sharded_ell_from_coo(rows, cols, vals, (m, n), mesh)
    x0 = np.random.default_rng(32).standard_normal(m)
    S, _, _, info = kk.svdsolve(op, _put(x0, mesh), 3, "LR", tol=1e-10, krylovdim=30, maxiter=100)
    return np.asarray(S), _host(info)


def test_sharded_svdsolve_matches_jax(ranks):
    """Unfused GKL on the sharded rectangular operator (both halo plans)."""
    out = _case(ranks, "svdsolve_gkl")
    S, counts = _jax_svdsolve()
    np.testing.assert_allclose(out["vals"], S, rtol=0, atol=1e-10)
    assert (out["numops"], out["numiter"], out["converged"]) == counts
    assert out["converged"] >= 3


@lru_cache(maxsize=None)
def _jax_laplacian_eigsolve():
    import jax.numpy as jnp

    n = 256
    mesh = _mesh()
    op = jpar.sharded_laplacian_1d(n, mesh, jnp.float64)
    x0 = np.random.default_rng(105).standard_normal(n)
    vals, _, info = kk.eigsolve(op, _put(x0, mesh), 2, "LM", ishermitian=True, tol=1e-8,
                                krylovdim=30, maxiter=300)
    return np.asarray(vals), _host(info)


def test_sharded_laplacian_eigsolve_matches_jax(ranks):
    out = _case(ranks, "eigsolve_laplacian")
    vals, counts = _jax_laplacian_eigsolve()
    np.testing.assert_allclose(out["vals"], vals, rtol=0, atol=1e-10)
    assert (out["numops"], out["numiter"], out["converged"]) == counts


@lru_cache(maxsize=None)
def _jax_laplacian_cg():
    import jax.numpy as jnp

    n = 512
    mesh = _mesh()
    op = jpar.sharded_laplacian_1d(n, mesh, jnp.float64)
    b = np.random.default_rng(104).standard_normal(n)
    x, info = kk.linsolve(op, _put(b, mesh), alg=kk.CG(tol=1e-10, maxiter=3000))
    return np.asarray(x), _host(info), b


def test_sharded_laplacian_cg_matches_jax(ranks):
    out = _case(ranks, "cg_laplacian")
    n = 512
    x, counts, b = _jax_laplacian_cg()
    np.testing.assert_allclose(out["x"], x, rtol=1e-10, atol=1e-10)
    assert (out["numops"], out["numiter"], out["converged"]) == counts
    Ad = 2 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)
    assert np.linalg.norm(Ad @ out["x"] - b) <= 1e-7


@lru_cache(maxsize=None)
def _jax_real_arnoldi():
    import jax
    import jax.numpy as jnp

    n = 256
    mesh = _mesh()
    d = jnp.asarray(np.linspace(1.0, 5.0, n))
    idx = jnp.arange(n)

    def pin(y):
        from jax.sharding import NamedSharding, PartitionSpec as P

        return jax.lax.with_sharding_constraint(y, NamedSharding(mesh, P("vec")))

    def apply(x):
        return pin(d * x + 0.02 * jnp.where(idx < n - 1, jnp.roll(x, -1), 0.0))

    def apply_adj(x):
        return pin(d * x + 0.02 * jnp.where(idx > 0, jnp.roll(x, 1), 0.0))

    x0 = np.random.default_rng(106).standard_normal(n)
    _, _, (re, im), info = kk.schursolve((apply, apply_adj), _put(x0, mesh), howmany=2,
                                         which="LM", krylovdim=25, maxiter=150, tol=1e-9)
    return np.asarray(re), np.asarray(im), _host(info)


def test_sharded_real_arnoldi_matches_jax(ranks):
    """Real Schur Arnoldi on a non-normal triangular map; the port's rank
    blocks apply it as a sharded ELL operator, JAX's closure under GSPMD."""
    out = _case(ranks, "schursolve_real")
    re, im, counts = _jax_real_arnoldi()
    np.testing.assert_allclose(out["re"], re, rtol=0, atol=1e-10)
    np.testing.assert_allclose(out["im"], im, rtol=0, atol=1e-10)
    assert (out["numops"], out["numiter"], out["converged"]) == counts


@lru_cache(maxsize=None)
def _jax_sharded_fused(kind):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from krylovkit_tpu.factorizations import krylov as jkf
    from krylovkit_tpu.ops.vector import VectorSpace as JSpace
    from krylovkit_tpu.solvers.lanczos import eigsolve_lanczos as j_lanczos

    if kind == "grid":
        gr, gc = 64, 256
        op = jpar.poisson_2d(gr, gc, jnp.float32)
        x = np.random.default_rng(62).standard_normal((gr * gc // 128, 128))
        alg = kk.Lanczos(krylovdim=16, maxiter=3, tol=1e-6)
    else:
        n = 1 << 15
        op = jpar.laplacian_1d(n, jnp.float32)
        x = np.random.default_rng(61).standard_normal((n // 128, 128))
        alg = kk.Lanczos(krylovdim=16, maxiter=4, tol=1e-6,
                         orth=getattr(kk, chip_smoke.SHARDED_FUSED[kind]))
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("vec",))
    space = JSpace(psum_axis="vec")
    op_local = jpar.shard_local_stencil(op, "vec")

    @partial(jax.shard_map, mesh=mesh, in_specs=P("vec", None),
             out_specs=(P(), P(None, "vec", None), P(), P(), P()), check_vma=False)
    def run(x0):
        vals, vecs, info = j_lanczos(op_local, x0, 4, "LM", alg, space=space)
        return vals, vecs, info.converged, info.numiter, info.numops

    old = jkf.fused_interpret
    jkf.fused_interpret = True
    try:
        return tuple(np.asarray(a) for a in
                     jax.jit(run)(_put(x.astype(np.float32), mesh, ("vec", None))))
    finally:
        jkf.fused_interpret = old


@pytest.mark.parametrize("kind", ["chain_cgs", "chain_cgs2", "grid"])
def test_sharded_fused_lanczos_matches_jax(ranks, kind):
    """Lanczos on ``shard_local_stencil`` with the fused kernel per rank and
    the neighbours' edge rows as its external halos."""
    out = _case(ranks, f"fused_{kind}")
    assert out["fused"]
    vals, vecs, conv, numiter, numops = _jax_sharded_fused(kind)
    np.testing.assert_allclose(out["vals"], np.asarray(vals), rtol=2e-4)
    assert (out["numops"], out["numiter"]) == (int(numops), int(numiter))
    for i in range(4):
        a, b = out["vecs"][i].reshape(-1), np.asarray(vecs[i]).reshape(-1)
        np.testing.assert_allclose(abs(np.dot(a, b)), 1.0, rtol=1e-3)


def test_shard_local_stencil_equals_global_apply(ranks):
    out = _case(ranks, "stencil_apply")
    import jax.numpy as jnp

    n = 1 << 14
    op = kk.StencilOperator((-200, 0, 200), (0.3, 1.0, -0.4))
    x = np.random.default_rng(71).standard_normal((n // 128, 128)).astype(np.float32)
    np.testing.assert_allclose(out["y"], np.asarray(op.normal(jnp.asarray(x))), atol=1e-5)
    np.testing.assert_allclose(out["z"], np.asarray(op.adjoint(jnp.asarray(x))), atol=1e-5)


@lru_cache(maxsize=None)
def _jax_batched_gmres():
    import jax
    import jax.numpy as jnp

    from krylovkit_tpu.solvers.gmres import linsolve_gmres

    mesh = _mesh(WORLD, batch=2)
    n3 = 32 * 2
    op = jpar.sharded_laplacian_1d(n3, mesh, jnp.float64)
    B = _put(np.ones((4, n3)), mesh, ("batch", "vec"))
    galg = kk.GMRES(krylovdim=16, maxiter=50, tol=1e-9)
    one = jnp.asarray(1, jnp.float64)
    X, infos = jax.jit(jax.vmap(
        lambda b: linsolve_gmres(op, b, jnp.zeros_like(b), one, one, galg)))(B)
    return np.asarray(X), infos


def test_sharded_batched_gmres_matches_jax(ranks):
    """GMRES on ``(I + L) x = 1`` for 4 right-hand sides over a ``batch 2 ×
    vec 2`` mesh (``__graft_entry__.dryrun_multichip``)."""
    out = _case(ranks, "gmres_batched")
    n3 = 32 * 2
    X, infos = _jax_batched_gmres()
    np.testing.assert_allclose(out["X"], X, rtol=0, atol=1e-10)
    for i, info in enumerate(out["infos"] * 2):
        assert (info["numops"], info["numiter"], info["converged"]) == (
            int(infos.numops[i]), int(infos.numiter[i]), int(infos.converged[i]))
    L = 3 * np.eye(n3) - np.eye(n3, k=1) - np.eye(n3, k=-1)
    assert max(np.linalg.norm(L @ x - 1) for x in out["X"]) < 1e-3


@lru_cache(maxsize=None)
def _jax_fused_gmres():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from krylovkit_tpu.factorizations import krylov as jkf
    from krylovkit_tpu.ops.vector import VectorSpace as JSpace
    from krylovkit_tpu.solvers.gmres import linsolve_gmres

    gr, gc = 64, 256
    op_local = jpar.shard_local_stencil(jpar.poisson_2d(gr, gc, jnp.float32), "vec")
    b = np.random.default_rng(63).standard_normal((gr * gc // 128, 128)).astype(np.float32)
    alg = kk.GMRES(krylovdim=16, maxiter=3, tol=1e-6)
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("vec",))

    @partial(jax.shard_map, mesh=mesh, in_specs=P("vec", None),
             out_specs=(P("vec", None), P(), P(), P()), check_vma=False)
    def run(bl):
        x, info = linsolve_gmres(op_local, bl, jnp.zeros_like(bl), jnp.float32(0.5),
                                 jnp.float32(1.0), alg, JSpace(psum_axis="vec"))
        return x, info.numops, info.numiter, info.converged

    old = jkf.fused_interpret
    jkf.fused_interpret = True
    try:
        x, numops, numiter, conv = jax.jit(run)(_put(b, mesh, ("vec", None)))
    finally:
        jkf.fused_interpret = old
    return np.asarray(x), numops, numiter, conv


def test_sharded_fused_gmres_matches_jax(ranks):
    """The fused GMRES cycle on the sharded grid stencil: K1 per rank with
    external halos, the stepper's one all-reduce a step."""
    out = _case(ranks, "fused_gmres")
    assert out["fused"]
    x, numops, numiter, conv = _jax_fused_gmres()
    assert (out["numops"], out["numiter"], out["converged"]) == (int(numops), int(numiter),
                                                                 int(conv))
    np.testing.assert_allclose(out["x"], x, rtol=0, atol=2e-4 * float(np.abs(x).max()))


def test_sharded_project_with_k5_is_all_reduced(ranks):
    """``project`` with the projection flag on: K5's plain version per rank
    on its rows, then one all-reduce, equals the global projection."""
    out = _case(ranks, "project_k5")
    R, kmax, k = 32, 9, 6
    rng = np.random.default_rng(81)
    V = rng.standard_normal((kmax, R * WORLD, 128)).astype(np.float32)
    w = rng.standard_normal((R * WORLD, 128)).astype(np.float32)
    want = V.reshape(kmax, -1).astype(np.float64) @ w.reshape(-1).astype(np.float64)
    want[k:] = 0
    scale = np.linalg.norm(V.reshape(kmax, -1), axis=1) * np.linalg.norm(w)
    assert np.all(np.abs(out["c"] - want) <= 1e-5 * scale)
    assert np.all(out["c"][k:] == 0)


# --------------------------------------------------------------------------
# in this process: the K1 twin glued from shards, the gates, the refusals
# --------------------------------------------------------------------------


def _split_with_halos(X, D, h):
    """Blocks of ``X (..., R, 128)`` over ``D`` ranks with each block's
    neighbouring ``h`` rows as ``(..., 2, h, 128)`` halos, zero at the ends."""
    R = X.shape[-2]
    rb = R // D
    blocks, halos = [], []
    zero = torch.zeros(X.shape[:-2] + (h, 128), dtype=X.dtype)
    for d in range(D):
        blocks.append(X[..., d * rb:(d + 1) * rb, :].clone())
        above = X[..., d * rb - h:d * rb, :] if d > 0 else zero
        below = X[..., (d + 1) * rb:(d + 1) * rb + h, :] if d < D - 1 else zero
        halos.append(torch.stack([above, below], dim=-3).contiguous())
    return blocks, halos


@pytest.mark.parametrize("kind", ["chain", "grid"])
@pytest.mark.parametrize("B,with_drift", [(0, False), (1, False), (5, False), (5, True)])
def test_glued_k1_twin_with_halos_equals_unsharded(kind, B, with_drift):
    if kind == "chain":
        op = kt.StencilOperator((-200, 0, 200), (0.3, 1.0, -0.4))  # h = 2
        R = 128
    else:
        op = kt.GridStencilOperator((64, 256), *POISSON)  # h = 2 layout rows per grid row
        R = 128
    spec = tfl.spec_for(op)
    kmax, kp1 = 9, max(B, 1)
    gen = torch.Generator().manual_seed(91 + B)
    V = torch.randn((kmax, R, 128), generator=gen)
    y = torch.randn((R, 128), generator=gen)
    g = torch.randn(kmax + 1, generator=gen)
    Vg = V.clone()
    yg, rawg = tfl.fused_step_reference(Vg, y, g, kp1, B, spec, with_drift)
    Vb, Vh = _split_with_halos(V, WORLD, spec.h)
    yb, yh = _split_with_halos(y, WORLD, spec.h)
    ys, raws = [], []
    for d in range(WORLD):
        yn, raw = tfl.fused_step(Vb[d], yb[d], g, kp1, B, spec, with_drift, Vext=Vh[d], yext=yh[d])
        ys.append(yn)
        raws.append(raw)
    scale = float(yg.abs().max())
    np.testing.assert_allclose(torch.cat(ys).numpy(), yg.numpy(), rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(torch.cat([v[kp1] for v in Vb]).numpy(), Vg[kp1].numpy(),
                               rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(sum(raws).numpy(), rawg.numpy(), rtol=1e-5,
                               atol=1e-5 * float(rawg.abs().max()))
    # rows other than kp1 are untouched
    for d in range(WORLD):
        keep = [j for j in range(kmax) if j != kp1]
        assert torch.equal(Vb[d][keep], _split_with_halos(V, WORLD, spec.h)[0][d][keep])


def test_k1_twin_zero_halos_is_the_dirichlet_step():
    op = kt.StencilOperator((-1, 0, 1), (-1.0, 2.0, -1.0))
    spec = tfl.spec_for(op)
    gen = torch.Generator().manual_seed(93)
    V = torch.randn((9, 32, 128), generator=gen)
    y = torch.randn((32, 128), generator=gen)
    g = torch.randn(10, generator=gen)
    V1, V2 = V.clone(), V.clone()
    a = tfl.fused_step(V1, y, g, 5, 4, spec, True)
    b = tfl.fused_step(V2, y, g, 5, 4, spec, True, Vext=torch.zeros((9, 2, 1, 128)),
                       yext=torch.zeros((2, 1, 128)))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and torch.equal(V1, V2)
    with pytest.raises(ValueError, match="both external halos"):
        tfl.fused_step(V.clone(), y, g, 5, 4, spec, Vext=torch.zeros((9, 2, 1, 128)))


def _space(size, index=0):
    """A sharded space on an axis of ``size`` ranks that makes no collective
    (the gates read only its size)."""
    return VectorSpace(psum_axis=MeshAxis("vec", None, size, index))


def test_grid_shard_cut_gate():
    """A sharded grid fuses only when the blocks cut whole grid rows and the
    global rows cover the grid (``tests/test_fused_lanczos.py:882``)."""
    op = kt.GridStencilOperator((32, 1280), *POISSON)  # mrow = 10 (h = 10)
    x = torch.ones((80, 128), dtype=torch.float32)
    space = _space(4)
    assert tkf.fused_available(op, x[:80], space, kmax=9)
    assert not tkf.fused_available(op, x[:72], space, kmax=9)
    assert not tkf.fused_available(op, x[:80], _space(2), kmax=9)  # covers half the grid
    assert not tkf.fused_available(op, x[:80], VectorSpace(), kmax=9)


def test_fused_gkl_gate_refuses_a_sharded_space():
    op = kt.StencilOperator((-1, 0, 1), (-1.0, 2.0, -1.0))
    x0 = torch.ones((32, 128), dtype=torch.float32)
    assert tgf.fused_kernel_available(op, x0, VectorSpace(), 31)
    assert not tgf.fused_kernel_available(op, x0, _space(4), 31)
    assert not tgf.fused_kernel_available(op, x0, _space(1), 31)
