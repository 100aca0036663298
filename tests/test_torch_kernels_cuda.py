"""PyTorch port: the hand-written CUDA kernels against their plain PyTorch
versions on the card — the pytest form of ``chip_smoke.py``'s kernel phase.
Needs an NVIDIA GPU (marker ``cuda``; skipped elsewhere).  Imports no JAX.

    python -m pytest tests/test_torch_kernels_cuda.py -q     # on a machine with a card
"""

import numpy as np
import pytest
import torch

import krylovkit_tpu_torch as kt
from chip_smoke import poisson_coo, q1_coo
from krylovkit_tpu_torch import _build
from krylovkit_tpu_torch.ops import banded as bd
from krylovkit_tpu_torch.ops import basis as bs
from krylovkit_tpu_torch.ops import fused_lanczos as fl
from krylovkit_tpu_torch.ops import projections as pb
from krylovkit_tpu_torch.ops import stencil_1d as s1
from krylovkit_tpu_torch.ops.operator import GridStencilOperator, StencilOperator

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda

POISSON_OFF = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))
POISSON_CF = (4.0, -1.0, -1.0, -1.0, -1.0)


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _gen(seed):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return g


# B > 32 reaches the kernel's wider register instantiations: KACC 64 with
# drift (B <= 63), KACC 64 and 128 without (B <= 126)
WIDE = [(64, 40, True), (64, 50, False), (127, 100, False), (64, 63, True), (127, 126, False)]

# (kind, B, kp1, with_drift, kmax, R): every tile height of the plan (B = 1..4
# eight rows, 8 four, 16..29 two, wide B one), a run that ends inside a tile
# (R = 1000, 8200), R below one tile and a single row, kp1 > B, a chain whose
# taps reach three rows (h = 3), the grid spec (h = 8), and with B = 63 on
# the grid the plan that re-reads V for the reductions
FUSED_CASES = (
    [(kind, B, B, drift, 31, None)
     for kind, B in [("chain", 1), ("chain", 2), ("chain", 4), ("chain", 8), ("chain", 29),
                     ("chain_multirow", 8), ("grid", 16), ("grid", 30)]
     for drift in (False, True)]
    + [("chain", B, B, drift, kmax, None) for kmax, B, drift in WIDE]
    + [("chain", 16, 16, True, 31, 8200), ("chain", 4, 4, True, 31, 3), ("chain", 4, 4, True, 8, 1),
       ("chain", 30, 30, True, 31, 9), ("chain", 5, 9, True, 31, None), ("grid", 16, 20, False, 31, None),
       ("grid", 63, 63, True, 64, None), ("chain_multirow", 40, 45, True, 64, None)]
    # the codomain half-step of fused GKL: the adjoint spec of a non-symmetric
    # grid stencil with drift, up to the 31 live rows of krylovdim 30; and its
    # domain half-step on the non-symmetric stencil itself
    + [("grid_adjoint", B, B, True, 31, None) for B in (1, 12, 23, 30)]
    + [("grid_adjoint", 31, 31, True, 32, None), ("grid_nonsym", 22, 22, True, 31, None),
       ("chain_adjoint", 9, 9, True, 31, None)]
    # no live row: the first domain half-step of a fused GKL solve (kp1 = 0),
    # and the same with a later new row
    + [("grid_nonsym", 0, 0, True, 31, None), ("chain", 0, 0, True, 31, None),
       ("chain", 0, 0, False, 31, None), ("chain_multirow", 0, 3, True, 31, None),
       ("chain", 0, 0, True, 8, 1)]
)

ADVECTION_CF = (4.0, -1.5, -0.5, -1.2, -0.8)


def _fused_case(kind, R):
    """``(spec, R)`` of a case."""
    if kind.startswith("grid_"):
        op = GridStencilOperator((256, 1024), POISSON_OFF, ADVECTION_CF)
        return (fl.adjoint_spec(op) if kind == "grid_adjoint" else fl.spec_for(op)), 2048
    if kind == "chain_adjoint":
        return fl.adjoint_spec(StencilOperator((-2, 0, 1), (0.4, 1.0, -0.8))), R or 1000
    op, R = _fused_op(kind, R)
    return fl.spec_for(op), R


def _fused_op(kind, R):
    if kind == "chain":
        return StencilOperator((-1, 0, 1), (-1.0, 2.0, -1.0)), R or 1000  # ragged last block
    if kind == "chain_multirow":
        return StencilOperator((-300, -1, 0, 1, 300), (0.1, -1.0, 2.0, -1.0, 0.2)), R or 256
    return GridStencilOperator((256, 1024), POISSON_OFF, POISSON_CF), 2048


@pytest.mark.parametrize("kind,B,kp1,with_drift,kmax,R", FUSED_CASES)
def test_fused_step_kernel_matches_plain(kind, B, kp1, with_drift, kmax, R):
    spec, R = _fused_case(kind, R)
    gen = _gen(B)
    V = torch.randn((kmax, R, 128), generator=gen, device="cuda")
    y = torch.randn((R, 128), generator=gen, device="cuda")
    g = torch.randn(kmax + 1, generator=gen, device="cuda")
    Vk, Vr = V.clone(), V.clone()
    before = _build.launches["fused_step"]
    yk, rk = fl.fused_step(Vk, y, g, kp1, B, spec, with_drift)
    assert _build.launches["fused_step"] == before + 1
    yr, rr = fl.fused_step_reference(Vr, y, g, kp1, B, spec, with_drift)
    torch.cuda.synchronize()
    # in place: the rows it reads (< B) and every other row but kp1 keep their bits
    assert torch.equal(Vk[:kp1], V[:kp1]) and torch.equal(Vk[kp1 + 1:], V[kp1 + 1:])
    sc = float(yr.abs().max())
    assert float((Vk[kp1] - Vr[kp1]).abs().max()) <= 2e-4 * sc
    assert float((yk - yr).abs().max()) <= 2e-4 * sc
    torch.testing.assert_close(rk, rr, rtol=2e-4, atol=2e-3 * R ** 0.5)
    # deterministic: the same launch gives the same bits
    Vk2 = V.clone()
    yk2, rk2 = fl.fused_step(Vk2, y, g, kp1, B, spec, with_drift)
    assert torch.equal(yk, yk2) and torch.equal(rk, rk2) and torch.equal(Vk, Vk2)


def test_fused_step_plan_of_the_card_fits_it():
    props = torch.cuda.get_device_properties(0)
    for R, B, h in [(16384, 30, 1), (8192, 16, 8), (8192, 63, 8), (1000, 126, 1)]:
        plan = fl.plan_step(R, B, h, False, props.multi_processor_count)
        assert plan.smem_bytes <= props.shared_memory_per_block_optin
        assert plan.nblocks <= props.multi_processor_count


def test_fused_step_without_a_live_row_scales_y():
    # B = 0 launches the kernel: w' = gamma * y whatever g[:kmax] holds
    spec = fl.spec_for(StencilOperator((-1, 0, 1), (-1.0, 2.0, -1.0)))
    gen = _gen(0)
    V = torch.randn((5, 16, 128), generator=gen, device="cuda")
    y = torch.randn((16, 128), generator=gen, device="cuda")
    g = torch.randn(6, generator=gen, device="cuda")
    before = _build.launches["fused_step"]
    Vk = V.clone()
    yn, raw = fl.fused_step(Vk, y, g, 0, 0, spec, True)
    assert _build.launches["fused_step"] == before + 1
    assert raw.shape == (2,) and torch.equal(Vk[1:], V[1:])
    assert torch.equal(Vk[0], g[5] * y)
    torch.testing.assert_close(yn, fl.stencil_apply_spec(Vk[0], spec), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("R", [4096, 8192])
def test_transform_kernel_at_the_svd_restart_shapes(R):
    """The two rotations of a GKL thick restart: ``(31, R, 128)`` bases,
    ``keep_max + 1 = 21`` rows written, the tail bit-identical."""
    gen = _gen(R)
    V = torch.randn((31, R, 128), generator=gen, device="cuda")
    U = torch.randn((31, 31), generator=gen, device="cuda") / 31 ** 0.5
    Vk = bs.transform_partial_inplace(V.clone(), U, 21)
    Vr = bs.transform_partial_inplace_reference(V.clone(), U, 21)
    torch.cuda.synchronize()
    assert torch.equal(Vk[21:], V[21:])
    torch.testing.assert_close(Vk[:21], Vr[:21], rtol=1e-5, atol=1e-5)


# every rung of the kernel's ladder (kmax <= 16, 32, 64, 128) at its edges
TRANSFORM_CASES = [(31, 20), (31, 4), (31, 31), (8, 3), (16, 16), (17, 9), (32, 21), (33, 20),
                   (64, 40), (70, 40), (128, 128), (128, 5)]


@pytest.mark.parametrize("kmax,m_out", TRANSFORM_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_transform_kernel_matches_plain(kmax, m_out, dtype):
    gen = _gen(kmax + m_out)
    V = torch.randn((kmax, 64, 128), generator=gen, device="cuda").to(dtype)
    U = torch.randn((kmax, kmax), generator=gen, device="cuda") / kmax ** 0.5
    before = _build.launches["transform_partial"]
    Vk = bs.transform_partial_inplace(V.clone(), U, m_out)
    assert _build.launches["transform_partial"] == before + 1
    Vr = bs.transform_partial_inplace_reference(V.clone(), U, m_out)
    torch.cuda.synchronize()
    assert Vk.dtype == dtype and torch.equal(Vk[m_out:], V[m_out:])
    if dtype == torch.float32:
        torch.testing.assert_close(Vk[:m_out], Vr[:m_out], rtol=1e-5, atol=1e-5)
    else:
        # both round a float32 sum of the same bfloat16 products once: 2 ulps
        # (2^-7 each) of the row's largest entry
        scale = Vr[:m_out].float().abs().amax(dim=(1, 2), keepdim=True)
        assert bool(((Vk[:m_out].float() - Vr[:m_out].float()).abs() <= 2 * 2.0 ** -7 * scale).all())
    eye = torch.eye(kmax, device="cuda")
    assert torch.equal(bs.transform_partial_inplace(V.clone(), eye, m_out), V)
    # deterministic
    assert torch.equal(bs.transform_partial_inplace(V.clone(), U, m_out), Vk)


@pytest.mark.parametrize("kmax,m_out", [(31, 20), (64, 7), (100, 33)])
def test_transform_kernel_reads_any_view_of_U(kmax, m_out):
    gen = _gen(kmax)
    V = torch.randn((kmax, 16, 128), generator=gen, device="cuda")
    big = torch.randn((2 * kmax, 3 * kmax), generator=gen, device="cuda", dtype=torch.float64)
    views = [big[::2, 1::3][:kmax, :kmax],                       # strided both ways
             big[:kmax, :kmax].T,                                # transposed
             big[:kmax, :kmax].float().T.contiguous().T]         # float32, column-major
    for U in views:
        assert not U.is_contiguous()
        Vk = bs.transform_partial_inplace(V.clone(), U, m_out)
        Vr = bs.transform_partial_inplace_reference(V.clone(), U.contiguous(), m_out)
        torch.testing.assert_close(Vk, Vr, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kmax", [1, 16, 17, 32, 33, 64, 65, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_transform_rungs_agree_with_the_kernel(kmax, dtype):
    import ctypes
    kreg, cols = ctypes.c_int(), ctypes.c_int()
    bs._lib().kk_transform_rung(kmax, int(dtype == torch.bfloat16), ctypes.byref(kreg),
                                ctypes.byref(cols))
    assert (kreg.value, cols.value) == bs.transform_rung(kmax, dtype)


def test_wrappers_raise_instead_of_falling_back():
    V = torch.zeros((8, 16, 128), device="cuda", dtype=torch.float16)
    with pytest.raises(ValueError):
        bs.transform_partial_inplace(V, torch.eye(8, device="cuda"), 4)
    with pytest.raises(ValueError):  # rows of 12 * 128 values: R % 8 != 0
        bs.transform_partial_inplace(torch.zeros((8, 12, 128), device="cuda"),
                                     torch.eye(8, device="cuda"), 4)
    spec = fl.spec_for(StencilOperator((-1, 0, 1), (-1.0, 2.0, -1.0)))
    V = torch.zeros((8, 16, 128), device="cuda")
    y = torch.zeros((16, 128), device="cuda")
    g = torch.zeros(9, device="cuda")
    with pytest.raises(ValueError):
        fl.fused_step(V, y, g, 3, 5, spec)  # kp1 < B would read the row it writes
    with pytest.raises(ValueError):
        fl.fused_step(V.double(), y.double(), g.double(), 5, 5, spec)


# (n, offsets, dtype): banded Poisson at the config-2 size, halfband 8,
# float64, ragged n (not a multiple of 4 or 128), offsets that straddle lanes,
# and the widest offsets an n allows
BANDED_CASES = [
    (1 << 20, (-1024, -1, 0, 1, 1024), torch.float32),
    (1 << 21, tuple(range(-8, 9)), torch.float32),
    (1 << 20, (-1024, -1, 0, 1, 1024), torch.float64),
    (300, (-2, 0, 5), torch.float32),
    (301, (-2, 0, 5), torch.float64),
    (2048, (-130, -127, -1, 0, 1, 3, 127, 129, 256), torch.float32),
    (1000, (-999, -1, 0, 999), torch.float32),
]


@pytest.mark.parametrize("n,offsets,dtype", BANDED_CASES)
def test_banded_spmv_kernel_matches_plain(n, offsets, dtype):
    gen = _gen(n + len(offsets))
    R = -(-n // 128)
    D = torch.randn((len(offsets), R, 128), generator=gen, device="cuda", dtype=dtype)
    x = torch.randn(n, generator=gen, device="cuda", dtype=dtype)
    before = _build.launches["banded_spmv"]
    y = bd.banded_spmv(x, D, offsets, n)
    assert _build.launches["banded_spmv"] == before + 1
    yr = bd.banded_spmv_reference(x, D, offsets, n)
    torch.cuda.synchronize()
    # float32 FMAs against separate multiply and add, both in offset order
    scale = bd.banded_spmv_reference(x.abs(), D.abs(), offsets, n)
    tol = 1e-6 if dtype == torch.float32 else 1e-15
    assert float(((y - yr).abs() - tol * scale).max()) <= 0
    assert torch.equal(y, bd.banded_spmv(x, D, offsets, n))  # deterministic


@pytest.mark.parametrize("n,dtype", [(1 << 21, torch.float32), (1 << 21, torch.float64),
                                     (1000, torch.float32), (999, torch.float64)])
def test_laplacian_1d_kernel_matches_plain(n, dtype):
    x = torch.randn(n, generator=_gen(n), device="cuda", dtype=dtype)
    before = _build.launches["laplacian_1d"]
    y = s1.laplacian_1d_flat(x)
    assert _build.launches["laplacian_1d"] == before + 1
    # the same operations in the same order: bit-equal
    assert torch.equal(y, s1.laplacian_1d_flat_reference(x))
    if n % 128 == 0:
        op = kt.laplacian_1d_pallas(n, dtype)
        assert torch.equal(op.normal(x.reshape(n // 128, 128)), y)


def test_banded_wrappers_raise_instead_of_falling_back():
    D = torch.ones((3, 2, 128), device="cuda")
    x = torch.ones(256, device="cuda")
    with pytest.raises(ValueError, match="complex"):
        bd.banded_spmv(x.to(torch.complex64), D.to(torch.complex64), (-1, 0, 1), 256)
    with pytest.raises(ValueError, match="float64"):
        bd.banded_spmv(x, D.double(), (-1, 0, 1), 256)
    with pytest.raises(ValueError, match="planes"):
        bd.banded_spmv(x, D[:, :1], (-1, 0, 1), 256)  # planes shorter than n
    with pytest.raises(ValueError, match="float32 or float64"):
        s1.laplacian_1d_flat(x.half())


@pytest.mark.parametrize("alg", [kt.CG(tol=1e-8, maxiter=300),
                                 kt.GMRES(krylovdim=30, tol=1e-8, maxiter=50),
                                 kt.BiCGStab(tol=1e-8, maxiter=300)],
                         ids=["cg", "gmres", "bicgstab"])
def test_banded_linsolve_on_card_matches_cpu(alg):
    nx = 64
    coo = poisson_coo(np, nx, np.float64)
    b = torch.ones((nx * nx // 128, 128), dtype=torch.float64)
    before = _build.launches["banded_spmv"]
    xc, ic = kt.linsolve(kt.banded_from_coo(*coo, nx * nx), b.cuda(), a0=0.5, alg=alg)
    assert _build.launches["banded_spmv"] - before == ic.numops
    xh, ih = kt.linsolve(kt.banded_from_coo(*coo, nx * nx, device="cpu"), b, a0=0.5, alg=alg)
    assert (ic.numops, ic.numiter, ic.converged) == (ih.numops, ih.numiter, 1)
    torch.testing.assert_close(xc.cpu(), xh, rtol=1e-8, atol=1e-8 * float(xh.abs().max()))


# (kmax, R, k): the config-4 basis at its live lengths, the JAX package's test
# shape, the widest basis, and a single row block
PROJECTION_CASES = [(31, 8192, k) for k in (0, 1, 18, 30, 31)] + [
    (13, 16, 0), (13, 16, 5), (13, 16, 13), (128, 8, 128), (128, 8, 77), (5, 8, 3)]


@pytest.mark.parametrize("kmax,R,k", PROJECTION_CASES)
@pytest.mark.parametrize("device_k", [False, True])
def test_projection_kernels_match_plain(kmax, R, k, device_k):
    gen = _gen(kmax + R + k)
    V = torch.randn((kmax, R, 128), generator=gen, device="cuda")
    w = torch.randn((R, 128), generator=gen, device="cuda")
    c = torch.randn(kmax, generator=gen, device="cuda")
    c[k:] = 0
    V[k:] = float("nan")  # rows >= k must never be read
    kk = torch.tensor([k], dtype=torch.int32, device="cuda") if device_k else k
    before = dict(_build.launches)
    got_c = pb.project_pallas(V, w, kk)
    got_y = pb.unproject_pallas(V, c, kk)
    assert _build.launches["project"] == before.get("project", 0) + 1
    assert _build.launches["unproject"] == before.get("unproject", 0) + 1
    want_c, want_y = pb.project_reference(V, w, k), pb.unproject_reference(V, c, k)
    torch.cuda.synchronize()
    assert got_c.shape == (kmax,) and got_y.shape == (R, 128)
    assert bool(torch.isfinite(got_c).all()) and bool(torch.isfinite(got_y).all())
    assert not got_c[k:].any()
    Vk = V[:k].reshape(k, R * 128)
    # float32 sums in another order: 1e-6 of |V_j||w|, and of sum_j |c_j||V_j|
    tol_c = 1e-6 * torch.linalg.vector_norm(Vk, dim=1) * torch.linalg.vector_norm(w)
    assert bool(((got_c - want_c)[:k].abs() <= tol_c).all())
    tol_y = 1e-6 * (c[:k].abs()[:, None] * Vk.abs()).sum(0).reshape(R, 128)
    assert bool(((got_y - want_y).abs() <= tol_y).all())
    if k == 0:
        assert not got_y.any()
    # fixed-order reductions: the same launch gives the same bits
    assert torch.equal(got_c, pb.project_pallas(V, w, kk))
    assert torch.equal(got_y, pb.unproject_pallas(V, c, kk))


def test_projection_wrappers_raise_instead_of_falling_back():
    V = torch.zeros((8, 16, 128), device="cuda")
    w = torch.zeros((16, 128), device="cuda")
    c = torch.zeros(8, device="cuda")
    with pytest.raises(ValueError, match="float32"):
        pb.project_pallas(V.double(), w.double(), 3)
    with pytest.raises(ValueError, match="basis"):
        pb.project_pallas(V[:, :12], w[:12], 3)
    with pytest.raises(ValueError, match="contiguous"):
        pb.project_pallas(V.transpose(0, 1).contiguous().transpose(0, 1), w, 3)
    with pytest.raises(ValueError, match="k <= kmax"):
        pb.unproject_pallas(V, c, 9)
    with pytest.raises(ValueError, match="int32"):
        pb.project_pallas(V, w, torch.tensor([3], dtype=torch.int32))  # k on the CPU
    with pytest.raises(ValueError, match="real"):
        pb.unproject_pallas(V, c.to(torch.complex64), 3)
    wide = torch.zeros((pb.MAX_KMAX + 1, 8, 128), device="cuda")
    with pytest.raises(ValueError, match="kmax"):
        pb.project_pallas(wide, torch.zeros((8, 128), device="cuda"), 3)


def test_banded_schursolve_with_projection_kernels_matches_cpu():
    # the unfused Arnoldi loop through K3, K5, K6 and K2, against the same
    # solve on the CPU (plain versions)
    n = 4096
    i = np.arange(n)
    rows = np.concatenate([i[1:], i, i[:-1]])
    cols = np.concatenate([i[1:] - 1, i, i[:-1] + 1])
    vals = np.concatenate([np.full(n - 1, -1.3), np.full(n, 2.0), np.full(n - 1, -0.7)]
                          ).astype(np.float32)
    x0 = torch.from_numpy(np.random.default_rng(1).standard_normal((n // 128, 128))
                          .astype(np.float32))
    kw = dict(krylovdim=18, maxiter=5, tol=1e-5, verbosity=kt.SILENT)
    old = bs.use_pallas_projections
    bs.use_pallas_projections = True
    try:
        _build.reset_launches()
        _, _, (rc, ic_), info_c = kt.schursolve(kt.banded_from_coo(rows, cols, vals, n), x0.cuda(),
                                                4, "LM", **kw)
        counted = dict(_build.launches)
        _, _, (rh, ih_), info_h = kt.schursolve(kt.banded_from_coo(rows, cols, vals, n, device="cpu"),
                                                x0, 4, "LM", **kw)
    finally:
        bs.use_pallas_projections = old
    assert counted["banded_spmv"] == info_c.numops
    assert counted["project"] == counted["unproject"] == 2 * info_c.numops
    assert counted["transform_partial"] == info_c.numiter and "fused_step" not in counted
    assert (info_c.numops, info_c.numiter) == (info_h.numops, info_h.numiter)
    torch.testing.assert_close(torch.hypot(rc, ic_).cpu(), torch.hypot(rh, ih_), rtol=2e-4, atol=0)


def _launches():
    return dict(_build.launches)


def _delta(before):
    return {k: v - before.get(k, 0) for k, v in _build.launches.items() if v != before.get(k, 0)}


@pytest.mark.parametrize("kind", ["chain", "grid"])
def test_fused_svdsolve_on_card_matches_cpu(kind):
    """Fused GKL: K1 steps both bases (normal spec over V, adjoint over U), K2
    rotates both at every processing round; values and counts as on the CPU."""
    if kind == "chain":
        op, shape = StencilOperator((-2, 0, 1), (0.4, 1.0, -0.8)), (32, 128)
    else:
        op, shape = GridStencilOperator((32, 128), POISSON_OFF, ADVECTION_CF), (32, 128)
    x = np.random.default_rng(51).standard_normal(shape).astype(np.float32)
    kw = dict(krylovdim=18, maxiter=5, tol=1e-6)
    vc, _, _, ic = kt.svdsolve(op, torch.from_numpy(x), 4, "LR", **kw)
    before = _launches()
    vg, lg, rg, ig = kt.svdsolve(op, torch.from_numpy(x).cuda(), 4, "LR", **kw)
    torch.cuda.synchronize()
    got = _delta(before)
    assert (ig.numops, ig.numiter, ig.converged) == (ic.numops, ic.numiter, ic.converged)
    torch.testing.assert_close(vg.cpu(), vc, rtol=5e-5, atol=0)
    # one launch per half-step but the two of each tail
    assert got == {"fused_step": ig.numops - 2 * ig.numiter, "transform_partial": 2 * ig.numiter}
    for i in range(ig.converged):
        r = op.normal(rg[i]) - vg[i] * lg[i]
        assert float(torch.linalg.norm(r)) < 5e-3 * float(vg[0])


def test_unfused_svdsolve_and_lssolve_on_card_match_cpu():
    rng = np.random.default_rng(13)
    A = rng.standard_normal((200, 100)) / 200 ** 0.5
    x0, b = rng.standard_normal(200), rng.standard_normal(200)
    kw = dict(krylovdim=25, tol=1e-10, maxiter=100)
    vc, _, _, ic = kt.svdsolve(torch.from_numpy(A), torch.from_numpy(x0), 4, "LR", **kw)
    vg, lg, rg, ig = kt.svdsolve(torch.from_numpy(A).cuda(), torch.from_numpy(x0).cuda(), 4, "LR", **kw)
    assert (ig.numops, ig.numiter, ig.converged) == (ic.numops, ic.numiter, ic.converged)
    torch.testing.assert_close(vg.cpu(), vc, rtol=1e-10, atol=1e-12)
    assert lg.device.type == rg.device.type == "cuda"
    xc, jc = kt.lssolve(torch.from_numpy(A), torch.from_numpy(b), tol=1e-10, maxiter=400)
    xg, jg = kt.lssolve(torch.from_numpy(A).cuda(), torch.from_numpy(b).cuda(), tol=1e-10, maxiter=400)
    assert jg.converged == jc.converged == 1 and abs(jg.numiter - jc.numiter) <= 1
    torch.testing.assert_close(xg.cpu(), xc, rtol=0, atol=1e-8)


@pytest.mark.parametrize("orth", ["cgs", "cgs2", "mgs2"])
def test_exponentiate_on_card_matches_cpu(orth):
    """cgs and cgs2 run the fused expansion (K1, Lanczos mode, ``min_one``),
    mgs2 the unfused loop: no launch."""
    op = StencilOperator((-1, 0, 1), (1.0, -2.0, 1.0))
    x = np.random.default_rng(7).standard_normal((32, 128)).astype(np.float32)
    kw = dict(krylovdim=30, tol=1e-4, ishermitian=True, orth=getattr(kt, orth))
    yc, ic = kt.exponentiate(op, 0.1, torch.from_numpy(x), **kw)
    before = _launches()
    yg, ig = kt.exponentiate(op, 0.1, torch.from_numpy(x).cuda(), **kw)
    torch.cuda.synchronize()
    got = _delta(before)
    assert (ig.numops, ig.numiter, ig.converged) == (ic.numops, ic.numiter, ic.converged)
    torch.testing.assert_close(yg.cpu(), yc, rtol=1e-4, atol=1e-5)
    assert ("fused_step" in got) == (orth != "mgs2")


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128], ids=["c64", "c128"])
def test_complex_banded_operator_on_card_matches_cpu(dtype):
    """Complex planes are outside the TPU kernel: ``BandedOperator`` applies
    them with the plain version on the card too (no K3 launch), as the JAX
    package sends them to XLA."""
    rng = np.random.default_rng(9)
    n, offsets = 1000, (-130, -1, 0, 3)
    rows = np.concatenate([np.arange(max(0, -d), min(n, n - d)) for d in offsets])
    cols = np.concatenate([np.arange(max(0, -d), min(n, n - d)) + d for d in offsets])
    vals = (rng.standard_normal(rows.size) + 1j * rng.standard_normal(rows.size))
    vals = torch.from_numpy(vals).to(dtype).numpy()
    x = torch.from_numpy(rng.standard_normal(n) + 1j * rng.standard_normal(n)).to(dtype)
    card, host = (kt.banded_from_coo(rows, cols, vals, n, device=d) for d in ("cuda", "cpu"))
    tol = 1e-6 if dtype == torch.complex64 else 1e-13
    before = _launches()
    for fc, fh in ((card.normal, host.normal), (card.apply_adjoint, host.apply_adjoint)):
        yc = fc(x.cuda())
        assert yc.dtype == dtype and yc.device.type == "cuda"
        torch.testing.assert_close(yc.cpu(), fh(x), rtol=tol, atol=tol * float(x.abs().max()))
    torch.cuda.synchronize()
    assert _delta(before) == {}


def _q1_ops(ny, nx, dtype, device):
    return tuple(kt.banded_from_coo(*coo, ny * nx, device=device) for coo in q1_coo(np, ny, nx, dtype))


@pytest.mark.parametrize("dtype,flag,maxiter", [(np.float64, False, 300), (np.float32, False, 2),
                                                (np.float32, True, 2)],
                         ids=["f64-converged", "f32-sweeps", "f32-projection_kernels"])
def test_geneigsolve_banded_pencil_on_card_matches_cpu(dtype, flag, maxiter):
    """The Q1 pencil on a 16×64 grid (no repeated eigenvalue): K3 twice per
    counted apply; with the flag on a float32 basis, K5 and K6 once per cgs2
    sweep, 2·(numops + numiter − 1)."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((8, 128)).astype(dtype))
    kw = dict(krylovdim=30, maxiter=maxiter, tol=1e-8 if maxiter > 2 else 1e-30)
    try:
        bs.use_pallas_projections = flag
        vh, _, ih = kt.geneigsolve(_q1_ops(16, 64, dtype, "cpu"), x, 4, "SR", **kw)
        ops = _q1_ops(16, 64, dtype, "cuda")
        before = _launches()
        vc, ec, ic = kt.geneigsolve(ops, x.cuda(), 4, "SR", **kw)
        torch.cuda.synchronize()
        got = _delta(before)
    finally:
        bs.use_pallas_projections = False
    assert (ic.numops, ic.numiter, ic.converged) == (ih.numops, ih.numiter, ih.converged)
    rtol = 1e-10 if dtype == np.float64 else 1e-3
    torch.testing.assert_close(vc.cpu(), vh, rtol=rtol, atol=0)
    sweeps = 2 * (ic.numops + ic.numiter - 1)
    want = {"banded_spmv": 2 * ic.numops}
    if flag:
        want.update(project=sweeps, unproject=sweeps)
    assert got == want
    assert ec.shape == (4, 8, 128) and ec.device.type == "cuda"


def test_block_lanczos_banded_on_card_matches_cpu():
    """The banded 2-D Poisson on a 16×16 grid, a block of 4, ``"LR"``: K3
    once per apply (one per row of each block step)."""
    coo = poisson_coo(np, 16, np.float64)
    rng = np.random.default_rng(5)
    xs = [torch.from_numpy(rng.standard_normal((2, 128))) for _ in range(4)]
    kw = dict(krylovdim=30, tol=1e-8, maxiter=300)
    vh, _, ih = kt.eigsolve(kt.banded_from_coo(*coo, 256, device="cpu"), kt.Block(xs), 4, "LR", **kw)
    op = kt.banded_from_coo(*coo, 256)
    before = _launches()
    vc, ec, ic = kt.eigsolve(op, kt.Block([x.cuda() for x in xs]), 4, "LR", **kw)
    torch.cuda.synchronize()
    assert _delta(before) == {"banded_spmv": ic.numops}
    assert (ic.numops, ic.numiter, ic.converged) == (ih.numops, ih.numiter, ih.converged) and ic.converged == 4
    torch.testing.assert_close(vc.cpu(), vh, rtol=1e-10, atol=0)


def test_ell_apply_on_card_matches_cpu():
    """The ELL operator of the Q1 stiffness on a 64×64 grid (plain gather and
    sum on every device) and its conversion to banded planes."""
    coo, _ = q1_coo(np, 64, 64, np.float32)
    card = kt.sparse.from_coo(*coo, (4096, 4096))
    host = kt.sparse.from_coo(*coo, (4096, 4096), device="cpu")
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(4096).astype(np.float32))
    scale = kt.sparse.ELLOperator(host.cols, host.vals.abs(), 4096).normal(x.abs())
    for yc, yh in ((card.normal(x.cuda()), host.normal(x)),
                   (card.apply_adjoint(x.cuda()), host.apply_adjoint(x))):
        assert bool(((yc.cpu() - yh).abs() <= 1e-6 * scale).all())
    banded = kt.ell_to_banded(card)
    ref = kt.banded_from_coo(*coo, 4096)
    assert banded.offsets == ref.offsets and torch.equal(banded.diags, ref.diags)


def _guarded_calls():
    """Each kernel wrapper on card tensors: ``(name, fn, x)``, ``x`` the
    argument the autograd guard must look at."""
    g = _gen(40)
    V = torch.randn((9, 16, 128), generator=g, device="cuda")
    U = torch.eye(9, device="cuda")
    D = torch.randn((3, 16, 128), generator=g, device="cuda")
    spec = fl.spec_for(kt.laplacian_1d(2048))
    x = torch.randn((16, 128), generator=g, device="cuda")
    return [
        ("banded_spmv", lambda x: bd.banded_spmv(x, D, (-1, 0, 1), 2048), x),
        ("laplacian_1d", s1.laplacian_1d_flat, x),
        ("transform_partial", lambda v: bs.transform_partial_inplace(v, U, 4), V.clone()),
        ("project", lambda x: pb.project_pallas(V, x, 4), x),
        ("unproject", lambda c: pb.unproject_pallas(V, c, 4),
         torch.randn(9, generator=g, device="cuda")),
        ("fused_step", lambda y: fl.fused_step(V.clone(), y, torch.ones(10, device="cuda"), 4, 4,
                                               spec, with_drift=True), x),
    ]


@pytest.mark.parametrize("case", range(6))
def test_kernel_wrappers_refuse_autograd_inputs_on_card(case):
    """A launch through ``data_ptr()`` records no graph: each wrapper raises
    for a tensor that requires grad or that torch.func has wrapped, and
    launches nothing."""
    name, fn, x = _guarded_calls()[case]
    fn(x)
    _build.reset_launches()
    with pytest.raises(RuntimeError, match=f"{name}: the kernel is not differentiable"):
        fn(x.clone().requires_grad_(True))
    with pytest.raises(RuntimeError, match=f"{name}: the kernel is not differentiable"):
        torch.func.vjp(fn, x.clone())
    assert not any(_build.launches.values())


def test_ad_routes_on_card_match_cpu():
    """The ``small_ad`` routes of ``chip_smoke.py``: every AD route's
    gradients on the card within 1e-8 (relative) of the CPU's, counts
    equal."""
    from chip_smoke import small_ad

    small_ad(torch, np, kt, _build)


def test_ad_impurity_small_grid_on_card():
    """``ad_impurity`` on a 64 × 64 grid: Hellmann–Feynman, the central
    difference, the launch counts and the gates of the tuple solves."""
    from chip_smoke import ad_impurity

    out = ad_impurity(torch, np, kt, _build, bs, bd, N=64)
    assert out["tuple_basis"] == {"transform_partial": 1}


def test_banded_planes_gradient_on_card_matches_cpu():
    """A gradient with respect to a BandedOperator's planes: the solve
    launches K3 once per apply, the cotangent goes through the plain
    version; the card's gradient equals the CPU's."""
    rng = np.random.default_rng(9)
    n = 1024
    A = np.diag(np.full(n, 4.0)) + np.diag(rng.standard_normal(n - 1), 1) + np.diag(
        rng.standard_normal(n - 1), -1)
    b = rng.standard_normal(n)
    grads = {}
    for dev in ("cuda", "cpu"):
        band = kt.banded_from_dense(A, device=dev)
        D = band.diags.clone().requires_grad_(True)
        _build.reset_launches()
        x, info = kt.linsolve(band.with_tensors([D, band.adj.diags]), torch.as_tensor(b, device=dev),
                              alg=kt.GMRES(tol=1e-12, krylovdim=40))
        x.sum().backward()
        if dev == "cuda":
            assert _build.launches["banded_spmv"] >= info.numops
        grads[dev] = D.grad.cpu()
    torch.testing.assert_close(grads["cuda"], grads["cpu"], rtol=1e-10, atol=1e-12)


def test_bieigsolve_iterators_and_selective_on_card_match_cpu():
    """The ``small_bieig_iter`` phase of ``chip_smoke.py``: ``bieigsolve``
    (dense and banded, real and complex mode), every iterator and
    ``Lanczos(reorth="selective")`` on the card within 1e-10 of the CPU,
    counts and sweeps equal; K3 once per banded real apply, half of
    ``bieigsolve``'s on the adjoint's planes."""
    from chip_smoke import small_bieig_iter

    small_bieig_iter(torch, np, kt, _build)


def test_bieig_and_lanczos_variants_small_width_on_card():
    """The ``bieig`` and ``lanczos_variants`` phases at n = 2^14 and on a
    64 × 64 grid: exact launch counts (K3 both ways, the predicted K5/K6
    with the flag; K2 per round and extraction), the sweep counts, the
    iterators' invariants."""
    from chip_smoke import bieig_full, lanczos_variants

    out = bieig_full(torch, np, kt, _build, bd, bs, fl, pb, n=1 << 14)
    assert set(out["bieig"]) == {"banded_spmv"}
    got = lanczos_variants(torch, np, kt, _build, bd, bs, fl, pb, N=64)
    assert set(got["iterators"]) == {"banded_spmv"}


# K1 with external halos (a rank's block of a vector split over ranks): the
# chain and grid specs, B in {0, 1, 12, 30}, with and without drift
EXT_CASES = [(kind, B, drift) for kind in ("chain", "chain_multirow", "grid")
             for B in (0, 1, 12, 30) for drift in (False, True)]


@pytest.mark.parametrize("kind,B,with_drift", EXT_CASES)
def test_fused_step_with_external_halos_matches_plain(kind, B, with_drift):
    spec, R = _fused_case(kind, None)
    kmax, kp1 = 31, max(B, 1)
    gen = _gen(100 + B)
    V = torch.randn((kmax, R, 128), generator=gen, device="cuda")
    y = torch.randn((R, 128), generator=gen, device="cuda")
    g = torch.randn(kmax + 1, generator=gen, device="cuda")
    halos = {"Vext": torch.randn((kmax, 2, spec.h, 128), generator=gen, device="cuda"),
             "yext": torch.randn((2, spec.h, 128), generator=gen, device="cuda")}
    Vk, Vr = V.clone(), V.clone()
    before = _build.launches["fused_step"]
    yk, rk = fl.fused_step(Vk, y, g, kp1, B, spec, with_drift, **halos)
    assert _build.launches["fused_step"] == before + 1
    yr, rr = fl.fused_step_reference(Vr, y, g, kp1, B, spec, with_drift, **halos)
    torch.cuda.synchronize()
    assert torch.equal(Vk[:kp1], V[:kp1]) and torch.equal(Vk[kp1 + 1:], V[kp1 + 1:])
    sc = float(yr.abs().max())
    assert float((Vk[kp1] - Vr[kp1]).abs().max()) <= 2e-4 * sc
    assert float((yk - yr).abs().max()) <= 2e-4 * sc
    torch.testing.assert_close(rk, rr, rtol=2e-4, atol=2e-3 * R ** 0.5)
    # the halos change the result (the rows beyond the block are read)
    Vn = V.clone()
    yn, _ = fl.fused_step(Vn, y, g, kp1, B, spec, with_drift)
    assert not torch.equal(yn, yk)
    Vk2 = V.clone()
    yk2, rk2 = fl.fused_step(Vk2, y, g, kp1, B, spec, with_drift, **halos)
    assert torch.equal(yk, yk2) and torch.equal(rk, rk2) and torch.equal(Vk, Vk2)


@pytest.mark.parametrize("kind", ["chain", "grid"])
def test_fused_step_null_halos_are_the_dirichlet_launch(kind):
    """Without halos (null pointers) the kernel takes zeros beyond the block,
    as before the halos existed: bit-equal to a launch with zero halos, and
    to the plain version within the usual tolerance."""
    spec, R = _fused_case(kind, None)
    gen = _gen(7)
    V = torch.randn((31, R, 128), generator=gen, device="cuda")
    y = torch.randn((R, 128), generator=gen, device="cuda")
    g = torch.randn(32, generator=gen, device="cuda")
    zero = {"Vext": torch.zeros((31, 2, spec.h, 128), device="cuda"),
            "yext": torch.zeros((2, spec.h, 128), device="cuda")}
    V1, V2 = V.clone(), V.clone()
    a = fl.fused_step(V1, y, g, 13, 12, spec, True)
    b = fl.fused_step(V2, y, g, 13, 12, spec, True, **zero)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and torch.equal(V1, V2)


def test_small_sharded_scenarios_on_card_match_cpu():
    """The ``small_sharded`` phase of ``chip_smoke.py``: the sharded
    scenarios on two gloo ranks with CUDA tensors against two CPU ranks."""
    from chip_smoke import small_sharded

    launches = small_sharded(torch, np, world=2)
    assert launches.get("fused_step", 0) > 0 and launches.get("project", 0) > 0


def test_small_front_ends_on_card_match_cpu():
    """The ``small_front_ends`` phase of ``chip_smoke.py``: the remaining
    front-ends on a sharded space, two gloo ranks with CUDA tensors against
    two CPU ranks (float64 within 1e-12, counts equal, every rank the same
    bits); the fused ``exponentiate`` launches K1 on every card rank."""
    from chip_smoke import small_front_ends

    launches = small_front_ends(torch, np, world=2)
    assert launches.get("fused_step", 0) > 0


def test_sharded_front_ends_small_width_on_card():
    """Phase ``sharded_front_ends`` with config 5's operator at n = 2^14
    (config 4's at its width, 2^20: the unconverged two-sided Ritz values of
    its dense spectrum are held to 1e-4 there): every solve on two card
    ranks against the one-rank solve (counts, values 1e-4, launches per
    rank equal to the one-rank solve's)."""
    from chip_smoke import sharded_front_ends

    launches = sharded_front_ends(torch, np, kt, _build, "card test", n=1 << 14, halfband=25)
    assert launches["exponentiate_fused"].get("fused_step", 0) > 0


@pytest.mark.parametrize("name", ["svdsolve", "lssolve", "geneigsolve", "expintegrator",
                                  "block_lanczos"])
def test_small_pytree_drivers_on_card_match_cpu(name):
    """The small float64 pytree solves of phase ``pytree_drivers``: card
    within 1e-12 of the CPU, counts equal."""
    from chip_smoke import card_vs_cpu, small_pytree_cases

    card_vs_cpu(torch, _build, f"pytree {name}",
                lambda d: small_pytree_cases(torch, np, kt, d)[name](), 1e-12, "cuda")


def test_pytree_drivers_small_width_on_card():
    """Phase ``pytree_drivers`` at a small width: config 3's rectangular map
    at 2^14 × 2^13, config 4's exponentiate at 2^14, the Q1 pencil and the
    Poisson matrix on the 64 × 64 grid; K3 launched by the two banded
    trees as by their single-tensor solves."""
    from chip_smoke import pytree_drivers

    quiet = {"verbosity": kt.SILENT}
    cols, rows = 1 << 13, 1 << 14
    wr = torch.linspace(1.0, 3.0, cols, device="cuda").reshape(cols // 128, 128)

    def rect(x):
        wx = wr * x
        return torch.cat([wx, 0.5 * torch.roll(wx, 1, dims=0)], dim=0)

    def rect_adj(y):
        return wr * y[: cols // 128] + 0.5 * wr * torch.roll(y[cols // 128:], -1, dims=0)

    x0r = torch.randn((rows // 128, 128), generator=_gen(7), device="cuda")
    S, _, _, info = kt.svdsolve((rect, rect_adj), x0r, 8, "LR", krylovdim=30, maxiter=12,
                                tol=1e-30, **quiet)
    chain = StencilOperator((-1, 0, 1), (1.0, -2.0, 1.0))
    x04 = torch.randn((128, 128), generator=_gen(8), device="cuda")
    ye, ie = kt.exponentiate(chain, 0.1, x04, krylovdim=30, tol=1e-4, ishermitian=True, **quiet)
    out = pytree_drivers(torch, np, kt, _build, {
        "rect": (rect, rect_adj, x0r), "svdsolve": (S.cpu(), info),
        "exponentiate": (chain, x04, (ye, ie))}, "card test", N=64)
    assert out["pytree_geneigsolve_q1"].get("banded_spmv", 0) > 0
    assert out["pytree_block_lanczos_poisson"].get("banded_spmv", 0) > 0


def test_sharded_gradients_on_card_match_cpu():
    """Gradients of sharded solves (``chip_smoke.sharded_ad_cases``: the
    linsolve on the sharded 1-D Laplacian for ``b``, ``a0``, ``a1``, a
    ``ParametricOperator`` around the sharded ELL operator, the Sylvester
    eigsolve rule and the derived adjoints across the ranks) on two gloo
    ranks with CUDA tensors against two CPU ranks: within 1e-8, counts
    equal; a map that calls ``torch.distributed`` itself raises on the
    card's ranks as on the CPU's when its adjoint is derived."""
    from chip_smoke import small_sharded_ad

    records = small_sharded_ad(torch, np, world=2)
    assert {r["scenario"] for r in records} >= {"linsolve", "ell_linsolve"}


def test_sharded_ad_small_width_on_card():
    """Phase ``sharded_ad`` on the 256² grid: the eigenvalue gradients by
    both rules and the fused linsolve's gradients on two card ranks against
    one rank (Hellmann–Feynman and the joined gradients within 1e-3, the
    linsolve's within 1e-4, counts equal), K1 per rank in the linsolve's
    forward and K5/K6 in the flag-on forward as one rank launches them,
    none on the backward's tuple solves; their batched twins with the
    batched K1 and K5/K6 launches."""
    from chip_smoke import sharded_ad

    launches = sharded_ad(torch, np, kt, _build, "card test", N=256)
    assert launches["linsolve"]["forward"].get("fused_step", 0) > 0
    assert launches["eig_sylvester_proj"]["forward"].get("project", 0) > 0
    assert launches["linsolve_batched"]["forward"].get("fused_step_batched", 0) > 0
    assert launches["eig_sylvester_proj_batched"]["forward"].get("project_batched", 0) > 0


# batched K1: (kind, B, with_drift) at equal B = kp1 for every problem
BATCHED_K1_CASES = [(kind, B, drift) for kind in ("chain", "grid") for B in (1, 16, 30)
                    for drift in (False, True)]


def _batched_inputs(kind, P, kmax, seed):
    op, R = _fused_op(kind, None)
    gen = _gen(seed)
    V = torch.randn((P, kmax, R, 128), generator=gen, device="cuda")
    y = torch.randn((P, R, 128), generator=gen, device="cuda")
    g = torch.randn((P, kmax + 1), generator=gen, device="cuda")
    return fl.spec_for(op), V, y, g


@pytest.mark.parametrize("kind,B,with_drift", BATCHED_K1_CASES)
def test_batched_fused_step_is_one_problem_launches_bit_for_bit(kind, B, with_drift):
    """Batched K1 with every active problem at the same ``B = kp1``: each
    problem's new row, ``y'`` and ``raw`` bit-identical to a one-problem
    launch, within the one-problem tolerance of the plain version; the
    inactive problem's rows untouched; one count of
    ``fused_step_batched``."""
    P, kmax = 4, 31
    spec, V, y, g = _batched_inputs(kind, P, kmax, 100 + B)
    active = [0, 2, 3]
    Vb = V.clone()
    before = _build.launches["fused_step_batched"]
    yb, rb = fl.fused_step_batched(Vb, y, g, B, B, spec, with_drift, active)
    assert _build.launches["fused_step_batched"] == before + 1
    Vr = V.clone()
    yr, rr = fl.fused_step_batched_reference(Vr, y, g, B, B, spec, with_drift, active)
    torch.cuda.synchronize()
    assert torch.equal(Vb[1], V[1])
    for p in active:
        V1 = V[p].clone()
        y1, r1 = fl.fused_step(V1, y[p], g[p], B, B, spec, with_drift)
        assert torch.equal(Vb[p], V1) and torch.equal(yb[p], y1) and torch.equal(rb[p], r1)
        sc = float(yr[p].abs().max())
        assert float((Vb[p, B] - Vr[p, B]).abs().max()) <= 2e-4 * sc
        assert float((yb[p] - yr[p]).abs().max()) <= 2e-4 * sc
        torch.testing.assert_close(rb[p], rr[p], rtol=2e-4, atol=2e-3 * V.shape[2] ** 0.5)


@pytest.mark.parametrize("kind", ["chain", "grid"])
def test_batched_fused_step_with_mixed_live_rows_matches_plain(kind):
    """Batched K1 with a ``B``/``kp1`` per problem (the plan and ``KACC`` of
    the largest ``B``): each problem within the one-problem tolerance of the
    plain version, its other rows bit-identical, its ``raw`` zero beyond its
    own length; the inactive problem untouched."""
    P, kmax = 5, 31
    spec, V, y, g = _batched_inputs(kind, P, kmax, 7)
    B, kp1, active = [30, 4, 0, 19, 12], [30, 6, 0, 19, 12], [0, 1, 2, 3]
    Vb = V.clone()
    yb, rb = fl.fused_step_batched(Vb, y, g, kp1, B, spec, True, active)
    Vr = V.clone()
    yr, rr = fl.fused_step_batched_reference(Vr, y, g, kp1, B, spec, True, active)
    torch.cuda.synchronize()
    assert torch.equal(Vb[4], V[4])
    for p in active:
        k = kp1[p]
        assert torch.equal(Vb[p, :k], V[p, :k]) and torch.equal(Vb[p, k + 1:], V[p, k + 1:])
        sc = float(yr[p].abs().max())
        assert float((Vb[p, k] - Vr[p, k]).abs().max()) <= 2e-4 * sc
        assert float((yb[p] - yr[p]).abs().max()) <= 2e-4 * sc
        n = 2 * B[p] + 2
        torch.testing.assert_close(rb[p, :n], rr[p, :n], rtol=2e-4, atol=2e-3 * V.shape[2] ** 0.5)
        assert not rb[p, n:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_batched_transform_is_one_problem_launches_bit_for_bit(dtype):
    """Batched K2 at ``(P, 31, 2^14, 128)``: each problem bit-identical to a
    one-problem launch with its ``U``, rows ``>= m_out`` untouched, an
    identity ``U`` leaves its basis bit-identical, the inactive problem
    untouched; one count of ``transform_partial_batched``."""
    P, kmax, R, m_out = 4, 31, 1 << 14 >> 7, 20
    gen = _gen(11)
    V = torch.randn((P, kmax, R, 128), generator=gen, device="cuda").to(dtype)
    U = torch.randn((P, kmax, kmax), generator=gen, device="cuda") / kmax ** 0.5
    U[1] = torch.eye(kmax, device="cuda")
    before = _build.launches["transform_partial_batched"]
    Vb = bs.transform_partial_inplace_batched(V.clone(), U, m_out, active=[0, 1, 2])
    assert _build.launches["transform_partial_batched"] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(Vb[1], V[1]) and torch.equal(Vb[3], V[3])
    for p in (0, 2):
        V1 = bs.transform_partial_inplace(V[p].clone(), U[p], m_out)
        assert torch.equal(Vb[p], V1) and torch.equal(Vb[p, m_out:], V[p, m_out:])


def test_batched_lanczos_and_gmres_on_card_match_one_problem_solves():
    """A small batched Lanczos eigsolve (``laplacian_1d(2^14)``, three
    starts) and a batched fused GMRES (``poisson_2d(128, 128)``, three
    right-hand sides) on the card: counts equal to the one-problem solves on
    the card, values within 1e-5 relative (``x`` of its largest entry);
    batched K1/K2 only."""
    from krylovkit_tpu_torch.solvers.gmres import linsolve_gmres

    n = 1 << 14
    X = torch.stack([torch.from_numpy(np.random.default_rng(20 + i).standard_normal(
        (n // 128, 128)).astype(np.float32)) for i in range(3)]).cuda()
    op = kt.laplacian_1d(n)
    alg = kt.Lanczos(krylovdim=20, tol=1e-3, maxiter=30)
    _build.reset_launches()
    vals, _, info = kt.eigsolve_lanczos_batched(op, X, 1, "LM", alg)
    torch.cuda.synchronize()
    assert not {"fused_step", "transform_partial"} & {k for k, v in _build.launches.items() if v}
    assert _build.launches["fused_step_batched"] > 0
    assert _build.launches["transform_partial_batched"] > 0
    for p in range(3):
        v1, _, i1 = kt.eigsolve_lanczos(op, X[p], 1, "LM", alg)
        assert [i1.numops, i1.numiter] == [int(info.numops[p]), int(info.numiter[p])]
        torch.testing.assert_close(vals[p], v1, rtol=1e-5, atol=0)
    gop = kt.poisson_2d(128, 128)
    Bs = torch.stack([torch.from_numpy((np.random.default_rng(30 + i).standard_normal(
        (128, 128)) / 128 * (1 + i)).astype(np.float32)) for i in range(3)]).cuda()
    galg = kt.GMRES(krylovdim=16, tol=1e-4, maxiter=10)
    x, ginfo = kt.linsolve_gmres_batched(gop, Bs, torch.zeros_like(Bs), 0.5, 1.0, galg)
    for p in range(3):
        x1, i1 = linsolve_gmres(gop, Bs[p], torch.zeros_like(Bs[p]), 0.5, 1.0, galg)
        assert [i1.numops, i1.numiter] == [int(ginfo.numops[p]), int(ginfo.numiter[p])]
        assert float((x[p] - x1).abs().max()) <= 1e-5 * float(x1.abs().max())


# (rows, n, offsets, dtype): config 2's five offsets and config 4's three at
# P = 8, one row, a ragged n, rows that end inside the kernel's chunk of 4
# shared-plane rows, and more than the 64 rows one launch takes
BATCHED_K3_CASES = [
    (8, 1 << 20, (-1024, -1, 0, 1, 1024), torch.float32),
    (8, 1 << 20, (-1024, -1, 0, 1, 1024), torch.float64),
    (8, 1 << 20, (-1, 0, 1), torch.float32),
    (1, 4096, (-1024, -1, 0, 1, 1024), torch.float32),
    (3, 301, (-2, 0, 5), torch.float64),
    (11, 1000, (-999, -1, 0, 999), torch.float32),
    (70, 2048, (-130, -127, -1, 0, 1, 3, 127, 129, 256), torch.float32),
]


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_problem"])
@pytest.mark.parametrize("rows,n,offsets,dtype", BATCHED_K3_CASES)
def test_batched_banded_spmv_is_one_problem_launches_bit_for_bit(rows, n, offsets, dtype, shared):
    """Batched K3 with shared planes and with a plane set per row (named
    with repeats): each row bit-identical to a one-problem launch on it,
    within the one-problem tolerance of the plain version, one launch per 64
    rows."""
    gen = _gen(rows + n)
    R = -(-n // 128)
    sets = 1 if shared else 5
    D = torch.randn((sets, len(offsets), R, 128), generator=gen, device="cuda", dtype=dtype)
    planes = None if shared else [(3 * r + 1) % sets for r in range(rows)]
    X = torch.randn((rows, n), generator=gen, device="cuda", dtype=dtype)
    Dk = D[0] if shared else D
    before = _build.launches["banded_spmv_batched"]
    Y = bd.banded_spmv_batched(X, Dk, offsets, n, planes)
    assert _build.launches["banded_spmv_batched"] == before + -(-rows // 64)
    Yr = bd.banded_spmv_batched_reference(X, Dk, offsets, n, planes)
    torch.cuda.synchronize()
    for r in range(rows):
        Dr = D[0] if shared else D[planes[r]]
        assert torch.equal(Y[r], bd.banded_spmv(X[r], Dr, offsets, n))
    scale = bd.banded_spmv_batched_reference(X.abs(), Dk.abs(), offsets, n, planes)
    tol = 1e-6 if dtype == torch.float32 else 1e-15
    assert float(((Y - Yr).abs() - tol * scale).max()) <= 0


def test_batched_banded_spmv_takes_a_subset_and_any_row_stride():
    """Rows gathered for a subset of problems (their plane sets named), and
    rows of a strided view, give the one-problem launches' bits."""
    gen = _gen(5)
    n, offsets = 1 << 16, (-256, -1, 0, 1, 256)
    D = torch.randn((6, len(offsets), n // 128, 128), generator=gen, device="cuda")
    X = torch.randn((6, n + 8), generator=gen, device="cuda")[:, 3:n + 3]
    sub = [4, 1, 5]
    Y = bd.banded_spmv_batched(X[sub], D, offsets, n, sub)
    Ys = bd.banded_spmv_batched(X, D[2], offsets, n)
    torch.cuda.synchronize()
    for i, p in enumerate(sub):
        assert torch.equal(Y[i], bd.banded_spmv(X[p].contiguous(), D[p], offsets, n))
    for p in range(6):
        assert torch.equal(Ys[p], bd.banded_spmv(X[p].contiguous(), D[2], offsets, n))


@pytest.mark.parametrize("rows,n,dtype", [(8, 1 << 21, torch.float32), (8, 1 << 21, torch.float64),
                                          (1, 4096, torch.float32), (9, 1001, torch.float32),
                                          (3, 999, torch.float64)])
def test_batched_laplacian_is_one_problem_launches_bit_for_bit(rows, n, dtype):
    """Batched K4: one launch for every row, each row bit-identical to a
    one-problem launch and to the plain version (the same operations in the
    same order); a ragged n pads the rows."""
    X = torch.randn((rows, n), generator=_gen(n + rows), device="cuda", dtype=dtype)
    before = _build.launches["laplacian_1d_batched"]
    Y = s1.laplacian_1d_flat_batched(X)
    assert _build.launches["laplacian_1d_batched"] == before + 1
    torch.cuda.synchronize()
    assert Y.shape == (rows, n) and torch.equal(Y, s1.laplacian_1d_flat_batched_reference(X))
    for r in range(rows):
        assert torch.equal(Y[r], s1.laplacian_1d_flat(X[r]))


def test_batched_wrappers_raise_instead_of_falling_back():
    """Complex or mixed types raise on the card; a batched solve on complex
    planes applies them problem by problem with the plain version, as the
    JAX package sends them to XLA, and launches no batched K3."""
    D = torch.ones((3, 2, 128), device="cuda")
    X = torch.ones((2, 256), device="cuda")
    with pytest.raises(ValueError, match="complex"):
        bd.banded_spmv_batched(X.to(torch.complex64), D.to(torch.complex64), (-1, 0, 1), 256)
    with pytest.raises(ValueError, match="float64"):
        bd.banded_spmv_batched(X, D.double(), (-1, 0, 1), 256)
    with pytest.raises(ValueError, match="float32 or float64"):
        s1.laplacian_1d_flat_batched(X.half())
    coo = poisson_coo(np, 32, np.complex128)
    op = kt.banded_from_coo(*coo, 1024)
    B = torch.ones((2, 1024), dtype=torch.complex128, device="cuda")
    _build.reset_launches()
    x, info = kt.linsolve_bicgstab_batched(op, B, torch.zeros_like(B), 0.5, 1.0,
                                           kt.BiCGStab(tol=1e-8, maxiter=200))
    assert not _build.launches["banded_spmv_batched"] and not _build.launches["banded_spmv"]
    assert info.converged.tolist() == [1, 1]


@pytest.mark.parametrize("driver", ["cg", "minres", "bicgstab"])
def test_batched_linear_solves_on_card_match_one_problem_solves(driver):
    """Batched CG, MINRES and BiCGStab on the card (float64: a shared banded
    Poisson operator, per-problem planes for CG, the 1-D Laplacian for
    BiCGStab): counts equal to the one-problem solves on the card, ``x``
    bit-identical; batched K3/K4 launches only."""
    from krylovkit_tpu_torch.solvers.bicgstab import linsolve_bicgstab
    from krylovkit_tpu_torch.solvers.cg import linsolve_cg
    from krylovkit_tpu_torch.solvers.minres import linsolve_minres

    nx, P = 64, 3
    n = nx * nx
    coo = poisson_coo(np, nx, np.float64)
    B = torch.stack([torch.from_numpy(np.random.default_rng(60 + p).standard_normal(n) * (1 + p))
                     for p in range(P)]).cuda()
    banded = kt.banded_from_coo(*coo, n)
    one, batched, alg = {
        "cg": (linsolve_cg, kt.linsolve_cg_batched, kt.CG(tol=1e-9, maxiter=400)),
        "minres": (linsolve_minres, kt.linsolve_minres_batched, kt.MINRES(tol=1e-9, maxiter=400)),
        "bicgstab": (linsolve_bicgstab, kt.linsolve_bicgstab_batched,
                     kt.BiCGStab(tol=1e-9, maxiter=400)),
    }[driver]
    cases = [(banded, None)]
    if driver == "cg":
        cases.append(([kt.BandedOperator(banded.offsets, banded.diags * (1 + 0.1 * p), n)
                       for p in range(P)], 0))
    if driver == "bicgstab":
        cases.append((kt.laplacian_1d_pallas(n, torch.float64), None))
    for op, op_dim in cases:
        _build.reset_launches()
        x, info = batched(op, B, torch.zeros_like(B), 0.5, 1.0, alg, in_dims=(op_dim, 0, 0))
        torch.cuda.synchronize()
        used = {k for k, v in _build.launches.items() if v}
        assert used in ({"banded_spmv_batched"}, {"laplacian_1d_batched"}), used
        for p in range(P):
            opp = op[p] if op_dim == 0 else op
            x1, i1 = one(opp, B[p], torch.zeros_like(B[p]), 0.5, 1.0, alg)
            assert [i1.numops, i1.numiter, i1.converged] == [
                int(info.numops[p]), int(info.numiter[p]), int(info.converged[p])]
            assert torch.equal(x[p], x1)


@pytest.mark.parametrize("ks, R, kmax", [
    ([18] * 8, 64, 31),                      # equal k
    ([30, 19, 25, 4, 16, 29, 1, 22], 64, 31),  # mixed k
    ([(7 * i) % 14 for i in range(70)], 16, 13),  # P > 64: two launches
    ([0] * 5, 16, 13),                       # every k = 0
])
def test_batched_projections_are_one_problem_launches_bit_for_bit(ks, R, kmax):
    """Batched K5 and K6: every row bit-identical to a one-problem launch,
    within 1e-5 of the plain version, rows ``>= k_p`` never read (NaN),
    ``k_p = 0`` zeros (``chip_smoke.check_batched_projections``); one
    launch per 64 problems."""
    from chip_smoke import check_batched_projections

    _build.reset_launches()
    case = check_batched_projections(torch, pb, ks, R, kmax, _gen(71), timed=False)
    assert case["bit_identical_to_one_problem_launches"]
    chunks = -(-len(ks) // pb.MAX_BATCH)
    assert _build.launches["project_batched"] == _build.launches["unproject_batched"] == chunks


def test_batched_arnoldi_with_projection_kernels_on_card_matches_cpu():
    """A small ``eigsolve_arnoldi_batched`` on config 4's banded matrix (n =
    4096, float32 ``(32, 128)`` starts, P = 3, krylovdim 18, maxiter 3) with
    the projection flag on: counts equal to the CPU run (plain versions),
    ``|λ|`` within 2e-4 relative; on the card only batched launches, K5 and
    K6 twice per batched K3."""
    from chip_smoke import batched_starts, tridiagonal_coo

    n, P = 4096, 3
    coo = tridiagonal_coo(np, n, -1.3, 2.0, -0.7, np.float32)
    alg = kt.Arnoldi(krylovdim=18, maxiter=3, tol=1e-30, verbosity=kt.SILENT)
    X = batched_starts(torch, np, n // 128, P, "cpu")
    old = bs.use_pallas_projections
    bs.use_pallas_projections = True
    try:
        _build.reset_launches()
        vc, _, ic = kt.eigsolve_arnoldi_batched(kt.banded_from_coo(*coo, n), X.cuda(), 4, "LM",
                                                alg)
        torch.cuda.synchronize()
        launches = {k: v for k, v in _build.launches.items() if v}
        vh, _, ih = kt.eigsolve_arnoldi_batched(kt.banded_from_coo(*coo, n, device="cpu"), X, 4,
                                                "LM", alg)
    finally:
        bs.use_pallas_projections = old
    assert ic.numops.tolist() == ih.numops.tolist() and ic.numiter.tolist() == ih.numiter.tolist()
    np.testing.assert_allclose(vc.abs().cpu().numpy(), vh.abs().numpy(), rtol=2e-4)
    assert set(launches) == {"banded_spmv_batched", "project_batched", "unproject_batched",
                             "transform_partial_batched"}, launches
    assert launches["project_batched"] == launches["unproject_batched"] == \
        2 * launches["banded_spmv_batched"]
    assert launches["transform_partial_batched"] == max(ic.numiter.tolist())


# batched K1 on the grid's adjoint spec with drift (the codomain half-steps
# of the batched fused GKL): B = 0 for every problem, and mixed B launched
# once per distinct B, as factorizations/gkl.py launches them
@pytest.mark.parametrize("Bs", [[0, 0, 0, 0], [0, 19, 12, 19], [29, 0, 29, 5]],
                         ids=["all_B0", "mixed_with_B0", "mixed"])
def test_batched_fused_step_on_the_adjoint_grid_spec_is_one_problem_launches(Bs):
    """Each problem of the batched K1 on the adjoint grid spec with drift
    (one launch per distinct ``B``, ``active`` its problems, one ``ynext``
    buffer: ``chip_smoke.check_batched_step(grouped=True)``) bit-identical
    to a one-problem launch, within the one-problem tolerance of the plain
    version; one count of ``fused_step_batched`` per distinct ``B``."""
    from chip_smoke import check_batched_step

    op = GridStencilOperator((256, 1024), POISSON_OFF, ADVECTION_CF)
    before = _build.launches["fused_step_batched"]
    case = check_batched_step(torch, fl, op, len(Bs), 2048, 31, Bs, True, _gen(150 + sum(Bs)),
                              timed=False, adjoint=True, grouped=True)
    assert _build.launches["fused_step_batched"] == before + len(set(Bs))
    assert case["bit_identical_to_one_problem_launches"]


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_problem"])
def test_batched_banded_adjoint_is_apply_adjoint_row_by_row(shared):
    """The adjoint stack apply of ``solvers/batched.py:_Operators`` on
    banded operators with their adjoints (config 4's non-symmetric
    tridiagonal at n = 2^16, its lower band scaled per problem): one
    ``banded_spmv_batched`` launch on the adjoint planes, each row
    bit-identical to ``op.apply_adjoint``, no one-problem launch."""
    from chip_smoke import tridiagonal_coo
    from krylovkit_tpu_torch.solvers.batched import _Operators

    P, n = 4, 1 << 16
    ops = [kt.banded_from_coo(*tridiagonal_coo(np, n, -1.3 * (1 + 0.1 * p), 2.0, -0.7,
                                               np.float32), n) for p in range(P)]
    X = torch.randn((P, n // 128, 128), generator=_gen(160), device="cuda")
    batch = _Operators(ops[0] if shared else ops, P, not shared)
    _build.reset_launches()
    Y = batch.apply_adjoint_stack(X, list(range(P)))
    torch.cuda.synchronize()
    assert {k: v for k, v in _build.launches.items() if v} == {"banded_spmv_batched": 1}
    for p in range(P):
        assert torch.equal(Y[p], (ops[0] if shared else ops[p]).apply_adjoint(X[p]))


def test_batched_svdsolve_and_lssolve_on_card_match_one_problem_solves():
    """A small fused ``svdsolve_gkl_batched`` (the advection grid stencil,
    256 × 1024, three starts, krylovdim 16, maxiter 3) and a small
    ``lssolve_lsmr_batched`` (the banded 128² Poisson with its adjoint,
    three right-hand sides, 20 iterations) on the card: each problem's
    counts and bits equal to its one-problem solve on the card, only
    batched launches."""
    from chip_smoke import batched_starts
    from krylovkit_tpu_torch.solvers import lssolve as lss
    from krylovkit_tpu_torch.solvers import svdsolve as svds

    P = 3
    op = GridStencilOperator((256, 1024), POISSON_OFF, ADVECTION_CF)
    X = batched_starts(torch, np, 2048, P, "cuda")
    alg = kt.GKL(krylovdim=16, maxiter=3, tol=1e-30, verbosity=kt.SILENT)
    _build.reset_launches()
    S, U, W, it = kt.svdsolve_gkl_batched(op, X, 4, "LR", alg)
    torch.cuda.synchronize()
    launches = {k: v for k, v in _build.launches.items() if v}
    # keep (3·16)//5 = 9: 2·(16 + 7 + 7) applies a problem, K1 all but the
    # two of each round's tail step, at one live-row count a half-step
    assert launches == {"fused_step_batched": 2 * (16 + 7 + 7) - 2 * 3,
                        "transform_partial_batched": 6}, launches
    for p in range(P):
        S1, U1, W1, i1 = svds.svdsolve_gkl(op, X[p], 4, "LR", alg)
        assert [i1.numops, i1.numiter] == [it.numops[p].item(), it.numiter[p].item()]
        assert torch.equal(S[p], S1) and torch.equal(U[p], U1) and torch.equal(W[p], W1)
    n = 128 * 128
    banded = kt.banded_from_coo(*poisson_coo(np, 128, np.float32), n)
    B = batched_starts(torch, np, n // 128, P, "cuda")
    lalg = kt.LSMR(maxiter=20, tol=1e-30, verbosity=kt.SILENT)
    _build.reset_launches()
    x, il = kt.lssolve_lsmr_batched(banded, B, lalg)
    torch.cuda.synchronize()
    assert {k: v for k, v in _build.launches.items() if v} == {"banded_spmv_batched": 41}
    for p in range(P):
        x1, i1 = lss.lssolve_lsmr(banded, B[p], lalg)
        assert [i1.numops, i1.numiter] == [il.numops[p].item(), il.numiter[p].item()] == [41, 20]
        assert torch.equal(x[p], x1) and torch.equal(il.normres[p], i1.normres)


def test_batched_k3_on_both_operators_of_the_q1_pencil_is_one_problem_launches():
    """The batched apply of the Q1 pencil's two nine-offset operators
    (``solvers/batched.py:_Operators`` of K and of M, shared float32
    ``BandedOperator``\\ s on the 256 × 256 grid, four problems): one
    ``banded_spmv_batched`` launch per operator, each row bit-identical to
    the operator's one-problem apply, no one-problem launch."""
    from krylovkit_tpu_torch.solvers.batched import _Operators

    P, N = 4, 256
    n = N * N
    (ck, cm) = q1_coo(np, N, N, np.float32)
    ops = [kt.banded_from_coo(*c, n) for c in (ck, cm)]
    X = torch.randn((P, n // 128, 128), generator=_gen(170), device="cuda")
    batches = [_Operators(o, P, False) for o in ops]
    _build.reset_launches()
    Y = [b.apply_stack(X, list(range(P))) for b in batches]
    torch.cuda.synchronize()
    assert {k: v for k, v in _build.launches.items() if v} == {"banded_spmv_batched": 2}
    for o, y in zip(ops, Y):
        assert len(o.offsets) == 9
        for p in range(P):
            assert torch.equal(y[p], o.normal(X[p]))


def test_batched_geneigsolve_and_bieigsolve_on_card_match_cpu():
    """A small ``geneigsolve_golubye_batched`` (the float64 Q1 pencil on a
    16 × 64 grid, three starts, 2 "SR", krylovdim 10) and a small
    ``bieigsolve_batched`` (the float64 tridiagonal (−0.4, (1 + i/63)⁸,
    −0.2) at n = 64 with its adjoint planes, three start pairs, 2 "LM",
    krylovdim 20) on the card against the same batched solves on the CPU:
    counts equal, values within 1e-10; on the card only batched K3
    launches, two per batched pencil apply in Golub-Ye and one per side
    and lock-step in BiArnoldi."""
    from chip_smoke import ApplyRecorder
    from krylovkit_tpu_torch.solvers import batched as batched_mod

    P = 3
    ny, nx = 16, 64
    n = ny * nx
    ck, cm = q1_coo(np, ny, nx, np.float64)
    X = np.random.default_rng(171).standard_normal((P, n))
    alg = kt.GolubYe(krylovdim=10, tol=1e-10, maxiter=100, verbosity=kt.SILENT)
    got = {}
    for dev in ("cuda", "cpu"):
        K, M = (kt.banded_from_coo(*c, n, device=dev) for c in (ck, cm))
        _build.reset_launches()
        with ApplyRecorder(batched_mod) as rec:
            vals, _, info = kt.geneigsolve_golubye_batched(
                K, M, torch.from_numpy(X).to(dev), 2, "SR", alg)
        torch.cuda.synchronize()
        got[dev] = (vals.cpu(), info.numops.tolist(), info.numiter.tolist(),
                    {k: v for k, v in _build.launches.items() if v}, rec.calls)
    assert got["cuda"][1:3] == got["cpu"][1:3]
    np.testing.assert_allclose(got["cuda"][0].numpy(), got["cpu"][0].numpy(), rtol=0, atol=1e-10)
    assert got["cuda"][3] == {"banded_spmv_batched": got["cuda"][4]}
    assert got["cuda"][4] >= 2 * max(got["cuda"][1]) and got["cuda"][4] % 2 == 0

    nb = 64
    i = np.arange(nb)
    coo = (np.concatenate([i[1:], i, i[:-1]]), np.concatenate([i[1:] - 1, i, i[:-1] + 1]),
           np.concatenate([np.full(nb - 1, -0.4), (1 + i / (nb - 1)) ** 8, np.full(nb - 1, -0.2)]))
    rng = np.random.default_rng(172)
    V, W = rng.standard_normal((P, nb)), rng.standard_normal((P, nb))
    balg = kt.BiArnoldi(krylovdim=20, tol=1e-10, maxiter=100, verbosity=kt.SILENT)
    got = {}
    for dev in ("cuda", "cpu"):
        op = kt.banded_from_coo(*coo, nb, device=dev)
        _build.reset_launches()
        with ApplyRecorder(batched_mod) as rec:
            vals, _, (iV, _) = kt.bieigsolve_batched(op, torch.from_numpy(V).to(dev),
                                                     torch.from_numpy(W).to(dev), 2, "LM", balg)
        torch.cuda.synchronize()
        got[dev] = (vals.cpu(), iV.numops.tolist(), iV.numiter.tolist(),
                    {k: v for k, v in _build.launches.items() if v}, rec.calls)
    assert got["cuda"][1:3] == got["cpu"][1:3]
    np.testing.assert_allclose(got["cuda"][0].numpy(), got["cpu"][0].numpy(), rtol=0, atol=1e-10)
    assert got["cuda"][3] == {"banded_spmv_batched": got["cuda"][4]}
    assert got["cuda"][4] >= max(got["cuda"][1])


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_problem"])
def test_batched_k3_with_each_problems_rows_repeated_is_one_problem_launches(shared):
    """The batched apply of a Block Lanczos lock-step
    (``solvers/batched.py:_Operators.apply_stack`` with each problem's index
    named ``b`` times): config 2's float32 Poisson planes at n = 2^16, four
    problems of four rows, the planes shared or a set per problem (scaled
    by ``1 + 0.1·p``): one ``banded_spmv_batched`` launch, every row
    bit-identical to a one-problem launch on its problem's operator."""
    from krylovkit_tpu_torch.solvers.batched import _Operators

    P, b, N = 4, 4, 256
    n = N * N
    base = kt.banded_from_coo(*poisson_coo(np, N, np.float32), n)
    ops = [base if shared else kt.BandedOperator(base.offsets, base.diags * (1 + 0.1 * p), n)
           for p in range(P)]
    batch = _Operators(base if shared else ops, P, not shared)
    X = torch.randn((P * b, n // 128, 128), generator=_gen(173), device="cuda")
    rows = [p for p in range(P) for _ in range(b)]
    _build.reset_launches()
    Y = batch.apply_stack(X, rows)
    torch.cuda.synchronize()
    assert {k: v for k, v in _build.launches.items() if v} == {"banded_spmv_batched": 1}
    for i, p in enumerate(rows):
        assert torch.equal(Y[i], ops[p].normal(X[i]))


def test_batched_k5_at_the_block_width_is_one_problem_launches():
    """Batched K5 at ``k = b = 4`` (a column pass of the batched block QR:
    each problem's ``(4, R, 128)`` block against one of its rows), eight
    problems at R = 8192: every row bit-identical to a one-problem launch
    and within 1e-5 of the plain version; one launch."""
    from chip_smoke import check_batched_projections

    _build.reset_launches()
    case = check_batched_projections(torch, pb, [4] * 8, 8192, 4, _gen(174), timed=False)
    assert case["bit_identical_to_one_problem_launches"]
    assert _build.launches["project_batched"] == 1


def test_batched_block_lanczos_on_card_is_each_one_problem_solve():
    """A small ``eigsolve_blocklanczos_batched`` on the card: the float32
    Poisson matrix of the 128 × 128 grid as one shared banded operator,
    three start blocks of 3, 3 "LR", krylovdim 20, maxiter 3, tol 1e-30
    (fixed work), the projection flag off and on: every problem
    bit-identical to its one-problem solve on the card, one batched K3
    launch a lock-step and, with the flag, one batched K5 launch per
    column pass of the block QRs (``2·b·(1 + steps)``), no one-problem
    launch."""
    from krylovkit_tpu_torch.solvers.blocklanczos import eigsolve_blocklanczos

    P, b, N = 3, 3, 128
    n = N * N
    op = kt.banded_from_coo(*poisson_coo(np, N, np.float32), n)
    X = torch.randn((P, b, n // 128, 128), generator=_gen(175), device="cuda")
    alg = kt.BlockLanczos(krylovdim=20, maxiter=3, tol=1e-30, verbosity=kt.SILENT)
    for flag in (False, True):
        bs.use_pallas_projections = flag
        try:
            _build.reset_launches()
            vals, vecs, info = kt.eigsolve_blocklanczos_batched(op, X, 3, "LR", alg)
            torch.cuda.synchronize()
            launches = {k: v for k, v in _build.launches.items() if v}
            ones = [eigsolve_blocklanczos(op, X[p], 3, "LR", alg) for p in range(P)]
        finally:
            bs.use_pallas_projections = False
        steps = info.numops[0].item() // b
        assert info.numops.tolist() == [b * steps] * P and info.numiter.tolist() == [3] * P
        want = {"banded_spmv_batched": steps}
        if flag:
            want["project_batched"] = 2 * b * (1 + steps)
        assert launches == want, launches
        for p, (v1, w1, i1) in enumerate(ones):
            assert torch.equal(vals[p], v1) and torch.equal(vecs[p], w1)
            assert torch.equal(info.normres[p], i1.normres)
            assert torch.equal(info.residual[p], i1.residual)


@pytest.mark.parametrize("kind", ["chain", "chain_multirow", "grid"])
@pytest.mark.parametrize("Bs", [[16, 16, 16], [5, 2, 7], [0, 0, 0]], ids=["equal", "mixed", "B0"])
def test_batched_fused_step_with_each_problems_halos_is_one_problem_launches(kind, Bs):
    """Batched K1 with every problem's external halos (a rank's blocks of
    split vectors: ``Vext (P, kmax, 2, h, 128)``, ``yext (P, 2, h, 128)``),
    one launch per distinct ``B``: each problem bit-identical to a
    one-problem launch with its halos, within the one-problem tolerance of
    the plain version, its other rows untouched."""
    from chip_smoke import check_batched_step

    op, R = _fused_op(kind, 512)
    before = _build.launches["fused_step_batched"]
    case = check_batched_step(torch, fl, op, len(Bs), R, 31, Bs, True, _gen(170 + sum(Bs)),
                              timed=False, grouped=True, ext=True)
    assert _build.launches["fused_step_batched"] == before + len(set(Bs))
    assert case["bit_identical_to_one_problem_launches"]


def test_batched_fused_step_halos_are_checked_on_card():
    """Both halos or neither, each problem's shape, 16-byte alignment: a
    ``ValueError`` before any launch."""
    spec, V, y, g = _batched_inputs("chain", 2, 9, 3)
    h = spec.h
    Vext = torch.zeros((2, 9, 2, h, 128), device="cuda")
    yext = torch.zeros((2, 2, h, 128), device="cuda")
    before = _build.launches["fused_step_batched"]
    with pytest.raises(ValueError, match="both external halos"):
        fl.fused_step_batched(V, y, g, 1, 1, spec, Vext=Vext)
    with pytest.raises(ValueError, match="halos"):
        fl.fused_step_batched(V, y, g, 1, 1, spec, Vext=Vext[:, :5], yext=yext)
    odd = torch.zeros(Vext.numel() + 1, device="cuda")[1:].view(Vext.shape)
    with pytest.raises(ValueError, match="16-byte"):
        fl.fused_step_batched(V, y, g, 1, 1, spec, Vext=odd, yext=yext)
    assert _build.launches["fused_step_batched"] == before


def test_batched_gradients_on_the_card_match_cpu():
    """The small float64 batches of ``chip_smoke.py``'s phase ``batched_ad``
    (the GMRES, MINRES and BiCGStab rules of the batched linear drivers,
    the general Sylvester rule of the batched Arnoldi eigsolve, both rules
    of the batched GKL svdsolve) on the card against the CPU: gradients
    within ``chip_smoke.AD_TOL`` (relative to the largest entry), counts
    equal."""
    import chip_smoke

    for label, run in chip_smoke.small_batched_ad_routes(np, kt, torch).items():
        gc, ic = run("cuda")
        gh, ih = run("cpu")
        err = max(chip_smoke._rel_err(torch, a, b) for a, b in zip(gc, gh))
        assert err <= chip_smoke.AD_TOL, (label, err)
        assert ([chip_smoke._batch_counts(i) for i in ic]
                == [chip_smoke._batch_counts(i) for i in ih]), label
