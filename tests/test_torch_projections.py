"""PyTorch port: the live-row basis projections (``ops/projections.py``) and
their routing through ``ops/basis.py``'s module flag.

On the CPU the wrappers run their plain versions, which are held against
the JAX package's Pallas kernels in interpret mode (``kb=4, br=8``) at
``(13, 16, 128)`` float32, atol 1e-4 as in the JAX package's own test of
those kernels.  The CUDA kernels are compared with the same plain versions
on the card (``tests/test_torch_kernels_cuda.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import krylovkit_tpu.ops.basis as jbs
from krylovkit_tpu.ops.pallas_basis import project_pallas as j_project_pallas
from krylovkit_tpu.ops.pallas_basis import supported_leaf as j_supported_leaf
from krylovkit_tpu.ops.pallas_basis import unproject_pallas as j_unproject_pallas
import krylovkit_tpu_torch as kt
from krylovkit_tpu_torch import _build
from krylovkit_tpu_torch.ops import basis as tbs
from krylovkit_tpu_torch.ops import orthonormal as ton
from krylovkit_tpu_torch.ops import projections as tpb
from krylovkit_tpu_torch.ops.vector import VectorSpace

torch.set_num_threads(2)

KMAX, R = 13, 16


@pytest.fixture
def flag_on():
    old = tbs.use_pallas_projections
    tbs.use_pallas_projections = True
    try:
        yield
    finally:
        tbs.use_pallas_projections = old


def _basis(seed, kmax=KMAX, rows=R, dtype=np.float32):
    rng = np.random.default_rng(seed)
    V = rng.standard_normal((kmax, rows, 128)).astype(dtype)
    w = rng.standard_normal((rows, 128)).astype(dtype)
    c = rng.standard_normal(kmax).astype(dtype)
    return V, w, c


@pytest.mark.parametrize("k", [0, 1, 5, 8, 13])
def test_project_matches_jax_pallas(k):
    V, w, _ = _basis(3)
    want = np.asarray(j_project_pallas(jnp.asarray(V), jnp.asarray(w), k, kb=4, br=8,
                                       interpret=True))
    Vt, wt = torch.from_numpy(V), torch.from_numpy(w)
    for kk_ in (k, torch.tensor([k], dtype=torch.int32)):
        got = tpb.project_pallas(Vt, wt, kk_)
        assert got.shape == (KMAX,) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
        assert np.all(got.numpy()[k:] == 0)
    np.testing.assert_array_equal(tpb.project_reference(Vt, wt, k).numpy(),
                                  tpb.project_pallas(Vt, wt, k).numpy())


@pytest.mark.parametrize("k", [0, 1, 4, 13])
def test_unproject_matches_jax_pallas(k):
    V, _, c = _basis(4)
    c[k:] = 0
    want = np.asarray(j_unproject_pallas(jnp.asarray(V), jnp.asarray(c), k, kb=4, br=8,
                                         interpret=True))
    Vt, ct = torch.from_numpy(V), torch.from_numpy(c)
    for kk_ in (k, torch.tensor([k], dtype=torch.int32)):
        got = tpb.unproject_pallas(Vt, ct, kk_)
        assert got.shape == (R, 128) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    if k == 0:
        assert not got.any()


def test_live_rows_only():
    # rows >= k are never read: NaN there must not reach the results
    V, w, c = _basis(5)
    k = 5
    V[k:] = np.nan
    c[k:] = 0
    Vt = torch.from_numpy(V)
    assert torch.isfinite(tpb.project_pallas(Vt, torch.from_numpy(w), k)).all()
    assert torch.isfinite(tpb.unproject_pallas(Vt, torch.from_numpy(c), k)).all()


def test_supported_leaf_matches_jax():
    for shape, dtype in [((13, 16, 128), np.float32), ((13, 12, 128), np.float32),
                         ((13, 16, 64), np.float32), ((13, 2048), np.float32),
                         ((13, 16, 128), np.float64), ((31, 8, 128), np.float32)]:
        Z = np.zeros(shape, dtype)
        assert tpb.supported_leaf(torch.from_numpy(Z)) == j_supported_leaf(jnp.asarray(Z)), shape
    # this port's own cap: the kernels keep kmax values in shared memory
    assert not tpb.supported_leaf(torch.zeros((tpb.MAX_KMAX + 1, 8, 128)))
    assert tpb.supported_leaf(torch.zeros((tpb.MAX_KMAX, 8, 128)))


def test_wrapper_gates_raise():
    V, w, c = (torch.from_numpy(a) for a in _basis(6))
    with pytest.raises(ValueError, match="float32"):
        tpb.project_pallas(V.double(), w.double(), 3)
    with pytest.raises(ValueError, match="basis"):
        tpb.project_pallas(V[:, :12], w[:12], 3)
    with pytest.raises(ValueError, match="shape"):
        tpb.project_pallas(V, w[:8], 3)
    with pytest.raises(ValueError, match="k <= kmax"):
        tpb.project_pallas(V, w, KMAX + 1)
    with pytest.raises(ValueError, match="k <= kmax"):
        tpb.unproject_pallas(V, c, -1)
    with pytest.raises(ValueError, match="int32"):
        tpb.project_pallas(V, w, torch.tensor([3]))
    with pytest.raises(ValueError, match="real"):
        tpb.unproject_pallas(V, c.to(torch.complex64), 3)
    with pytest.raises(ValueError, match="shape"):
        tpb.unproject_pallas(V, c[:5], 3)


def test_flag_default_is_off_as_in_jax():
    assert tbs.use_pallas_projections is False and jbs.use_pallas_projections is False


@pytest.mark.parametrize("k", [1, 6, 13])
def test_flag_routes_eligible_basis_to_plain_versions(flag_on, monkeypatch, k):
    V, w, _ = (torch.from_numpy(a) for a in _basis(7))
    calls = []
    monkeypatch.setattr(tpb, "project_reference",
                        lambda *a, f=tpb.project_reference: calls.append("p") or f(*a))
    monkeypatch.setattr(tpb, "unproject_reference",
                        lambda *a, f=tpb.unproject_reference: calls.append("u") or f(*a))
    # the CPU path builds nothing: no library is loaded, no launch is counted
    monkeypatch.setattr(_build, "library", lambda name: pytest.fail("built a kernel on the CPU"))
    _build.reset_launches()
    w1, c1 = ton._cgs_sweep(w, V, k, kt.STANDARD)
    assert calls == ["p", "u"] and not _build.launches
    tbs.use_pallas_projections = False
    w0, c0 = ton._cgs_sweep(w, V, k, kt.STANDARD)
    assert calls == ["p", "u"]
    # same coefficients as the bucketed sweep, within float32 summation order
    scale = float(torch.linalg.vector_norm(w)) * float(torch.linalg.vector_norm(V[0]))
    np.testing.assert_allclose(c1.numpy(), c0.numpy(), atol=1e-5 * scale)
    np.testing.assert_allclose(w1.numpy(), w0.numpy(), atol=1e-5 * float(w0.abs().max()) * KMAX)
    assert c1.shape == c0.shape == (KMAX,) and c1.dtype == c0.dtype


@pytest.mark.parametrize("case", ["float64", "rows", "lanes", "flat", "inner", "complex_c",
                                  "too_wide"])
def test_flag_leaves_ineligible_basis_on_matmul_path(flag_on, monkeypatch, case):
    monkeypatch.setattr(tpb, "project_pallas", lambda *a: pytest.fail("project kernel path taken"))
    space = kt.STANDARD
    V, w, c = _basis(8)
    if case == "float64":
        V, w, c = V.astype(np.float64), w.astype(np.float64), c.astype(np.float64)
    elif case == "rows":
        V, w = V[:, :12], w[:12]
    elif case == "lanes":
        V, w = V.reshape(KMAX, 32, 64), w.reshape(32, 64)
    elif case == "flat":
        V, w = V.reshape(KMAX, -1), w.reshape(-1)
    elif case == "inner":
        space = VectorSpace(inner_fn=lambda x, y: 2 * torch.vdot(x.reshape(-1), y.reshape(-1)))
    elif case == "too_wide":
        V = np.concatenate([V] * 10)[: tpb.MAX_KMAX + 1]
        c = np.concatenate([c] * 10)[: tpb.MAX_KMAX + 1]
    Vt, wt, ct = (torch.from_numpy(np.ascontiguousarray(a)) for a in (V, w, c))
    k = 5
    if case != "complex_c":
        got = tbs.project(Vt, wt, k, space)
        tbs.use_pallas_projections = False
        np.testing.assert_array_equal(got.numpy(), tbs.project(Vt, wt, k, space).numpy())
        tbs.use_pallas_projections = True
    if case == "inner":
        return  # unproject takes no space: the basis itself is eligible
    monkeypatch.setattr(tpb, "unproject_pallas", lambda *a: pytest.fail("unproject kernel path taken"))
    if case == "complex_c":
        ct = ct.to(torch.complex64)
    ct[k:] = 0
    got = tbs.unproject(Vt, ct, k)
    np.testing.assert_array_equal(got.numpy(), tbs.unproject(Vt, ct).numpy())


def test_unproject_without_k_keeps_matmul_path(flag_on, monkeypatch):
    monkeypatch.setattr(tpb, "unproject_pallas", lambda *a: pytest.fail("kernel path without k"))
    V, _, c = (torch.from_numpy(a) for a in _basis(9))
    assert tbs.unproject(V, c).shape == (R, 128)


def _poisson_coo(nx, dtype):
    i = np.arange(nx * nx)
    iy, ix = i // nx, i % nx
    rows, cols, vals = [i], [i], [np.full(i.size, 4.0, dtype)]
    for mask, d in ((iy > 0, -nx), (ix > 0, -1), (ix < nx - 1, 1), (iy < nx - 1, nx)):
        rows.append(i[mask])
        cols.append(i[mask] + d)
        vals.append(np.full(int(mask.sum()), -1.0, dtype))
    return tuple(np.concatenate(a) for a in (rows, cols, vals))


@pytest.mark.parametrize("orth", ["cgs2", "cgs", "cgsir"])
def test_banded_gmres_flag_on_matches_flag_off(orth):
    # the flag is process-global: it reaches the unfused GMRES expansion too
    nx = 32
    top = kt.banded_from_coo(*_poisson_coo(nx, np.float32), nx * nx, device="cpu")
    b = torch.ones((nx * nx // 128, 128))
    alg = kt.GMRES(krylovdim=20, tol=1e-3, maxiter=50, orth=getattr(kt, orth))
    x0, i0 = kt.linsolve(top, b, a0=0.5, alg=alg)
    calls = []
    orig = tpb.project_reference
    old = tbs.use_pallas_projections
    tbs.use_pallas_projections = True
    tpb.project_reference = lambda *a: calls.append(1) or orig(*a)
    try:
        x1, i1 = kt.linsolve(top, b, a0=0.5, alg=alg)
    finally:
        tbs.use_pallas_projections = old
        tpb.project_reference = orig
    # every expansion's sweep went through the projections (numops also
    # counts the two residual evaluations of each cycle)
    assert len(calls) >= i1.numops - 2 * i1.numiter > 0
    assert (i1.numops, i1.numiter, i1.converged) == (i0.numops, i0.numiter, i0.converged)
    assert i1.converged == 1
    np.testing.assert_allclose(x1.numpy(), x0.numpy(), atol=2e-5 * float(x0.abs().max()))
