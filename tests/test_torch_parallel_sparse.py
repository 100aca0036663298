"""PyTorch port: the distribution layer's sparse half (``parallel/sparse.py``,
``parallel/mesh.py``) against the JAX package on the CPU, mirroring
``tests/test_sharded_sparse.py``.

Host planning runs in this process: ``coo_to_ell``, ``_plan_shard`` and the
three COO generators must give the JAX package's arrays exactly (bit for
bit, same dtypes) on the inputs of ``tests/test_sharded_sparse.py``; the
int64 fallback of ``coo_to_ell`` is checked by its guard's decision, and its
64-bit path by lowering the limit on a small case.

The sharded applies run on one group of 4 gloo ranks on the CPU, spawned
once for the module (``chip_smoke.run_ranks``, a 120 s collective timeout);
each scenario is its own test.  They are held against the JAX package's
sharded operator on 4 of the conftest's virtual CPU devices (float64,
within 1e-12 of ``Σ|a_ij||x_j|``), against the dense product, and the halo
plans against the JAX package's (the same rounds).
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
import krylovkit_tpu.parallel as jpar
import krylovkit_tpu.parallel.sparse as jsps
import krylovkit_tpu_torch as kt
from krylovkit_tpu_torch.parallel import sparse as tsps

WORLD = 4
SCENARIOS = ("spmv_dense", "spmv_rect_tiled", "spmv_long_range", "mesh1", "eigsolve_ell",
             "mesh_refusals", "replicate_and_groups", "collective_stats")


@pytest.fixture(scope="module")
def ranks():
    res = chip_smoke.run_ranks(WORLD, "sharded_cases", dev="cpu", timeout=400,
                               names=SCENARIOS)
    return chip_smoke.same_on_every_rank(np, res)


def _case(ranks, name):
    out = ranks[name]
    assert "error" not in out, out.get("error")
    return out


def _dense(rows, cols, vals, shape):
    A = np.zeros(shape, np.asarray(vals).dtype)
    A[np.asarray(rows), np.asarray(cols)] = np.asarray(vals)
    return A


def _long_range_coo(n=64 * 8):
    i = np.arange(n)
    k = 3 * (n // 8)
    rows = np.concatenate([i, i[:-k], i[k:]])
    cols = np.concatenate([i, i[:-k] + k, i[k:] - k])
    vals = np.concatenate([np.full(n, 2.0), np.full(n - k, -1.0), np.full(n - k, -1.0)])
    return rows, cols, vals


# the COO inputs of tests/test_sharded_sparse.py (and their shapes)
COO_CASES = {
    "banded_spmv": lambda g: (g.banded_coo(264 * 8, halfband=5, seed=1, spd=False),
                              (264 * 8, 264 * 8)),
    "rect_tiled": lambda g: (g.rect_sparse_coo(128 * 8, 64 * 8, nnz_per_row=7, seed=3),
                             (128 * 8, 64 * 8)),
    "long_range": lambda g: (_long_range_coo(), (512, 512)),
    "banded_eig": lambda g: (g.banded_coo(104 * 8, halfband=4, seed=11, spd=True),
                             (104 * 8, 104 * 8)),
    "rect_lsmr": lambda g: (g.rect_sparse_coo(96 * 8, 48 * 8, nnz_per_row=6, seed=21),
                            (96 * 8, 48 * 8)),
    "rect_svd": lambda g: (g.rect_sparse_coo(64 * 8, 40 * 8, nnz_per_row=5, seed=31),
                           (64 * 8, 40 * 8)),
    "banded_mesh1": lambda g: (g.banded_coo(512, halfband=3, seed=41), (512, 512)),
    "powerlaw": lambda g: (g.powerlaw_rect_coo(3000 * 4, 1500 * 4, seed=14), (12000, 6000)),
}


def _assert_same(a, b):
    if dataclasses.is_dataclass(a):  # the plans: the port's copy of the class
        assert type(a).__name__ == type(b).__name__
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        return
    assert type(a) is type(b)
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        assert a == b


@pytest.mark.parametrize("gen", ["banded", "rect", "powerlaw"])
def test_generators_equal_jax(gen):
    if gen == "banded":
        args, kw = (333, 6), dict(seed=5, spd=True)
        name = "banded_coo"
    elif gen == "rect":
        args, kw = (300, 120, 5), dict(seed=6)
        name = "rect_sparse_coo"
    else:
        args, kw = (400, 200), dict(seed=7)
        name = "powerlaw_rect_coo"
    for a, b in zip(getattr(tsps, name)(*args, **kw), getattr(jsps, name)(*args, **kw)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", sorted(COO_CASES))
@pytest.mark.parametrize("adjoint", [False, True])
def test_coo_to_ell_equals_jax(case, adjoint):
    (rows, cols, vals), (m, n) = COO_CASES[case](tsps)
    if adjoint:
        rows, cols, vals, m = cols, rows, np.conj(vals), n
    _assert_same(tsps.coo_to_ell(rows, cols, vals, m), jsps.coo_to_ell(rows, cols, vals, m))


@pytest.mark.parametrize("case", sorted(COO_CASES))
@pytest.mark.parametrize("D", [1, 4, 8])
def test_plan_shard_equals_jax(case, D):
    (rows, cols, vals), (m, n) = COO_CASES[case](tsps)
    ec, ev, valid = jsps.coo_to_ell(rows, cols, vals, m)
    ev = np.where(valid, ev, 0)
    _assert_same(tsps._plan_shard(ec, ev, valid, m, n, D), jsps._plan_shard(ec, ev, valid, m, n, D))


def test_coo_to_ell_int64_fallback():
    # the guard decides from the counts alone: n_rows·width at 2^31 needs
    # 64-bit flat indices (2^21 rows of width 1024: 4 GiB planes, not made)
    assert tsps.index_dtype(10, 2 ** 21, 1023) is np.int32
    assert tsps.index_dtype(10, 2 ** 21, 1024) is np.int64
    assert tsps.index_dtype(2 ** 31, 2 ** 20, 1) is np.int64
    assert tsps.index_dtype(10, 10, 1, n_cols=2 ** 31) is np.int64
    assert tsps.index_dtype(2 ** 31 - 1, 2 ** 30, 1, n_cols=2 ** 31 - 1) is np.int32


def test_coo_to_ell_int64_path_equals_int32(monkeypatch):
    (rows, cols, vals), (m, n) = COO_CASES["rect_tiled"](tsps)
    want = jsps.coo_to_ell(rows, cols, vals, m)
    monkeypatch.setattr(tsps, "INT32_LIMIT", 1000)  # force the 64-bit path
    got = tsps.coo_to_ell(rows, cols, vals, m)
    assert got[0].dtype == np.int64
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


def test_parallel_exports_every_jax_name():
    names = {n for n in dir(jpar) if not n.startswith("_")
             and n not in ("mesh", "operators", "sparse")}
    assert names | {"coo_to_ell"} <= set(kt.parallel.__all__)
    for n in names | {"coo_to_ell"}:
        assert hasattr(kt.parallel, n)


def test_make_mesh_needs_a_default_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        kt.parallel.make_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="init_process_group"):
        kt.parallel.make_mesh()


def test_make_mesh_defaults_to_the_card(ranks):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    msg = _case(ranks, "mesh_refusals")["default_device"]
    assert "needs a card on every rank" in msg


def _jax_mesh(D=WORLD):
    import jax

    if len(jax.devices()) < D:
        pytest.skip(f"needs {D} virtual devices")
    return jpar.make_mesh(D)


def _jax_apply(op, x, mesh, tiled=False):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    spec = P("vec", None) if tiled else P("vec")
    return np.asarray(jax.jit(op)(jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))))


def test_sharded_spmv_matches_jax_and_dense(ranks):
    out = _case(ranks, "spmv_dense")
    n = 264 * 8
    rows, cols, vals = tsps.banded_coo(n, halfband=5, seed=1, spd=False)
    x = np.random.default_rng(2).standard_normal(n)
    A = _dense(rows, cols, vals, (n, n))
    mesh = _jax_mesh()
    jop = jpar.sharded_ell_from_coo(rows, cols, vals, (n, n), mesh)
    tol = 1e-12 * np.maximum(np.abs(A) @ np.abs(x), 1)
    assert np.all(np.abs(out["y"] - _jax_apply(jop.normal, x, mesh)) <= tol)
    assert np.all(np.abs(out["y"] - A @ x) <= tol)
    tol_a = 1e-12 * np.maximum(np.abs(A.T) @ np.abs(x), 1)
    assert np.all(np.abs(out["z"] - _jax_apply(jop.adjoint, x, mesh)) <= tol_a)
    assert out["deltas"] == list(jop.fwd_plan.deltas)
    assert set(out["deltas"]) <= {1, WORLD - 1}  # nearest neighbours for a band


def test_sharded_spmv_rectangular_and_tiled(ranks):
    out = _case(ranks, "spmv_rect_tiled")
    m, n = 128 * 8, 64 * 8
    rows, cols, vals = tsps.rect_sparse_coo(m, n, nnz_per_row=7, seed=3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((n // 8, 8))
    u = rng.standard_normal((m // 8, 8))
    A = _dense(rows, cols, vals, (m, n))
    mesh = _jax_mesh()
    jop = jpar.sharded_ell_from_coo(rows, cols, vals, (m, n), mesh, tile=8)
    assert out["y_local_shape"] == [m // 8 // WORLD, 8]
    assert out["y"].shape == (m // 8, 8) and out["v"].shape == (n // 8, 8)
    np.testing.assert_allclose(out["y"], _jax_apply(jop.normal, x, mesh, True), rtol=0, atol=1e-12)
    np.testing.assert_allclose(out["y"].ravel(), A @ x.ravel(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(out["v"], _jax_apply(jop.adjoint, u, mesh, True), rtol=0, atol=1e-12)
    np.testing.assert_allclose(out["v"].ravel(), A.T @ u.ravel(), rtol=0, atol=1e-12)


def test_sharded_spmv_long_range_coupling(ranks):
    """Couplings spanning several ranks: multi-round halo plans."""
    out = _case(ranks, "spmv_long_range")
    rows, cols, vals = _long_range_coo()
    n = 512
    x = np.random.default_rng(5).standard_normal(n)
    mesh = _jax_mesh()
    jop = jpar.sharded_ell_from_coo(rows, cols, vals, (n, n), mesh)
    assert out["deltas"] == list(jop.fwd_plan.deltas) == [1, 2, 3]
    np.testing.assert_allclose(out["y"], _jax_apply(jop.normal, x, mesh), rtol=0, atol=1e-12)
    np.testing.assert_allclose(out["y"], _dense(rows, cols, vals, (n, n)) @ x, rtol=0, atol=1e-12)


def test_sharded_mesh1_degenerates_to_local(ranks):
    """A one-rank mesh plans no communication."""
    out = _case(ranks, "mesh1")
    n = 512
    rows, cols, vals = tsps.banded_coo(n, halfband=3, seed=41)
    x = np.random.default_rng(42).standard_normal(n)
    assert out["deltas"] == []
    jop = jpar.sharded_ell_from_coo(rows, cols, vals, (n, n), jpar.make_mesh(1))
    assert jop.fwd_plan.deltas == ()
    np.testing.assert_allclose(out["y"], _dense(rows, cols, vals, (n, n)) @ x, rtol=0, atol=1e-12)
    np.testing.assert_allclose(out["y"], _jax_apply(jop.normal, x, jpar.make_mesh(1)),
                               rtol=0, atol=1e-12)


def test_sharded_ell_asks_no_probe_apply(ranks):
    """The operator carries its dtype and shapes: an eigsolve applies it
    exactly ``numops`` times (no dtype probe)."""
    out = _case(ranks, "eigsolve_ell")
    assert out["applies"] == out["numops"] > 0


def test_replicate_and_a_process_group_axis(ranks):
    """``replicate`` gives every rank the mesh root's data; a space on the
    axis's process group reduces as one on the axis."""
    out = _case(ranks, "replicate_and_groups")
    np.testing.assert_array_equal(out["a"], np.full(3, 1.0))
    np.testing.assert_array_equal(out["b"], np.full(3, 2.0))
    want = float(np.sum(np.arange(64 * WORLD, dtype=np.float64) ** 2))
    assert out["inner_axis"] == out["inner_group"] == want


def test_halo_exchange_and_psum_are_counted_and_timed(ranks):
    """An apply's halo rounds are one all-reduce of ``(D, halo)`` slots and
    a norm one of a scalar, whether or not they are timed: the timed run
    takes the path of the untimed one and only adds seconds."""
    out = _case(ranks, "collective_stats")
    want = {"collectives": 2, "bytes": (WORLD * out["halo_elems"] + 1) * 8}
    assert out["halo_elems"] > 0
    assert out["untimed"] == {**want, "seconds_positive": False}
    assert out["timed"] == {**want, "seconds_positive": True}
