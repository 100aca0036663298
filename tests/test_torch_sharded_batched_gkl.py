"""PyTorch port: batched GKL ``svdsolve`` and batched LSMR ``lssolve`` on a
sharded space against the JAX package on the CPU.

One group of 4 gloo ranks on the CPU, a ``batch 2 × vec 2`` mesh, runs the
``gkl`` and ``lsmr`` scenarios of ``chip_smoke.sharded_batched_cases``:
``svdsolve_gkl_batched`` and ``lssolve_lsmr_batched`` on the sharded ELL
form of ``parallel.rect_sparse_coo(128, 64, 4, seed=3)`` (float64), each
rank its batch row's problems.  The JAX side is ``jax.jit(jax.vmap(...))``
of the GSPMD solve on 4 of the conftest's virtual CPU devices, its starts
split over the mesh's ``batch`` and ``vec`` axes; the ranks run while it
compiles.

Tolerances: float64 within 1e-10; ``numops``, ``numiter`` and
``converged`` equal.  Each problem is also held against its one-problem
sharded solve on the same ranks: the same bits (two ``vec`` ranks), counts
and WARN lines.  In this process, with the collectives counted and not
run: a batched solve makes as many all-reduces for three problems as for
one (every collective of these drivers is a lock-step's or the start's).
"""

import numpy as np
import pytest
import torch

import chip_smoke
import krylovkit_tpu as kk
import krylovkit_tpu.parallel as jpar
import krylovkit_tpu_torch as kt
from krylovkit_tpu_torch.ops import collectives as tcol
from krylovkit_tpu_torch.parallel.mesh import MeshAxis

WORLD = 4
TOL = 1e-10
SCENARIOS = ("gkl", "lsmr")


def _mesh():
    import jax

    if len(jax.devices()) < WORLD:
        pytest.skip(f"needs {WORLD} virtual devices")
    return jpar.make_mesh(WORLD, batch=2)


def _put(x, mesh):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as Ps

    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, Ps("batch", "vec")))


def _jax_solves():
    """The JAX package's vmapped GSPMD solves of both scenarios."""
    import jax

    from krylovkit_tpu.solvers.lssolve import lssolve_lsmr
    from krylovkit_tpu.solvers.svdsolve import svdsolve_gkl

    mesh = _mesh()
    out = {}
    for name in SCENARIOS:
        prob = chip_smoke.sharded_batched_problem(np, name)
        op = jpar.sharded_ell_from_coo(*chip_smoke.sharded_batched_coo(jpar, prob),
                                       prob["shape"], mesh)
        X = _put(prob["X"], mesh)
        kw = chip_smoke.SHARDED_BATCHED_ALGS[name]
        if name == "gkl":
            alg = kk.GKL(**kw)
            vals, _, _, info = jax.jit(jax.vmap(lambda x: svdsolve_gkl(op, x, 2, "LR", alg)))(X)
        else:
            alg = kk.LSMR(**kw)
            vals, info = jax.jit(jax.vmap(lambda b: lssolve_lsmr(op, b, alg)))(X)
        out[name] = (np.asarray(vals), info)
    return out


@pytest.fixture(scope="module")
def solved():
    """``(ranks, jax)``: the ranks' results and the JAX package's, the two
    computed at the same time."""
    handle = chip_smoke.start_ranks(WORLD, "sharded_batched_cases", dev="cpu", timeout=400,
                                    names=SCENARIOS)
    try:
        want = _jax_solves()
    finally:
        got = chip_smoke.collect_ranks(handle)
    return chip_smoke.same_on_every_rank(np, got), want


@pytest.mark.parametrize("name", SCENARIOS)
def test_sharded_batched_gkl_lsmr_match_jax_vmap(solved, name):
    """GKL ``svdsolve`` (2 largest singular values) and LSMR on the sharded
    rectangular ELL operator: values within 1e-10 of ``jax.vmap`` of the
    GSPMD solve, counts equal, and each problem its one-problem sharded
    solve bit for bit with its counts and WARN lines."""
    ranks, jax_out = solved
    out = ranks[name]
    assert "error" not in out, out.get("error")
    vals, info = jax_out[name]
    np.testing.assert_allclose(out["vals" if name == "gkl" else "X"], vals, rtol=0, atol=TOL)
    for k in ("numops", "numiter", "converged"):
        assert out[k] == np.asarray(getattr(info, k)).tolist(), k
    assert out["one_problem_counts"] == [list(c) for c in zip(
        out["numops"], out["numiter"], out["converged"])]
    assert out["one_problem_bits"] and out["warn_lines_equal"]
    # two problems a rank: the batch makes fewer all-reduces than its
    # one-problem solves
    assert all(b < o for b, o in zip(out["collectives"], out["one_problem_collectives"]))


# --------------------------------------------------------------------------
# in this process: the collectives of a batch do not grow with its problems
# --------------------------------------------------------------------------


class _FakeWork:
    def wait(self):
        return None


@pytest.fixture
def fake_collectives(monkeypatch):
    """``dist.all_reduce`` replaced by a no-op (this rank's partner adds
    zeros): the collectives are counted, no group is needed."""
    monkeypatch.setattr(tcol.dist, "all_reduce", lambda t, group=None, async_op=False:
                        _FakeWork())
    yield
    tcol.reset_stats()


class _AxisMesh:
    """Rank 0 of a two-rank ``vec`` axis, as ``sharded_ell_from_coo`` asks it."""

    def __init__(self):
        self.ax = MeshAxis("vec", None, 2, 0)
        self.device = torch.device("cpu")

    def axis(self, name):
        return self.ax


def _collectives(solve, Pn):
    tcol.reset_stats()
    solve(Pn)
    return tcol.stats["collectives"]


@pytest.mark.parametrize("driver", ["svdsolve_gkl_batched", "lssolve_lsmr_batched"])
@pytest.mark.parametrize("orth", ["cgs", "cgs2"])
def test_batched_solve_collectives_do_not_grow_with_problems(fake_collectives, driver, orth):
    """A batch of three copies of one problem makes exactly the all-reduces
    of a batch of one: every lock-step collective (the stack apply, the
    adjoint stack apply, a sweep's coefficients, the norms) and the start's
    are one for all the problems, and these drivers' rounds make none."""
    mesh = _AxisMesh()
    prob = chip_smoke.sharded_batched_problem(np, "gkl")
    m, n = prob["shape"]
    op = kt.parallel.sharded_ell_from_coo(*chip_smoke.sharded_batched_coo(kt.parallel, prob),
                                          (m, n), mesh)
    space = kt.VectorSpace(psum_axis=mesh.ax)
    x = torch.from_numpy(prob["X"][0, :m // 2])

    def solve(Pn):
        X = x.expand(Pn, -1).clone()
        if driver == "svdsolve_gkl_batched":
            alg = kt.GKL(krylovdim=8, maxiter=3, tol=1e-12, orth=getattr(kt, orth),
                         verbosity=kt.SILENT)
            return kt.svdsolve_gkl_batched(op, X, 2, "LR", alg, space)
        alg = kt.LSMR(krylovdim=4, maxiter=12, tol=1e-14, orth=getattr(kt, orth),
                      verbosity=kt.SILENT)
        return kt.lssolve_lsmr_batched(op, X, alg, 0.0, space)

    one, three = _collectives(solve, 1), _collectives(solve, 3)
    assert one == three > 0
