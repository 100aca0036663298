"""PyTorch port: batched Golub-Ye ``geneigsolve``, BiArnoldi ``bieigsolve``
and Block Lanczos ``eigsolve`` on a sharded space against the JAX package
on the CPU.

One group of 4 gloo ranks on the CPU, a ``batch 2 × vec 2`` mesh, runs the
``golubye``, ``biarnoldi`` and ``blocklanczos`` scenarios of
``chip_smoke.sharded_batched_cases`` (float64, n = 64, each rank its batch
row's problems): Golub-Ye on the pencil of the sharded ELL form of
``parallel.banded_coo(64, 4, seed=11)`` and a sharded diagonal ``B``,
BiArnoldi on a sharded non-symmetric tridiagonal, Block Lanczos with
blocks of 2 on the banded matrix.  The JAX side is ``jax.jit(jax.vmap(...))``
of the GSPMD solve on 4 of the conftest's virtual CPU devices, its starts
split over the mesh's ``batch`` and ``vec`` axes (a start block's rows over
``vec``); the ranks run while it compiles.

Tolerances: float64 within 1e-10; ``numops``, ``numiter`` and
``converged`` equal.  Each problem is also held against its one-problem
sharded solve on the same ranks: the same bits (two ``vec`` ranks), counts
and WARN lines.  In this process, with the collectives counted and not
run: outside the once-a-round work that keeps its one-problem collectives
(Golub-Ye's ``_ritz`` and ``_restart``, BiArnoldi's ``_round``), a batched
solve makes as many all-reduces for three problems as for one.
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
from krylovkit_tpu_torch.solvers import batched_biarnoldi as tbba
from krylovkit_tpu_torch.solvers import batched_golubye as tbgy

WORLD = 4
TOL = 1e-10
SCENARIOS = ("golubye", "biarnoldi", "blocklanczos")


def _mesh():
    import jax

    if len(jax.devices()) < WORLD:
        pytest.skip(f"needs {WORLD} virtual devices")
    return jpar.make_mesh(WORLD, batch=2)


def _put(x, mesh):
    """Problems over ``batch``, vector entries (the last axis) over ``vec``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as Ps

    spec = ("batch",) + (None,) * (np.ndim(x) - 2) + ("vec",)
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, Ps(*spec)))


def _jax_solves():
    """The JAX package's vmapped GSPMD solves of the three scenarios:
    ``{name: (values, info)}``, compiled in three threads at once."""
    from concurrent.futures import ThreadPoolExecutor

    mesh = _mesh()
    with ThreadPoolExecutor(len(SCENARIOS)) as pool:
        done = {name: pool.submit(_jax_solve, name, mesh) for name in SCENARIOS}
    return {name: f.result() for name, f in done.items()}


def _jax_solve(name, mesh):
    import jax

    from krylovkit_tpu.solvers.biarnoldi import bieigsolve_driver
    from krylovkit_tpu.solvers.blocklanczos import eigsolve_blocklanczos
    from krylovkit_tpu.solvers.golubye import geneigsolve_golubye

    prob = chip_smoke.sharded_batched_problem(np, name)

    def ell(key="coo"):
        return jpar.sharded_ell_from_coo(*chip_smoke.sharded_batched_coo(jpar, prob, key),
                                         prob["shape"], mesh)

    op, X = ell(), _put(prob["X"], mesh)
    kw = chip_smoke.SHARDED_BATCHED_ALGS[name]
    if name == "golubye":
        opB, alg = ell("coo_b"), kk.GolubYe(**kw)
        vals, _, info = jax.jit(jax.vmap(
            lambda x: geneigsolve_golubye(op, opB, x, 2, "SR", alg)))(X)
    elif name == "biarnoldi":
        alg = kk.BiArnoldi(**kw)
        vals, _, (info, _) = jax.jit(jax.vmap(
            lambda v, w: bieigsolve_driver(op, v, w, 2, "LM", alg)))(X, _put(prob["Y"], mesh))
        vals = np.stack([np.real(vals), np.imag(vals)], axis=1)
    else:
        alg = kk.BlockLanczos(**kw)
        vals, _, info = jax.jit(jax.vmap(
            lambda x: eigsolve_blocklanczos(op, x, 2, "LM", alg)))(X)
    return np.asarray(vals), info


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
def test_sharded_batched_pencil_solves_match_jax_vmap(solved, name):
    """Golub-Ye (2 smallest of the pencil), BiArnoldi (2 of largest
    modulus) and Block Lanczos (2 of largest modulus): values within 1e-10
    of ``jax.vmap`` of the GSPMD solve, counts equal, and each problem its
    one-problem sharded solve bit for bit with its counts and WARN lines."""
    ranks, jax_out = solved
    out = ranks[name]
    assert "error" not in out, out.get("error")
    vals, info = jax_out[name]
    np.testing.assert_allclose(out["vals"], vals, rtol=0, atol=TOL)
    for k in ("numops", "numiter", "converged"):
        assert out[k] == np.asarray(getattr(info, k)).tolist(), k
    assert out["one_problem_counts"] == [list(c) for c in zip(
        out["numops"], out["numiter"], out["converged"])]
    assert out["one_problem_bits"] and out["warn_lines_equal"]
    assert all(b < o for b, o in zip(out["collectives"], out["one_problem_collectives"]))


# --------------------------------------------------------------------------
# in this process: the lock-steps' collectives do not grow with the problems
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


def _rounds_counted(monkeypatch, module, names, inside):
    """Wrap ``module``'s once-a-round functions ``names`` so that the
    collectives they make are added to ``inside[0]``."""
    for name in names:
        real = getattr(module, name)

        def counted(*a, real=real, **kw):
            before = tcol.stats["collectives"]
            out = real(*a, **kw)
            inside[0] += tcol.stats["collectives"] - before
            return out

        monkeypatch.setattr(module, name, counted)


@pytest.mark.parametrize("driver", ["geneigsolve_golubye_batched", "bieigsolve_batched",
                                    "eigsolve_blocklanczos_batched"])
def test_batched_solve_collectives_do_not_grow_with_problems(fake_collectives, monkeypatch,
                                                             driver):
    """A batch of three copies of one problem makes, outside the rounds'
    per-problem work, exactly the all-reduces of a batch of one: the stack
    applies (the pencil's two, the operator's and its adjoint's), every
    sweep, norm and inner product, ``M``'s and the oblique correction's
    projections, each Block Lanczos Gram pass and block-QR column are one
    for all the problems.  The rounds' collectives are three times one
    problem's (Block Lanczos' round makes none)."""
    name = {"geneigsolve_golubye_batched": "golubye", "bieigsolve_batched": "biarnoldi",
            "eigsolve_blocklanczos_batched": "blocklanczos"}[driver]
    mesh = _AxisMesh()
    prob = chip_smoke.sharded_batched_problem(np, name)

    def ell(key="coo"):
        return kt.parallel.sharded_ell_from_coo(
            *chip_smoke.sharded_batched_coo(kt.parallel, prob, key), prob["shape"], mesh)

    op, space, half = ell(), kt.VectorSpace(psum_axis=mesh.ax), prob["n"] // 2
    inside = [0]
    if name == "golubye":
        _rounds_counted(monkeypatch, tbgy, ("_ritz", "_restart"), inside)
    elif name == "biarnoldi":
        _rounds_counted(monkeypatch, tbba, ("_round",), inside)
    quiet = dict(verbosity=kt.SILENT)

    def solve(Pn):
        x = torch.from_numpy(prob["X"][0, ..., :half])
        X = x.expand((Pn,) + tuple(x.shape)).clone()
        if name == "golubye":
            return kt.geneigsolve_golubye_batched(
                op, ell("coo_b"), X, 2, "SR", kt.GolubYe(krylovdim=6, maxiter=3, **quiet), space)
        if name == "biarnoldi":
            W = torch.from_numpy(prob["Y"][0, :half]).expand(Pn, -1).clone()
            return kt.bieigsolve_batched(op, X, W, 2, "LM",
                                         kt.BiArnoldi(krylovdim=8, maxiter=3, **quiet), space)
        return kt.eigsolve_blocklanczos_batched(
            op, X, 2, "LM", kt.BlockLanczos(krylovdim=8, maxiter=3, **quiet), space)

    counts = {}
    for Pn in (1, 3):
        inside[0] = 0
        tcol.reset_stats()
        solve(Pn)
        counts[Pn] = (tcol.stats["collectives"] - inside[0], inside[0])
    assert counts[1][0] == counts[3][0] > 0
    assert counts[3][1] == 3 * counts[1][1]
    assert (counts[1][1] > 0) == (name != "blocklanczos")
