"""PyTorch port: batched solves on a sharded space (the counterpart of
``jax.vmap`` over a sharded solve) against the JAX package on the CPU.

One group of 4 gloo ranks on the CPU is spawned for the module
(``chip_smoke.run_ranks``) on a ``batch 2 × vec 2`` mesh and runs the
unfused linear scenarios of ``chip_smoke.sharded_batched_cases``: batched
GMRES on ``sharded_laplacian_1d`` (``__graft_entry__.py``'s problem), CG,
MINRES and BiCGStab, and the stack applies of the sharded operators.  Every
rank must return the same bits.  The JAX side is ``jax.vmap`` of the GSPMD
solve on 4 of the conftest's virtual CPU devices
(``tests/test_sparse_and_spaces.py:85,109,155``), its right-hand sides split
over the mesh's ``batch`` and ``vec`` axes.  The eigensolvers are in
``tests/test_torch_sharded_batched_eig.py``, the fused solves in
``..._fused.py`` and ``..._fused_nonsym.py`` (each file its own group of
ranks, so each stays short on one worker).

Tolerances: float64 within 1e-10 with ``numops``, ``numiter`` and
``converged`` equal.  Each problem is
also held against its one-problem sharded solve on the same ranks: over two
``vec`` ranks the bits hold (an all-reduce of two partials sums them in
one order whatever the buffer), and so do the counts and the WARN lines.
In this process: the glued batched K1 twin with per-problem halos against
the unsharded batched step, one all-reduce a fused lock-step for all
stepping problems (``collectives.stats``), the edge exchange of a stack,
and what the drivers still refuse on a sharded space.  The GKL, LSMR and
pencil drivers' parity on a sharded space is in
``tests/test_torch_sharded_batched_gkl.py`` and ``..._pencil.py``.
"""

from functools import lru_cache
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
import krylovkit_tpu as kk
import krylovkit_tpu.parallel as jpar
import krylovkit_tpu_torch as kt
from krylovkit_tpu_torch.factorizations import krylov as tkf
from krylovkit_tpu_torch.ops import collectives as tcol
from krylovkit_tpu_torch.ops import fused_lanczos as tfl
from krylovkit_tpu_torch.ops import orthonormal as ton
from krylovkit_tpu_torch.ops.vector import VectorSpace
from krylovkit_tpu_torch.parallel.mesh import MeshAxis

WORLD = 4
TOL = 1e-10
SCENARIOS = ("gmres", "cg", "minres", "bicgstab", "stack_apply") + chip_smoke.SHARDED_BATCHED_TREE


@pytest.fixture(scope="module")
def ranks():
    # the JAX side (cached) runs while the ranks do
    handle = chip_smoke.start_ranks(WORLD, "sharded_batched_cases", dev="cpu", timeout=400,
                                    names=SCENARIOS)
    try:
        for name in SCENARIOS:
            if name != "stack_apply":
                _jax_solve(name)
    finally:
        res = chip_smoke.collect_ranks(handle)
    return chip_smoke.same_on_every_rank(np, res)


def _case(ranks, name):
    out = ranks[name]
    assert "error" not in out, out.get("error")
    return out


def _mesh():
    import jax

    if len(jax.devices()) < WORLD:
        pytest.skip(f"needs {WORLD} virtual devices")
    return jpar.make_mesh(WORLD, batch=2)


def _put(x, mesh):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as Ps

    spec = ("batch", "vec") + (None,) * (np.ndim(x) - 2)
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, Ps(*spec)))


def _counts_equal(out, info):
    for k in ("numops", "numiter", "converged"):
        assert out[k] == np.asarray(getattr(info, k)).tolist(), k


def _against_one_problem(out):
    """Each problem's one-problem sharded solve: the same counts, the same
    bits, the same WARN lines."""
    assert out["one_problem_counts"] == [list(c) for c in zip(
        out["numops"], out["numiter"], out["converged"])]
    assert out["one_problem_bits"] and out["warn_lines_equal"]


def _ell(name, mesh, tile=None):
    prob = chip_smoke.sharded_batched_problem(np, name)
    n = prob["n"]
    coo = prob["coo"] or jpar.banded_coo(n, halfband=4, seed=11, spd=True)
    return prob, jpar.sharded_ell_from_coo(*coo, (n, n), mesh, tile=tile)


@lru_cache(maxsize=None)
def _jax_solve(name):
    """``jax.jit(jax.vmap(...))`` of the GSPMD solve of scenario ``name`` on
    the 4 virtual devices: its results (``X``, ``Y`` or ``vals``) and
    counts as host arrays."""
    import jax
    import jax.numpy as jnp

    from krylovkit_tpu.ops.operator import as_operator
    from krylovkit_tpu.solvers import bicgstab, cg, gmres, lanczos, minres

    mesh = _mesh()
    prob = chip_smoke.sharded_batched_problem(np, name)
    one = jnp.asarray(1, jnp.float64)
    if name in chip_smoke.SHARDED_BATCHED_TREE:
        lap = jpar.sharded_laplacian_1d(prob["n"], mesh, jnp.float64)
        op = as_operator(lambda v: (lap.normal(v[0]) + 0.5 * v[1],
                                    lap.normal(v[1]) + 0.5 * v[0]))
        kw = chip_smoke.SHARDED_BATCHED_TREE_ALGS[name]
        X, Y = _put(prob["X"], mesh), _put(prob["Y"], mesh)
        if name == "tree_lanczos":
            vals, _, info = jax.jit(jax.vmap(lambda p, q: lanczos.eigsolve_lanczos(
                op, (p, q), 2, "SR", kk.Lanczos(**kw))))(X, Y)
            out = {"vals": vals}
        else:
            solve, alg = ((cg.linsolve_cg, kk.CG(**kw)) if name == "tree_cg" else
                          (gmres.linsolve_gmres, kk.GMRES(**kw)))
            (xp, xq), info = jax.jit(jax.vmap(lambda p, q: solve(
                op, (p, q), (jnp.zeros_like(p), jnp.zeros_like(q)), one, one, alg)))(X, Y)
            out = {"X": xp, "Y": xq}
    else:
        if name == "gmres":
            op = jpar.sharded_laplacian_1d(prob["n"], mesh, jnp.float64)
            solve, alg, a0 = (gmres.linsolve_gmres, kk.GMRES(krylovdim=16, maxiter=50, tol=1e-9),
                              1.0)
        elif name == "cg":
            op = jpar.sharded_laplacian_1d(prob["n"], mesh, jnp.float64)
            solve, alg, a0 = cg.linsolve_cg, kk.CG(tol=1e-10, maxiter=3000), 0.5
        elif name == "minres":
            op = _ell(name, mesh)[1]
            solve, alg, a0 = minres.linsolve_minres, kk.MINRES(tol=1e-10, maxiter=3000), 0.0
        else:
            op = _ell(name, mesh)[1]
            solve, alg, a0 = (bicgstab.linsolve_bicgstab,
                              kk.BiCGStab(tol=1e-10, maxiter=3000), 1.0)
        a0 = jnp.asarray(a0, jnp.float64)
        X, info = jax.jit(jax.vmap(lambda b: solve(op, b, jnp.zeros_like(b), a0, one, alg)))(
            _put(prob["X"], mesh))
        out = {"X": X}
    out = {k: np.asarray(v) for k, v in out.items()}
    return out, SimpleNamespace(**{k: np.asarray(getattr(info, k))
                                   for k in ("numops", "numiter", "converged")})


def test_sharded_batched_gmres_matches_jax_vmap(ranks):
    """GMRES on ``(I + L) x = b`` for 4 right-hand sides, the graft entry's
    problem, through ``linsolve_gmres_batched``."""
    out = _case(ranks, "gmres")
    want, info = _jax_solve("gmres")
    np.testing.assert_allclose(out["X"], want["X"], rtol=0, atol=TOL)
    _counts_equal(out, info)
    _against_one_problem(out)
    assert out["collectives"][0] < out["one_problem_collectives"][0]


@pytest.mark.parametrize("name", chip_smoke.SHARDED_BATCHED_TREE)
def test_sharded_batched_tree_matches_jax_vmap(ranks, name):
    """Pytree vectors on a sharded space: a ``(p, q)`` tuple a problem and
    the coupled map ``(p, q) ↦ (L p + q/2, L q + p/2)`` of
    ``sharded_laplacian_1d``, through batched CG, GMRES and Lanczos, against
    ``jax.vmap`` of the GSPMD tree solve; each problem its one-problem
    sharded tree solve bit for bit, and the batch's all-reduces fewer than
    the one-problem loop's (the space's reductions are shared, the map's
    halo rounds are each problem's)."""
    out = _case(ranks, name)
    want, info = _jax_solve(name)
    for key, w in want.items():
        np.testing.assert_allclose(out[key], w, rtol=0, atol=TOL)
    _counts_equal(out, info)
    _against_one_problem(out)
    assert out["collectives"][0] < out["one_problem_collectives"][0]


@pytest.mark.parametrize("name", ["cg", "minres", "bicgstab"])
def test_sharded_batched_linear_matches_jax_vmap(ranks, name):
    """CG on ``(0.5 + L) x = b`` (``sharded_laplacian_1d``), MINRES on the
    sharded ELL SPD matrix, BiCGStab on ``(1 + T) x = b`` with ``T`` the
    sharded non-symmetric tridiagonal."""
    out = _case(ranks, name)
    want, info = _jax_solve(name)
    np.testing.assert_allclose(out["X"], want["X"], rtol=0, atol=TOL)
    _counts_equal(out, info)
    _against_one_problem(out)


@pytest.mark.parametrize("key", ["laplacian", "ell", "chain", "grid"])
def test_sharded_stack_apply_is_the_row_apply_in_one_all_reduce(ranks, key):
    """Each sharded operator's ``normal_stack``/``adjoint_stack`` gives every
    row the bits of its one-vector apply, in one all-reduce for the stack,
    and equals the global apply."""
    out = _case(ranks, "stack_apply")
    for side in ("normal", "adjoint"):
        assert out[f"{key}_{side}_equal"]
        assert out[f"{key}_{side}_collectives"] == 1
    if key == "chain":
        X = chip_smoke.sharded_batched_problem(np, "lanczos_fused")["X"]
        op = kk.StencilOperator((-200, 0, 200), (0.3, 1.0, -0.4))
        import jax.numpy as jnp

        for side in ("normal", "adjoint"):
            want = np.stack([np.asarray(getattr(op, side)(jnp.asarray(x))) for x in X])
            np.testing.assert_allclose(out[f"chain_{side}"], want, rtol=0, atol=1e-5)
    if key == "laplacian":
        X = chip_smoke.sharded_batched_problem(np, "lanczos_ell")["X"]
        n = X.shape[1]
        L = 2 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)
        np.testing.assert_allclose(out["laplacian_normal"], X @ L.T, rtol=0, atol=1e-12)


# --------------------------------------------------------------------------
# in this process: the batched K1 twin with halos, the lock-step's
# collectives, the refusals
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
@pytest.mark.parametrize("Bs,with_drift", [((3, 3, 3), False), ((5, 2, 7), True)])
def test_glued_batched_k1_twin_with_halos_equals_unsharded(kind, Bs, with_drift):
    """The batched step's plain version on each rank's block with every
    problem's external halos, glued, is the unsharded batched step: ``w'``
    and ``y'`` within float rounding, the partial reductions summing to the
    whole, the rows other than ``kp1`` untouched; each problem is its
    one-problem step with its halos, bit for bit."""
    if kind == "chain":
        op = kt.StencilOperator((-200, 0, 200), (0.3, 1.0, -0.4))  # h = 2
    else:
        op = kt.GridStencilOperator((64, 256), ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)),
                                    (4.0, -1.0, -1.0, -1.0, -1.0))  # h = 2
    spec = tfl.spec_for(op)
    Pn, kmax, R = len(Bs), 9, 128
    gen = torch.Generator().manual_seed(97 + sum(Bs))
    V = torch.randn((Pn, kmax, R, 128), generator=gen)
    y = torch.randn((Pn, R, 128), generator=gen)
    g = torch.randn((Pn, kmax + 1), generator=gen)
    kp1 = [max(b, 1) for b in Bs]
    Vg = V.clone()
    yg, rawg = tfl.fused_step_batched(Vg, y, g, kp1, list(Bs), spec, with_drift)
    Vb, Vh = _split_with_halos(V, WORLD, spec.h)
    yb, yh = _split_with_halos(y, WORLD, spec.h)
    ys, raws = [], []
    for d in range(WORLD):
        yn, raw = tfl.fused_step_batched(Vb[d], yb[d], g, kp1, list(Bs), spec, with_drift,
                                         Vext=Vh[d], yext=yh[d])
        ys.append(yn)
        raws.append(raw)
        for p in range(Pn):
            V1 = _split_with_halos(V, WORLD, spec.h)[0][d][p]
            y1, r1 = tfl.fused_step(V1, yb[d][p], g[p], kp1[p], Bs[p], spec, with_drift,
                                    Vext=Vh[d][p], yext=yh[d][p])
            assert torch.equal(y1, yn[p]) and torch.equal(V1[kp1[p]], Vb[d][p, kp1[p]])
            assert torch.equal(r1, raw[p, :r1.numel()])
    scale = float(yg.abs().max())
    np.testing.assert_allclose(torch.cat(ys, dim=1).numpy(), yg.numpy(), rtol=0,
                               atol=1e-6 * scale)
    for p in range(Pn):
        np.testing.assert_allclose(torch.cat([v[p, kp1[p]] for v in Vb]).numpy(),
                                   Vg[p, kp1[p]].numpy(), rtol=0, atol=1e-6 * scale)
        keep = [j for j in range(kmax) if j != kp1[p]]
        for d in range(WORLD):
            assert torch.equal(Vb[d][p, keep], _split_with_halos(V, WORLD, spec.h)[0][d][p, keep])
    np.testing.assert_allclose(sum(raws).numpy(), rawg.numpy(), rtol=1e-5,
                               atol=1e-5 * float(rawg.abs().max()))


def test_batched_k1_halo_rules():
    spec = tfl.spec_for(kt.laplacian_1d(4096, device="cpu"))
    V = torch.zeros((2, 5, 16, 128))
    y, g = torch.zeros((2, 16, 128)), torch.zeros((2, 6))
    with pytest.raises(ValueError, match="both external halos"):
        tfl.fused_step_batched(V, y, g, 1, 1, spec, Vext=torch.zeros((2, 5, 2, 1, 128)))
    with pytest.raises(ValueError, match="halos"):
        tfl.fused_step_batched(V, y, g, 1, 1, spec, Vext=torch.zeros((5, 2, 1, 128)),
                               yext=torch.zeros((2, 1, 128)))


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
    """A mesh of one axis (``sharded_laplacian_1d`` asks ``mesh.axis``)."""

    def __init__(self, ax):
        self.ax = ax

    def axis(self, name):
        return self.ax


def _two_rank_space():
    return VectorSpace(psum_axis=MeshAxis("vec", None, 2, 0))


def test_fused_lock_step_is_one_all_reduce_for_all_problems(fake_collectives):
    """A fused batched lock-step on a sharded space makes exactly one
    all-reduce on the ``vec`` axis for every stepping problem (the
    one-problem stepper makes one a problem); prime and tail make one each
    collective kind for all."""
    space = _two_rank_space()
    op = kt.parallel.shard_local_stencil(kt.laplacian_1d(1 << 13, device="cpu"), space.psum_axis)
    kmax, Pn = 9, 3
    gen = torch.Generator().manual_seed(5)
    V = torch.zeros((Pn, kmax, 32, 128))
    V[:, 0] = torch.randn((Pn, 32, 128), generator=gen)
    Y = torch.empty((Pn, 32, 128))
    prime, advance, tail = tkf.make_fused_stepper_batched(op, kmax, True, space)
    scs = {p: tkf.fused_scales_init(kmax) for p in range(Pn)}
    tcol.reset_stats()
    carries = prime(V, Y, {p: 0 for p in range(Pn)}, scs, list(range(Pn)))
    assert tcol.stats["collectives"] == 3  # the stack apply, the projections, the edges
    for step in range(3):
        tcol.reset_stats()
        Y, outs = advance(V, Y, carries, list(range(Pn)))
        assert tcol.stats["collectives"] == 1, step
        carries = {p: outs[p][0] for p in range(Pn)}
    tcol.reset_stats()
    tail(carries, {p: True for p in range(Pn)})
    assert tcol.stats["collectives"] == 1
    # the one-problem stepper: one all-reduce a step for each problem
    prime1, advance1, _ = tkf.make_fused_stepper(op, kmax, True, space)
    tcol.reset_stats()
    for p in range(Pn):
        advance1(prime1(V[p].clone(), 0, tkf.fused_scales_init(kmax)))
    assert tcol.stats["collectives"] == Pn * 4  # per problem: apply, project, edges, step


@pytest.mark.parametrize("orth", ["cgs", "cgs2"])
def test_unfused_lock_step_collectives_do_not_grow_with_problems(fake_collectives, orth):
    """An unfused batched Lanczos step on a sharded space (a stack apply,
    the 3-term ``α``, the drift sweep, the norms) makes as many all-reduces
    for three problems as for one."""
    space = _two_rank_space()
    op = kt.parallel.sharded_laplacian_1d(256, _AxisMesh(space.psum_axis))
    made = {}
    for Pn in (1, 3):
        from krylovkit_tpu_torch.solvers.batched import _Operators

        ops = _Operators(op, Pn, False)
        gen = torch.Generator().manual_seed(6)
        states = {}
        for p in range(Pn):
            st = tkf.initialize(torch.randn(128, generator=gen, dtype=torch.float64), 5,
                                torch.float64, space)
            states[p] = tkf.expand_hermitian(op.normal, st, ton.cgs, space)
        tcol.reset_stats()
        tkf.expand_batched(ops, states, getattr(ton, orth), space, hermitian=True)
        made[Pn] = tcol.stats["collectives"]
    assert made[1] == made[3] == (4 if orth == "cgs2" else 3)


def test_tree_lock_step_all_reduces_once_a_kind_for_all_problems_and_leaves(fake_collectives):
    """An unfused batched Lanczos lock-step on ``(p, q)`` tuple vectors on a
    sharded space (the cgs2 sweeps, the 3-term ``α``, the norms) makes, kind
    by kind, as many all-reduces for three problems of two leaves as for
    one problem of one tensor leaf: each reduction sums a row's leaf
    partials before its one all-reduce for all rows.  The tree map here is
    local, so every all-reduce counted is the space's."""
    from krylovkit_tpu_torch.solvers.batched import _Operators

    space = _two_rank_space()
    made = {}
    for key, Pn, tree in (("tensor", 1, False), ("tree_one", 1, True), ("tree", 3, True)):
        if tree:
            op = kt.as_operator(lambda v: (2.0 * v[0] + 0.5 * v[1], 3.0 * v[1] + 0.5 * v[0]))
        else:
            op = kt.as_operator(lambda v: 2.0 * v)
        ops = _Operators(op, Pn, False)
        gen = torch.Generator().manual_seed(7)
        states = {}
        for p in range(Pn):
            x = torch.randn(128, generator=gen, dtype=torch.float64)
            x = (x, torch.randn(128, generator=gen, dtype=torch.float64)) if tree else x
            st = tkf.initialize(x, 5, torch.float64, space)
            states[p] = tkf.expand_hermitian(op.normal, st, ton.cgs, space)
        with chip_smoke.CollectiveKinds() as kinds:
            tkf.expand_batched(ops, states, ton.cgs2, space, hermitian=True)
        made[key] = kinds.counts
    assert made["tree"] == made["tree_one"] == made["tensor"] and sum(made["tree"].values()) > 0


def test_edges_carry_a_stack_in_one_all_reduce(fake_collectives):
    """``MeshAxis.edges`` of a ``(P, h, 128)`` payload is one all-reduce of
    a ``(size, 2, P, h, 128)`` buffer."""
    ax = MeshAxis("vec", None, 2, 0)
    first, last = torch.ones((3, 2, 128)), 2 * torch.ones((3, 2, 128))
    tcol.reset_stats()
    above, below = ax.edges(first, last)
    assert tcol.stats["collectives"] == 1 and tcol.stats["bytes"] == 2 * 2 * 3 * 2 * 128 * 4
    assert above.shape == below.shape == (3, 2, 128)
    assert torch.equal(above, torch.zeros_like(above))  # rank 0: nothing above it


def _one_problem_call(driver, A, x, space, maxiter):
    """The one-problem front-end of ``driver`` on one problem's start."""
    if driver == "svdsolve_gkl_batched":
        return kt.svdsolve(A, x, 1, "LR", alg=kt.GKL(krylovdim=4, maxiter=maxiter), space=space)
    if driver == "lssolve_lsmr_batched":
        return kt.lssolve(A, x, alg=kt.LSMR(maxiter=maxiter), space=space)
    if driver == "geneigsolve_golubye_batched":
        return kt.geneigsolve((A, None), x, 1, "SR", alg=kt.GolubYe(krylovdim=4, maxiter=maxiter),
                              space=space)
    if driver == "bieigsolve_batched":
        return kt.bieigsolve(A, x, x, 1, "LM", alg=kt.BiArnoldi(krylovdim=4, maxiter=maxiter),
                             space=space)
    return kt.eigsolve(A, kt.Block([x]), 1, "LR",
                       alg=kt.BlockLanczos(krylovdim=4, maxiter=maxiter), space=space)


def _sharded_call(driver, A, X, space, eager=False, maxiter=None):
    """``driver`` on the operator ``A`` and the starts ``X`` (``(P, n)``; a
    block driver takes ``X[:, None]``, the two-sided one ``X`` on both
    sides) in ``space``; ``maxiter`` fixes the work where given."""
    kw = {} if maxiter is None else {"maxiter": maxiter}
    if driver == "svdsolve_gkl_batched":
        return kt.svdsolve_gkl_batched(A, X, 1, "LR", kt.GKL(krylovdim=4, eager=eager, **kw),
                                       space)
    if driver == "lssolve_lsmr_batched":
        return kt.lssolve_lsmr_batched(A, X, kt.LSMR(**kw), 0.0, space)
    if driver == "geneigsolve_golubye_batched":
        return kt.geneigsolve_golubye_batched(A, None, X, 1, "SR", kt.GolubYe(krylovdim=4, **kw),
                                              space)
    if driver == "bieigsolve_batched":
        return kt.bieigsolve_batched(A, X, X, 1, "LM",
                                     kt.BiArnoldi(krylovdim=4, eager=eager, **kw), space)
    blocks = X[:, None] if isinstance(X, torch.Tensor) else {k: v[:, None] for k, v in X.items()}
    return kt.eigsolve_blocklanczos_batched(A, blocks, 1, "LR",
                                            kt.BlockLanczos(krylovdim=4, **kw), space)


@pytest.mark.parametrize("driver", ["svdsolve_gkl_batched", "lssolve_lsmr_batched",
                                    "geneigsolve_golubye_batched", "bieigsolve_batched",
                                    "eigsolve_blocklanczos_batched"])
def test_drivers_on_a_sharded_space_refuse_what_they_do_not_batch(driver):
    """The GKL, LSMR, Golub-Ye, BiArnoldi and Block Lanczos batched drivers
    take a sharded space; those with no differentiation rule refuse, each
    naming itself, a start that requires grad there with the message they
    give on an unsharded space, and GKL differentiates (a start that
    requires grad: no gradient to it, the solve's bits); on a one-rank axis
    a sharded solve is the unsharded one, bit for bit, and so is each
    problem of a dict batch its one-problem sharded dict solve; (GKL,
    BiArnoldi) so is an ``eager=True`` solve."""
    from krylovkit_tpu_torch.ops.vector import tree_leaves, tree_row

    space = VectorSpace(psum_axis=MeshAxis("vec", None, 1, 0))
    A = torch.diag(torch.linspace(1.0, 2.0, 8, dtype=torch.float64))
    X = torch.ones((2, 8), dtype=torch.float64) + torch.arange(8.0, dtype=torch.float64) / 8
    if driver == "svdsolve_gkl_batched":
        Xg = X.clone().requires_grad_(True)
        got = _sharded_call(driver, A, Xg, space)
        got[0].sum().backward()
        assert got[0].requires_grad and Xg.grad is None
        assert torch.equal(got[0].detach(), _sharded_call(driver, A, X, VectorSpace())[0])
    else:
        for sp in (space, VectorSpace()):
            with pytest.raises(ValueError, match=f"{driver}: differentiation has no rule"):
                _sharded_call(driver, A, X.clone().requires_grad_(True), sp)
    got = _sharded_call(driver, A, X, space)
    want = _sharded_call(driver, A, X, VectorSpace())
    assert torch.equal(got[0], want[0])
    # a dict batch: each problem its one-problem sharded dict solve (two
    # iterations: fixed work)
    dpair = (lambda x: {"a": A @ x["a"]}, lambda y: {"a": A.T @ y["a"]})
    got = _sharded_call(driver, dpair, {"a": X}, space, maxiter=2)
    for p in range(2):
        one = _one_problem_call(driver, dpair, {"a": X[p]}, space, 2)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tree_row(got[0], p)),
                                                      tree_leaves(one[0])))
    if driver in ("svdsolve_gkl_batched", "bieigsolve_batched"):
        got = _sharded_call(driver, A, X, space, eager=True)
        want = _sharded_call(driver, A, X, VectorSpace(), eager=True)
        assert torch.equal(got[0], want[0])


_UNFIT_BLOCKS = {
    # a chain reaching 16 rows of 128 over blocks of 8 rows
    "short_block": (lambda: kt.StencilOperator((-2000, 0, 2000), (-1.0, 2.0, -1.0)), 8,
                    "shorter than the stencil's reach"),
    # a grid of rows of 256 over blocks of 17 rows of 128
    "split_grid_row": (lambda: kt.parallel.poisson_2d(68, 256, device="cpu"), 17,
                       "whole grid rows"),
}


@pytest.mark.parametrize("driver", ["eigsolve_lanczos_batched", "linsolve_gmres_batched",
                                    "schursolve_batched", "exponentiate_batched"])
@pytest.mark.parametrize("rule", sorted(_UNFIT_BLOCKS))
def test_sharded_block_batched_k1_cannot_take_is_refused(driver, rule):
    """A batched solve on a sharded space that meets a fusable stencil and a
    block the fused step's halos cannot serve raises, naming the driver and
    the rule, and never steps on without a word."""
    make_op, R, why = _UNFIT_BLOCKS[rule]
    op = make_op()
    space = VectorSpace(psum_axis=MeshAxis("vec", None, 1, 0))
    X = torch.ones((2, R, 128), dtype=torch.float32)
    calls = {
        "eigsolve_lanczos_batched": lambda: kt.eigsolve_lanczos_batched(
            op, X, 1, "SR", kt.Lanczos(), space),
        "linsolve_gmres_batched": lambda: kt.linsolve_gmres_batched(
            op, X, torch.zeros_like(X), 0.0, 1.0, kt.GMRES(), space),
        "schursolve_batched": lambda: kt.schursolve_batched(op, X, 1, "LM", kt.Arnoldi(), space),
        "exponentiate_batched": lambda: kt.exponentiate_batched(op, 0.1, X, kt.Lanczos(),
                                                                space),
    }
    # exponentiate_batched is expintegrator_batched with one vector
    named = {"exponentiate_batched": "expintegrator_batched"}.get(driver, driver)
    with pytest.raises(ValueError, match=f"{named}: on a sharded space .*{why}"):
        calls[driver]()


def test_sharded_ell_stack_apply_keeps_autograd(fake_collectives):
    """The sharded ELL operator's stack applies keep the derivative of its
    one-vector applies (through the halo exchange's ``_Exchanged``), row
    for row: a stack apply never drops a gradient."""
    ax = MeshAxis("vec", None, 2, 0)
    mesh = _AxisMesh(ax)
    mesh.device = torch.device("cpu")
    n = 64
    rows, cols, vals = _crossing_coo(n)
    op = kt.parallel.sharded_ell_from_coo(rows, cols, vals, (n, n), mesh)
    gen = torch.Generator().manual_seed(9)
    X = torch.randn((3, n // 2), generator=gen, dtype=torch.float64, requires_grad=True)
    W = torch.randn((3, n // 2), generator=gen, dtype=torch.float64)
    for stack, one in ((op.normal_stack, op.normal), (op.adjoint_stack, op.adjoint)):
        (g,) = torch.autograd.grad(torch.sum(W * stack(X)), X)
        want = torch.stack([torch.autograd.grad(torch.sum(w * one(x)), x)[0]
                            for w, x in zip(W, X.detach().clone().requires_grad_())])
        assert torch.equal(g, want)
        assert bool(torch.any(g != 0))


def _crossing_coo(n):
    """A non-symmetric banded ``n × n`` matrix with entries that cross the
    block edge, as COO triplets."""
    i = np.arange(n)
    r = np.concatenate([i, i[:-3], i[3:]])
    c = np.concatenate([i, i[:-3] + 3, i[3:] - 3])
    v = np.concatenate([np.full(n, 2.0), np.full(n - 3, -0.7), np.full(n - 3, 0.4)])
    return r, c, v
