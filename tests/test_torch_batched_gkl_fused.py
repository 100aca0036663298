"""PyTorch port: the fused and the projection routes of the batched GKL
``svdsolve`` (``solvers/batched_gkl.py``, ``factorizations/gkl.py:
fused_expansions_batched`` and ``expand_batched``) on float32 ``(R, 128)``
vectors, and the plain batched K1 on the adjoint grid spec.

* The fused route on a 32 × 128 advection grid stencil against
  ``jax.jit(jax.vmap(svdsolve_gkl))`` with the JAX fused kernels in
  interpret mode (``krylovkit_tpu.factorizations.krylov.fused_interpret``),
  one vmapped solve (about 10 s on one worker): counts exactly equal,
  singular values within 1e-4 relative (float32, two roundings of the same
  recurrence), and each problem bit for bit against the port's one-problem
  fused solve (which ``tests/test_torch_gkl.py`` holds against the JAX
  package).
* Keeps that differ (the non-symmetric chain, "LR", tol 3e-3: one problem
  restarts from another ``keep`` than the others), so a half-step holds two
  live-row counts: every problem bit-identical to its one-problem solve,
  one batched K1 launch per count.
* The unfused route with ``ops.basis.use_pallas_projections`` on (a
  callable pair, cgs2): one batched K5 and one batched K6 plain launch a
  half-step for every stepping problem, each problem bit-identical.
* The plain batched K1 (``fused_step_batched_reference``) with the grid
  adjoint spec and drift at ``B = 0`` and at mixed ``B``: each row equal to
  the one-problem plain step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krylovkit_tpu import GKL as JGKL
from krylovkit_tpu.factorizations import krylov as jkf
from krylovkit_tpu.ops.operator import GridStencilOperator as JGrid
from krylovkit_tpu.solvers.svdsolve import svdsolve_gkl as j_svdsolve_gkl
import krylovkit_tpu_torch as kt
from krylovkit_tpu_torch import convert
from krylovkit_tpu_torch.factorizations import gkl as tgf
from krylovkit_tpu_torch.ops import basis as bs
from krylovkit_tpu_torch.ops import fused_lanczos as fl
from krylovkit_tpu_torch.ops import projections as pb
from krylovkit_tpu_torch.ops.operator import as_operator
from krylovkit_tpu_torch.solvers.svdsolve import svdsolve_gkl as t_svdsolve_gkl

torch.set_num_threads(2)

GRID = ((32, 128), ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)), (4.0, -1.5, -0.5, -1.2, -0.8))
CHAIN = ((-2, 0, 1), (0.4, 1.0, -0.8))  # non-symmetric
P = 3


def _starts(seed=20):
    return np.stack([np.random.default_rng(seed + i).standard_normal((32, 128))
                     for i in range(P)]).astype(np.float32)


def _counts(info):
    return [np.asarray(info.numops).tolist(), np.asarray(info.numiter).tolist(),
            np.asarray(info.converged).tolist()]


class _Launches:
    """Records the plain batched K1 calls (their ``active`` problems and
    live rows) of ``factorizations/gkl.py``."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        self.real = tgf.fl.fused_step_batched

        def rec(V, y, g, kp1, B, spec, with_drift=False, active=None, ynext=None):
            self.calls.append(sorted({B[p] for p in active}))
            return self.real(V, y, g, kp1, B, spec, with_drift, active, ynext)

        tgf.fl.fused_step_batched = rec
        return self

    def __exit__(self, *exc):
        tgf.fl.fused_step_batched = self.real


def _one_problem_bits(op, X, howmany, which, alg, S, U, W, it):
    for p in range(X.shape[0]):
        S1, U1, W1, i1 = t_svdsolve_gkl(as_operator(op), X[p], howmany, which, alg)
        assert [i1.numops, i1.numiter, i1.converged] == [c[p] for c in _counts(it)]
        assert torch.equal(S[p], S1) and torch.equal(U[p], U1) and torch.equal(W[p], W1)
        assert torch.equal(it.residual[p], i1.residual) and torch.equal(it.normres[p], i1.normres)


def test_fused_batched_svdsolve_matches_jax_vmap_and_one_problem_bits():
    """The fused route on the grid stencil (6 rounds of krylovdim 16, no
    value converges: fixed work): counts equal to the JAX package's vmapped
    fused solve, values within 1e-4 relative, each problem bit-identical to
    the port's one-problem fused solve; every half-step one batched K1
    launch at one live-row count, the first domain half-step at ``B = 0``,
    both specs."""
    X = _starts()
    jalg = JGKL(krylovdim=16, maxiter=6, tol=3e-5, verbosity=0)
    old = jkf.fused_interpret
    jkf.fused_interpret = True
    try:
        f = jax.jit(jax.vmap(lambda x: j_svdsolve_gkl(JGrid(*GRID), x, 4, "LR", jalg)))
        Sj, _, _, ij = f(jnp.asarray(X))
        Sj = np.asarray(Sj)
    finally:
        jkf.fused_interpret = old
    op = convert.grid_stencil_from_arrays(*GRID, device="cpu")
    talg = convert.gkl_from_dict({**dataclasses.asdict(jalg), "orth": "cgs2"})
    Xt = torch.from_numpy(X)
    with _Launches() as rec:
        S, U, W, it = kt.svdsolve_gkl_batched(op, Xt, 4, "LR", talg)
    assert _counts(it) == _counts(ij) == [[102] * P, [6] * P, [0] * P]
    np.testing.assert_allclose(S.numpy(), Sj, rtol=1e-4)
    assert all(len(c) == 1 for c in rec.calls) and [0] in rec.calls
    # K1 = numops − 2·numiter: every half-step but the two of a round's tail
    assert len(rec.calls) == 102 - 2 * 6
    _one_problem_bits(op, Xt, 4, "LR", talg, S, U, W, it)


def test_fused_batched_keeps_that_differ_stay_bit_identical():
    """Problems that restart from different ``keep`` step at different live
    rows after the restart: a half-step then launches once per count, and
    every problem stays bit-identical to its one-problem fused solve."""
    op = convert.stencil_from_arrays(*CHAIN, device="cpu")
    Xt = torch.from_numpy(_starts())
    alg = kt.GKL(krylovdim=16, maxiter=8, tol=3e-3, verbosity=0)
    with _Launches() as rec:
        S, U, W, it = kt.svdsolve_gkl_batched(op, Xt, 3, "LR", alg)
    numops, numiter, _ = _counts(it)
    assert len(set(numops)) > 1, _counts(it)
    assert all(len(c) == 1 for c in rec.calls)  # one live-row count a launch
    # in step with one count a half-step, the launches would be the largest
    # one-problem count (numops − 2·numiter); keeps that differ add launches
    assert len(rec.calls) > max(o - 2 * i for o, i in zip(numops, numiter))
    _one_problem_bits(op, Xt, 3, "LR", alg, S, U, W, it)


def test_unfused_batched_svdsolve_with_projection_flag_on():
    """A callable pair (unfused, cgs2) with the projection flag on: each
    half-step one batched project and one batched unproject plain launch
    for every stepping problem (two a step, one step a ``numops`` pair), and
    each problem bit-identical to its one-problem solve (which launches the
    one-problem K5/K6 plain versions)."""
    g = convert.grid_stencil_from_arrays(*GRID, device="cpu")
    pair = (g.normal, g.adjoint)
    Xt = torch.from_numpy(_starts(30))
    alg = kt.GKL(krylovdim=12, maxiter=3, tol=1e-30, verbosity=0)
    calls = {"project": 0, "unproject": 0}
    real_p, real_u = pb.project_pallas_batched, pb.unproject_pallas_batched

    def count(name, fn):
        def wrapped(Vs, xs, ks):
            calls[name] += 1
            assert len(Vs) == P
            return fn(Vs, xs, ks)
        return wrapped

    bs.use_pallas_projections = True
    pb.project_pallas_batched = count("project", real_p)
    pb.unproject_pallas_batched = count("unproject", real_u)
    try:
        S, U, W, it = kt.svdsolve_gkl_batched(pair, Xt, 3, "LR", alg)
        pb.project_pallas_batched, pb.unproject_pallas_batched = real_p, real_u
        _one_problem_bits(pair, Xt, 3, "LR", alg, S, U, W, it)
    finally:
        bs.use_pallas_projections = False
        pb.project_pallas_batched, pb.unproject_pallas_batched = real_p, real_u
    # keep (3·12)//5 = 7: 2·(12 + 5 + 5) applies in 3 rounds
    assert _counts(it)[:2] == [[44] * P, [3] * P]
    assert calls["project"] == calls["unproject"] == 44


@pytest.mark.parametrize("Bs", [[0, 0, 0], [0, 7, 3], [5, 0, 5]])
def test_plain_batched_step_on_the_adjoint_grid_spec(Bs):
    """The plain batched K1 on the grid's adjoint spec with drift, at ``B =
    0`` and at mixed ``B`` (``kp1 = B``): each row equal to the one-problem
    plain step, bit for bit (rows other than ``kp1`` untouched)."""
    op = convert.grid_stencil_from_arrays(*GRID, device="cpu")
    spec = fl.adjoint_spec(op)
    gen = torch.Generator().manual_seed(3)
    V = torch.randn((P, 9, 32, 128), generator=gen)
    y = torch.randn((P, 32, 128), generator=gen)
    g = torch.randn((P, 10), generator=gen)
    Vb = V.clone()
    yb, raw = fl.fused_step_batched(Vb, y, g, Bs, Bs, spec, with_drift=True)
    for p in range(P):
        V1 = V[p].clone()
        y1, r1 = fl.fused_step(V1, y[p], g[p], Bs[p], Bs[p], spec, with_drift=True)
        assert torch.equal(V1, Vb[p]) and torch.equal(y1, yb[p])
        assert torch.equal(r1, raw[p, :r1.numel()]) and not raw[p, r1.numel():].any()
