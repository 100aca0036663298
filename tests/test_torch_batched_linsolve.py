"""PyTorch port: batched CG, MINRES and BiCGStab
(``solvers/batched_linsolve.py``) against ``jax.jit(jax.vmap(...))`` of the
JAX package's ``linsolve_cg``, ``linsolve_minres`` and ``linsolve_bicgstab``
on the same numpy-seeded inputs, and each problem against the port's own
one-problem solve; the WARN lines; the refusals.  The plain batched K3/K4
and the operator routing are in ``tests/test_torch_batched_operators.py``.

The operators: a stack of matrices (one per problem), a shared banded
operator (the JAX side's XLA shift-and-add on the CPU, the port's batched
K3 plain version), a banded operator with per-problem planes (the JAX side
a ``BandedOperator`` built inside the vmapped function from a ``(P, nδ, R,
128)`` stack, the port a sequence of them), and ``laplacian_1d_pallas``
(the JAX side's Pallas kernel in interpret mode under ``vmap``).

Tolerances: counts exactly equal; float64 ``x`` within 1e-10 of its
largest entry and ``normres`` within 1e-10·‖b‖ of the JAX package's (a
converged residual norm is itself at the rounding level of ``b``, so it is
compared on that scale).  Against the port's one-problem solve each
problem is bit-identical on the banded and Laplacian operators (the same
elementwise arithmetic, each row's inner products reduced as one vector's,
the batched applies row by row the one-vector plain versions), and within
1e-12 on a matrix stack (one batched product).
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from batched_grad_specs import check_one_rank_axis
from krylovkit_tpu import CG as JCG
from krylovkit_tpu import MINRES as JMINRES
from krylovkit_tpu import BiCGStab as JBiCGStab
from krylovkit_tpu.ops.operator import MatrixOperator as JMatrixOperator
from krylovkit_tpu.ops.pallas_spmv import BandedOperator as JBandedOperator
from krylovkit_tpu.ops.pallas_spmv import banded_from_coo as j_banded_from_coo
from krylovkit_tpu.ops.pallas_stencil import laplacian_1d_pallas as j_laplacian_1d_pallas
from krylovkit_tpu.solvers.bicgstab import linsolve_bicgstab as j_bicgstab
from krylovkit_tpu.solvers.cg import linsolve_cg as j_cg
from krylovkit_tpu.solvers.minres import linsolve_minres as j_minres
import krylovkit_tpu_torch as kt
from chip_smoke import poisson_coo
from krylovkit_tpu_torch import convert
from krylovkit_tpu_torch.ops.collectives import MeshAxis
from krylovkit_tpu_torch.solvers.bicgstab import linsolve_bicgstab as t_bicgstab
from krylovkit_tpu_torch.solvers.cg import linsolve_cg as t_cg
from krylovkit_tpu_torch.solvers.minres import linsolve_minres as t_minres

torch.set_num_threads(2)

P = 4
NX = 16  # the 16 × 16 Poisson grid: n = 256
N = NX * NX

DRIVERS = {
    "cg": (j_cg, JCG, t_cg, kt.linsolve_cg_batched, kt.CG),
    "minres": (j_minres, JMINRES, t_minres, kt.linsolve_minres_batched, kt.MINRES),
    "bicgstab": (j_bicgstab, JBiCGStab, t_bicgstab, kt.linsolve_bicgstab_batched, kt.BiCGStab),
}


def _counts(info):
    return [np.asarray(info.numops).tolist(), np.asarray(info.numiter).tolist(),
            np.asarray(info.converged).tolist()]


def _rhs(seed):
    """``P`` right-hand sides of different norms, so the problems stop at
    different steps."""
    rng = np.random.default_rng(seed)
    return np.stack([(1 + p) * rng.standard_normal(N) for p in range(P)])


def _matrices(driver, seed):
    """One matrix per problem: SPD for CG, symmetric indefinite (spectrum in
    ±[1, 3]) for MINRES, non-symmetric for BiCGStab."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(P):
        G = rng.standard_normal((N, N))
        if driver == "cg":
            A = G @ G.T / N + 0.5 * np.eye(N)
        elif driver == "minres":
            Q, _ = np.linalg.qr(G)
            lam = rng.uniform(1, 3, N) * np.where(np.arange(N) % 2 == 0, 1.0, -1.0)
            A = (Q * lam) @ Q.T
            A = (A + A.T) / 2
        else:
            A = 3 * np.eye(N) + G / np.sqrt(N)
        out.append(A)
    return np.stack(out)


def _case(driver, kind):
    """``(jax operator or stack, port operator, in_dims op axis, Bs, a0)``."""
    Bs = _rhs(10 + len(kind))
    if kind == "matrix":
        As = _matrices(driver, 20)
        return jnp.asarray(As), convert.matrices_from_numpy(As, "cpu"), 0, Bs, 0.0
    rows, cols, vals = poisson_coo(np, NX, np.float64)
    if kind == "banded":
        jop = j_banded_from_coo(rows, cols, vals, N)
        top = kt.banded_from_coo(rows, cols, vals, N, device="cpu")
        return jop, top, None, Bs, 0.5
    if kind == "diags":
        base = np.asarray(j_banded_from_coo(rows, cols, vals, N, with_adjoint=False).diags)
        D = np.stack([base * (1 + 0.1 * p) for p in range(P)])
        offsets = j_banded_from_coo(rows, cols, vals, N).offsets
        return (offsets, jnp.asarray(D)), convert.banded_batch_from_arrays(offsets, D, N, "cpu"), \
            0, Bs, 0.5
    # the 1-D Laplacian of n = 256: BiCGStab with a0 = 0.5
    return j_laplacian_1d_pallas(N, jnp.float64, interpret=True), \
        kt.laplacian_1d_pallas(N, torch.float64, device="cpu"), None, Bs, 0.5


def _jax_vmap(driver, kind, jop, Bs, a0, jalg):
    jsolve = DRIVERS[driver][0]
    Bj = jnp.asarray(Bs)

    def solve(A, b):
        return jsolve(A, b, jnp.zeros_like(b), jnp.asarray(a0, b.dtype), jnp.asarray(1.0, b.dtype),
                      jalg)

    if kind == "matrix":
        return jax.jit(jax.vmap(lambda A, b: solve(JMatrixOperator(A), b)))(jop, Bj)
    if kind == "diags":
        offsets, D = jop
        return jax.jit(jax.vmap(lambda d, b: solve(JBandedOperator(offsets, d, N), b)))(D, Bj)
    return jax.jit(jax.vmap(lambda b: solve(jop, b)))(Bj)


CASES = [(d, k) for d in ("cg", "minres", "bicgstab") for k in ("matrix", "banded", "diags")] + [
    ("bicgstab", "laplacian")]


@pytest.mark.parametrize("driver,kind", CASES)
def test_batched_linsolve_matches_jax_vmap_and_one_problem_solves(driver, kind):
    """Counts equal to ``jax.jit(jax.vmap(...))`` of the JAX driver, ``x``
    and ``normres`` within 1e-10 (module docstring); each problem's counts
    equal to the port's one-problem solve, its ``x``, ``normres`` and
    residual bit-identical (within 1e-12 on matrices)."""
    _, jcls, tone, tbatched, tcls = DRIVERS[driver]
    jop, top, op_dim, Bs, a0 = _case(driver, kind)
    tol, maxiter = 1e-9, 400
    jx, jinfo = _jax_vmap(driver, kind, jop, Bs, a0, jcls(tol=tol, maxiter=maxiter))
    B = torch.from_numpy(Bs)
    alg = tcls(tol=tol, maxiter=maxiter)
    x, info = tbatched(top, B, torch.zeros_like(B), a0, 1.0, alg, in_dims=(op_dim, 0, 0))
    assert _counts(info) == _counts(jinfo)
    assert info.converged.tolist() == [1] * P
    assert len(set(info.numops.tolist())) > 1, info.numops  # the problems stop apart
    assert x.shape == B.shape and info.residual.shape == B.shape and info.normres.shape == (P,)
    assert info.numops.dtype == torch.int64
    jxn = np.asarray(jx)
    np.testing.assert_allclose(x.numpy(), jxn, rtol=0, atol=1e-10 * np.abs(jxn).max())
    bnorm = np.linalg.norm(Bs, axis=1)
    np.testing.assert_array_less(np.abs(info.normres.numpy() - np.asarray(jinfo.normres)),
                                 1e-10 * bnorm)
    for p in range(P):
        op = top[p] if op_dim == 0 else top
        x1, i1 = tone(op, B[p], torch.zeros_like(B[p]), a0, 1.0, alg)
        assert [i1.numops, i1.numiter, i1.converged] == [
            int(info.numops[p]), int(info.numiter[p]), int(info.converged[p])]
        if kind != "matrix":
            assert torch.equal(x[p], x1) and torch.equal(info.residual[p], i1.residual)
            assert torch.equal(info.normres[p], i1.normres)
            continue
        sc = float(x1.abs().max())
        np.testing.assert_allclose(x[p].numpy(), x1.numpy(), rtol=0, atol=1e-12 * sc)
        assert abs(float(info.normres[p]) - float(i1.normres)) <= 1e-12 * bnorm[p]
        np.testing.assert_allclose(info.residual[p].numpy(), i1.residual.numpy(), rtol=0,
                                   atol=1e-12 * float(B[p].abs().max()))


def test_problems_that_start_converged_stay_frozen():
    """A problem whose start is already within ``tol`` never steps: its
    ``x`` is its start bit for bit, counts 1 / 0 (MINRES 2 / 0 with the
    final residual), while the others solve as their one-problem solves, bit
    for bit; a shared ``b`` and per-problem starts (``in_dims`` ``(None,
    None, 0)``) also batch."""
    rows, cols, vals = poisson_coo(np, NX, np.float64)
    top = kt.banded_from_coo(rows, cols, vals, N, device="cpu")
    b = torch.from_numpy(np.random.default_rng(3).standard_normal(N))
    X0 = torch.zeros(3, N, dtype=torch.float64)
    x1, _ = t_cg(top, b, torch.zeros(N, dtype=torch.float64), 0.5, 1.0, kt.CG(tol=1e-12))
    X0[1] = x1  # already solved
    for name, want in (("cg", 1), ("minres", 2), ("bicgstab", 1)):
        _, _, tone, tbatched, tcls = DRIVERS[name]
        alg = tcls(tol=1e-6, maxiter=400)
        x, info = tbatched(top, b, X0, 0.5, 1.0, alg, in_dims=(None, None, 0))
        assert torch.equal(x[1], X0[1])
        assert [int(info.numops[1]), int(info.numiter[1]), int(info.converged[1])] == [want, 0, 1]
        for p in (0, 2):
            xp, ip = tone(top, b, X0[p], 0.5, 1.0, alg)
            assert [ip.numops, ip.numiter] == [int(info.numops[p]), int(info.numiter[p])]
            assert torch.equal(x[p], xp)


def test_sequence_of_stencil_operators_applies_per_problem():
    """A sequence of operators that do not batch (stencils with other
    coefficients) applies problem by problem, each problem bit-identical to
    its one-problem solve (a sequence of non-matrix operators used to raise
    ``AttributeError`` in the batched operator's set-up)."""
    ops = [kt.StencilOperator((-1, 0, 1), (-1.0, 2.0 + 0.5 * p, -1.0)) for p in range(3)]
    B = torch.from_numpy(np.random.default_rng(4).standard_normal((3, N)))
    alg = kt.CG(tol=1e-10, maxiter=300)
    x, info = kt.linsolve_cg_batched(ops, B, torch.zeros_like(B), 0.0, 1.0, alg,
                                     in_dims=(0, 0, 0))
    for p in range(3):
        x1, i1 = t_cg(ops[p], B[p], torch.zeros_like(B[p]), 0.0, 1.0, alg)
        assert [i1.numops, i1.numiter] == [int(info.numops[p]), int(info.numiter[p])]
        assert torch.equal(x[p], x1)


def test_batched_cg_warn_lines_match_jax_vmap():
    """At WARN, one line per unconverged problem with the one-problem text
    (residual norms within 1e-6 relative; the JAX package's vmapped
    callbacks need not print in problem order, so the lines are compared in
    the order of their residual norms); the port prints them in problem
    order."""
    rows, cols, vals = poisson_coo(np, NX, np.float64)
    jop = j_banded_from_coo(rows, cols, vals, N)
    top = kt.banded_from_coo(rows, cols, vals, N, device="cpu")
    Bs = _rhs(30)
    Bs[0] = 0.0
    Bs[0, 0] = 1e-12  # within tolerance at the start: converged

    def capture(fn):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            fn()
            jax.effects_barrier()
        return [line for line in buf.getvalue().splitlines() if line.strip()]

    jlines = capture(lambda: np.asarray(_jax_vmap("cg", "banded", jop, Bs, 0.5, JCG(
        tol=1e-10, maxiter=5, verbosity=1))[0]))
    B = torch.from_numpy(Bs)
    tlines = capture(lambda: kt.linsolve_cg_batched(
        top, B, torch.zeros_like(B), 0.5, 1.0, kt.CG(tol=1e-10, maxiter=5, verbosity=1)))
    assert len(tlines) == len(jlines) == P - 1

    def parts(lines):
        return sorted((float(line.split("normres = ")[1]), line.split("normres = ")[0])
                      for line in lines)

    tparts, jparts = parts(tlines), parts(jlines)
    assert [t for _, t in tparts] == [j for _, j in jparts]
    np.testing.assert_allclose([v for v, _ in tparts], [v for v, _ in jparts], rtol=1e-6)
    want = [float(t_cg(top, B[p], torch.zeros_like(B[p]), 0.5, 1.0,
                       kt.CG(tol=1e-10, maxiter=5))[1].normres) for p in range(1, P)]
    np.testing.assert_allclose([float(line.split("normres = ")[1]) for line in tlines], want,
                               rtol=1e-12)


@pytest.mark.parametrize("driver", ["cg", "minres", "bicgstab"])
def test_batched_linsolve_refusals(driver):
    """Problem counts that disagree are refused with a ``ValueError`` that
    names the driver.  A sharded space is batched (a one-rank axis: the
    unsharded bits, a dict batch too), and so are pytree vectors (each
    problem of a dict batch its one-problem dict solve, bit for bit).
    Unsharded, ``b`` and the shift differentiate: each problem's ``b``
    gradient its one-problem one, bit for bit; on a one-rank sharded axis
    the gradients of ``b``, the shift and the operators are the unsharded
    batch's, each problem's its one-problem sharded solve's, bit for
    bit."""
    tbatched, tcls = DRIVERS[driver][3], DRIVERS[driver][4]
    tone = {"cg": t_cg, "minres": t_minres, "bicgstab": t_bicgstab}[driver]
    A = torch.eye(8, dtype=torch.float64) * 2
    B = torch.ones(2, 8, dtype=torch.float64)
    alg = tcls()
    one = kt.VectorSpace(psum_axis=MeshAxis("vec", None, 1, 0))
    M = A + torch.diag(torch.linspace(0, 1, 8, dtype=A.dtype))
    dict_op = kt.as_operator(lambda x: {"b": M @ x["b"]})
    Bd = B * torch.arange(1, 3, dtype=B.dtype)[:, None] + torch.linspace(0, 1, 8,
                                                                           dtype=B.dtype)
    x, info = tbatched(dict_op, {"b": Bd}, {"b": torch.zeros_like(B)}, 0.0, 1.0, alg)
    for p in range(2):
        x1, i1 = tone(dict_op, {"b": Bd[p]}, {"b": torch.zeros(8, dtype=B.dtype)}, 0.0, 1.0, alg)
        assert torch.equal(x["b"][p], x1["b"]) and int(info.numops[p]) == i1.numops
    xs, infos = tbatched(dict_op, {"b": Bd}, {"b": torch.zeros_like(B)}, 0.0, 1.0, alg, one)
    assert torch.equal(xs["b"], x["b"]) and torch.equal(infos.numops, info.numops)
    # a sharded space is batched: on a one-rank axis (no collective) each
    # problem solves as on the unsharded space, bit for bit
    got = tbatched(A, B, torch.zeros_like(B), 0.0, 1.0, alg, one)
    want = tbatched(A, B, torch.zeros_like(B), 0.0, 1.0, alg)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1].numops, want[1].numops)
    check_one_rank_axis(f"linsolve_{driver}_batched")
    Bg = Bd.clone().requires_grad_(True)
    tbatched(M, Bg, torch.zeros_like(B), 0.0, 1.0, alg)[0].sum().backward()
    for p in range(2):
        b1 = Bd[p].clone().requires_grad_(True)
        kt.linsolve(M, b1, torch.zeros(8, dtype=B.dtype), 0.0, 1.0, alg=alg)[0].sum().backward()
        assert torch.equal(Bg.grad[p], b1.grad)
    with pytest.raises(ValueError, match="disagree"):
        tbatched([A], B, torch.zeros_like(B), 0.0, 1.0, alg, in_dims=(0, 0, 0))
