"""PyTorch port: the batched operator applies on the CPU — the plain
versions of the batched banded SpMV (K3) and 1-D Laplacian (K4) against
their one-vector plain versions bit for bit, the per-problem planes of a
JAX ``BandedOperator`` batched under ``jax.vmap`` (``convert``), and the
routing of ``solvers/batched.py:_Operators``: one batched apply per step of
every batched driver on a banded operator, each problem bit-identical to
its one-problem solve where the rest of the step runs per problem, complex
planes applied problem by problem.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krylovkit_tpu.ops.pallas_spmv import BandedOperator as JBandedOperator
from krylovkit_tpu.ops.pallas_spmv import banded_from_coo as j_banded_from_coo
import krylovkit_tpu_torch as kt
from chip_smoke import poisson_coo
from krylovkit_tpu_torch import convert
from krylovkit_tpu_torch.ops import banded as bd
from krylovkit_tpu_torch.ops import stencil_1d as s1
from krylovkit_tpu_torch.solvers.batched import _Operators
from krylovkit_tpu_torch.solvers.gmres import linsolve_gmres as t_gmres
from krylovkit_tpu_torch.solvers.lanczos import eigsolve_lanczos as t_eigsolve_lanczos

torch.set_num_threads(2)

OFFSETS = (-130, -1, 0, 3, 129)


def _planes(rng, sets, n, dtype):
    R = -(-n // 128)
    shape = (len(OFFSETS), R, 128) if sets is None else (sets, len(OFFSETS), R, 128)
    return torch.from_numpy(rng.standard_normal(shape).astype(dtype))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shared", [True, False])
def test_batched_spmv_plain_version_equals_looped_plain_version(dtype, shared):
    """Each row of ``banded_spmv_batched_reference`` (and of
    ``banded_spmv_batched`` on CPU tensors) equals ``banded_spmv_reference``
    of that row with its plane set, bit for bit: shared planes, and per-row
    plane sets named with repeats; n = 300 is not a multiple of 128."""
    rng = np.random.default_rng(40)
    n, rows = 300, 5
    D = _planes(rng, None if shared else 4, n, dtype)
    planes = None if shared else [2, 0, 3, 1, 2]
    X = torch.from_numpy(rng.standard_normal((rows, n)).astype(dtype))
    Y = bd.banded_spmv_batched_reference(X, D, OFFSETS, n, planes)
    assert torch.equal(bd.banded_spmv_batched(X, D, OFFSETS, n, planes), Y)
    assert Y.shape == X.shape and Y.dtype == X.dtype
    for r in range(rows):
        Dr = D if shared else D[planes[r]]
        assert torch.equal(Y[r], bd.banded_spmv_reference(X[r], Dr, OFFSETS, n))
    meta = bd.banded_spmv_batched(X.to("meta"), D, OFFSETS, n, planes)
    assert meta.device.type == "meta" and meta.shape == X.shape
    with pytest.raises(ValueError, match="plane sets"):
        bd.banded_spmv_batched(X, D, OFFSETS, n, [0, 1])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_batched_laplacian_plain_version_equals_looped_plain_version(dtype):
    """Each row of ``laplacian_1d_flat_batched_reference`` (and of
    ``laplacian_1d_flat_batched`` on CPU tensors) equals
    ``laplacian_1d_flat_reference`` of that row bit for bit, as a flat
    ``(rows, n)`` stack, whatever the rows' shape."""
    X = torch.from_numpy(np.random.default_rng(41).standard_normal((3, 16, 128)).astype(dtype))
    Y = s1.laplacian_1d_flat_batched_reference(X)
    assert Y.shape == (3, 2048) and torch.equal(s1.laplacian_1d_flat_batched(X), Y)
    for r in range(3):
        assert torch.equal(Y[r], s1.laplacian_1d_flat_reference(X[r]))
    op = kt.laplacian_1d_pallas(2048, device="cpu")
    assert isinstance(op, s1.Laplacian1DOperator) and op.n == 2048
    assert torch.equal(op.normal(X[1]), Y[1]) and torch.equal(op.adjoint(X[2]), Y[2])


def test_banded_batch_from_arrays_matches_jax_vmapped_operator():
    """``convert.banded_batch_from_arrays`` of a ``(P, nδ, R, 128)`` stack
    gives one ``BandedOperator`` per plane set; each applies as the JAX
    operator built from that set under ``jax.vmap`` (within 1e-14 of the
    largest entry: both add the offsets' terms in order), and the batched
    operator of the sequence stacks their planes."""
    rows, cols, vals = poisson_coo(np, 16, np.float64)
    jop = j_banded_from_coo(rows, cols, vals, 256)
    D = np.stack([np.asarray(jop.diags) * (1 + 0.1 * p) for p in range(3)])
    X = np.random.default_rng(42).standard_normal((3, 256))
    yj = np.asarray(jax.vmap(lambda d, x: JBandedOperator(jop.offsets, d, 256).normal(x))(
        jnp.asarray(D), jnp.asarray(X)))
    ops = convert.banded_batch_from_arrays(jop.offsets, D, 256, device="cpu")
    assert len(ops) == 3 and all(o.offsets == jop.offsets and o.n == 256 for o in ops)
    for p, o in enumerate(ops):
        assert torch.equal(o.diags, torch.from_numpy(D[p]))
        np.testing.assert_allclose(o.normal(torch.from_numpy(X[p])).numpy(), yj[p], rtol=0,
                                   atol=1e-14 * np.abs(yj).max())
    batched = _Operators(ops, 3, True)
    assert batched.planes is not None and not batched.shared
    assert batched.planes.shape == (3,) + D.shape[1:]


@pytest.fixture
def stacks(monkeypatch):
    """Records the rows of every batched K3 apply."""
    seen = []
    inner = bd.banded_spmv_batched

    def recording(X, diags, offsets, n, planes=None):
        seen.append(X.shape[0])
        return inner(X, diags, offsets, n, planes)

    monkeypatch.setattr(bd, "banded_spmv_batched", recording)
    return seen


def _poisson_op(complex_planes=False):
    rows, cols, vals = poisson_coo(np, 16, np.float64)
    if complex_planes:
        vals = vals.astype(np.complex128)
    return kt.banded_from_coo(rows, cols, vals, 256, device="cpu")


def test_unfused_batched_gmres_and_lanczos_apply_banded_in_one_stack(stacks):
    """The unfused batched GMRES and Lanczos apply a shared banded operator
    once per step for every problem that steps (the rows of the batched
    applies add up to the counts), and each problem is bit-identical to its
    one-problem solve."""
    op = _poisson_op()
    B = torch.from_numpy(np.random.default_rng(43).standard_normal((3, 256)) * [[1], [2], [3]])
    alg = kt.GMRES(krylovdim=12, tol=1e-8, maxiter=20)
    x, info = kt.linsolve_gmres_batched(op, B, torch.zeros_like(B), 0.5, 1.0, alg)
    assert sum(stacks) == int(info.numops.sum())
    for p in range(3):
        x1, i1 = t_gmres(op, B[p], torch.zeros_like(B[p]), 0.5, 1.0, alg)
        assert [i1.numops, i1.numiter] == [int(info.numops[p]), int(info.numiter[p])]
        assert torch.equal(x[p], x1)
    del stacks[:]
    lalg = kt.Lanczos(krylovdim=16, tol=1e-8, maxiter=20)
    vals, _, linfo = kt.eigsolve_lanczos_batched(op, B, 2, "SR", lalg)
    assert sum(stacks) == int(linfo.numops.sum())
    assert "converged value(s)" in repr(linfo)
    for p in range(3):
        v1, _, i1 = t_eigsolve_lanczos(op, B[p], 2, "SR", lalg)
        assert i1.numops == int(linfo.numops[p]) and torch.equal(vals[p], v1)


@pytest.mark.parametrize("driver", ["cg", "minres", "bicgstab"])
def test_batched_linear_drivers_apply_only_the_rows_that_need_it(stacks, driver):
    """Every apply of a batched CG, MINRES or BiCGStab solve on a shared
    banded operator is one stack: its rows over the solve add up to the
    problems' ``numops``; a step makes one (CG, MINRES) or two (BiCGStab)
    applies, plus one in a step where some problem verifies."""
    solve = {"cg": kt.linsolve_cg_batched, "minres": kt.linsolve_minres_batched,
             "bicgstab": kt.linsolve_bicgstab_batched}[driver]
    alg = {"cg": kt.CG, "minres": kt.MINRES, "bicgstab": kt.BiCGStab}[driver](tol=1e-9, maxiter=400)
    B = torch.from_numpy(np.random.default_rng(44).standard_normal((4, 256)) * [[1], [2], [3], [4]])
    _, info = solve(_poisson_op(), B, torch.zeros_like(B), 0.5, 1.0, alg)
    assert sum(stacks) == int(info.numops.sum())
    per_step = 2 if driver == "bicgstab" else 1
    start = 2 if driver == "minres" else 1  # MINRES's final residual
    least = start + per_step * int(info.numiter.max())
    verifications = int(info.numops.sum()) - 4 * start - per_step * int(info.numiter.sum())
    assert least <= len(stacks) <= least + verifications


def test_complex_planes_apply_problem_by_problem(stacks):
    """Complex planes take the plain version problem by problem, as the JAX
    package sends them to XLA: no batched K3 apply, each problem
    bit-identical to its one-problem solve."""
    op = _poisson_op(complex_planes=True)
    rng = np.random.default_rng(45)
    B = torch.from_numpy(rng.standard_normal((2, 256)) + 1j * rng.standard_normal((2, 256)))
    alg = kt.BiCGStab(tol=1e-9, maxiter=200)
    x, info = kt.linsolve_bicgstab_batched(op, B, torch.zeros_like(B), 0.5, 1.0, alg)
    assert stacks == []
    from krylovkit_tpu_torch.solvers.bicgstab import linsolve_bicgstab

    for p in range(2):
        x1, i1 = linsolve_bicgstab(op, B[p], torch.zeros_like(B[p]), 0.5, 1.0, alg)
        assert [i1.numops, i1.numiter] == [int(info.numops[p]), int(info.numiter[p])]
        assert torch.equal(x[p], x1)


@pytest.mark.parametrize("adjoint", [False, True], ids=["normal", "adjoint"])
def test_matrix_stack_applies_repeated_problem_rows(adjoint):
    """A matrix stack applies a stack whose rows name a problem more than
    once (a block of rows per problem, as Block Lanczos applies it: ``ps =
    [0, 0, 1, 1]``): two 6 × 6 float64 matrices, each row within 1e-12 of
    its own ``A_p x`` (``A_pᴴ x`` for the adjoint stack)."""
    rng = np.random.default_rng(43)
    As = rng.standard_normal((2, 6, 6))
    X = torch.from_numpy(rng.standard_normal((4, 6)))
    ps = [0, 0, 1, 1]
    ops = _Operators(convert.matrices_from_numpy(As, "cpu"), 2, True)
    Y = ops.apply_adjoint_stack(X, ps) if adjoint else ops.apply_stack(X, ps)
    assert Y.shape == X.shape
    for i, p in enumerate(ps):
        A = As[p].conj().T if adjoint else As[p]
        np.testing.assert_allclose(Y[i].numpy(), A @ X[i].numpy(), rtol=0, atol=1e-12)
