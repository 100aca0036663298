"""PyTorch port: the adjoint stack apply of ``solvers/batched.py:_Operators``
(``apply_adjoint_stack`` and ``adjoint``), which the batched GKL
``svdsolve`` and LSMR ``lssolve`` take, against ``op.apply_adjoint`` row by
row, for every kind: a shared kernel-backed ``BandedOperator`` (one batched
K3 launch on its adjoint planes), a list of them with equal offsets (the
adjoint planes stacked once, one launch with a plane set per row), a shared
``Laplacian1DOperator`` (self-adjoint, one batched K4 launch), ``P``
matrices of one shape (one product over the conjugate-transposed stack),
and anything else (problem by problem); the CPU runs the kernels' plain
versions, counted here by wrapping them.

Tolerances: bit-identical to ``op.apply_adjoint`` for the banded, Laplacian
and per-problem rows; within 1e-12 for a matrix stack (one batched product
rounds otherwise than ``P`` matrix-vector products).
"""

import numpy as np
import pytest
import torch

import chip_smoke
import krylovkit_tpu_torch as kt
from krylovkit_tpu_torch import convert
from krylovkit_tpu_torch.ops import banded as bd
from krylovkit_tpu_torch.ops import stencil_1d as s1
from krylovkit_tpu_torch.solvers.batched import _Operators

torch.set_num_threads(2)

P, N = 4, 256


class _Count:
    """Counts the calls of a module function within the block."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, 0

    def __enter__(self):
        self.real = getattr(self.module, self.name)

        def counted(*a, **kw):
            self.calls += 1
            return self.real(*a, **kw)

        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def _tridiagonal(p=0, dtype=np.float64):
    return kt.banded_from_coo(*chip_smoke.tridiagonal_coo(np, N, -1.3 * (1 + 0.1 * p), 2.0, -0.7,
                                                          dtype), N, device="cpu")


def _rows(seed=1, shape=(P, N), dtype=torch.float64):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)).to(dtype)


def _each_row(batch, ops, X, ps, exact=True):
    """``apply_adjoint_stack`` and the dict form against each row's
    ``op.apply_adjoint``."""
    Y = batch.apply_adjoint_stack(X, ps)
    Yd = batch.adjoint({p: X[i] for i, p in enumerate(ps)})
    for i, p in enumerate(ps):
        want = ops[p].apply_adjoint(X[i])
        if exact:
            assert torch.equal(Y[i], want) and torch.equal(Yd[p], want), p
        else:
            np.testing.assert_allclose(Y[i].numpy(), want.numpy(), rtol=0, atol=1e-12)
            np.testing.assert_allclose(Yd[p].numpy(), want.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_shared_banded_adjoint_is_one_batched_launch(dtype):
    """A shared kernel-backed banded operator: the adjoint of a stack of
    rows is one batched K3 call on the adjoint's planes, each row
    bit-identical to ``op.apply_adjoint``; a subset of problems too."""
    op = _tridiagonal(dtype=dtype)
    batch = _Operators(op, P, False)
    X = _rows(dtype=torch.from_numpy(np.zeros(1, dtype)).dtype)
    with _Count(bd, "banded_spmv_batched") as c:
        _each_row(batch, [op] * P, X, list(range(P)))
        _each_row(batch, [op] * P, X[:2], [1, 3])
    assert c.calls == 4 and batch.adj_planes is op.adj.diags


def test_banded_list_adjoint_stacks_planes_once():
    """A list of banded operators with equal offsets, each with its adjoint
    (``convert.banded_batch_from_arrays`` with adjoint stacks): the adjoint
    planes stacked once, one batched call with a plane set per row, each
    row bit-identical."""
    ops = [_tridiagonal(p) for p in range(P)]
    D = np.stack([o.diags.numpy() for o in ops])
    Da = np.stack([o.adj.diags.numpy() for o in ops])
    ops = convert.banded_batch_from_arrays(ops[0].offsets, D, N, "cpu",
                                           adj_offsets=ops[0].adj.offsets, adj_diags=Da)
    batch = _Operators(ops, P, True)
    X = _rows(2)
    with _Count(bd, "banded_spmv_batched") as c:
        _each_row(batch, ops, X, list(range(P)))
        _each_row(batch, ops, X[1:3], [0, 2])
    assert c.calls == 4 and batch.adj_planes.shape == (P,) + tuple(Da.shape[1:])


def test_laplacian_adjoint_is_its_normal_batched():
    """A shared ``Laplacian1DOperator`` is self-adjoint: one batched K4 call
    a stack, each row bit-identical to ``op.apply_adjoint``."""
    op = kt.laplacian_1d_pallas(N, torch.float64, device="cpu")
    batch = _Operators(op, P, False)
    X = _rows(3)
    with _Count(s1, "laplacian_1d_flat_batched") as c:
        _each_row(batch, [op] * P, X, list(range(P)))
    assert c.calls == 2


@pytest.mark.parametrize("complex_", [False, True], ids=["real", "complex"])
def test_matrix_stack_adjoint_is_one_product(complex_):
    """``P`` rectangular matrices of one shape: the adjoint applies as one
    product over the conjugate-transposed stack, each row within 1e-12 of
    ``op.apply_adjoint``."""
    rng = np.random.default_rng(4)
    As = rng.standard_normal((P, 30, 20))
    if complex_:
        As = As + 1j * rng.standard_normal((P, 30, 20))
    ops = convert.matrices_from_numpy(As, "cpu")
    batch = _Operators(ops, P, True)
    X = _rows(5, (P, 30), torch.complex128 if complex_ else torch.float64)
    with _Count(torch, "matmul") as c:
        _each_row(batch, ops, X, list(range(P)), exact=False)
    assert c.calls >= 1
    assert batch.adj_stack.shape == (P, 20, 30)


def test_other_operators_apply_their_adjoints_per_problem():
    """Stencils, callable pairs and complex banded planes apply their
    adjoints problem by problem, each row bit-identical; no batched call."""
    stencil = kt.StencilOperator((-1, 0, 1), (-1.3, 2.0, -0.7))
    A = torch.from_numpy(np.random.default_rng(6).standard_normal((N, N)))
    pair = kt.ops.operator.as_operator((lambda x: A @ x, lambda y: A.T @ y))
    cplx = kt.banded_from_coo(*chip_smoke.tridiagonal_coo(np, N, -1.3 + 0.5j, 2.0, -0.7,
                                                          np.complex128), N, device="cpu")
    X = _rows(7)
    with _Count(bd, "banded_spmv_batched") as c:
        for op in (stencil, pair, cplx):
            _each_row(_Operators(op, P, False), [op] * P, X, list(range(P)))
        _each_row(_Operators([stencil, pair, stencil, pair], P, True),
                  [stencil, pair, stencil, pair], X, list(range(P)))
    assert c.calls == 0


def test_templates_give_each_operator_its_adjoint():
    """With ``templates`` (each problem's codomain vector) a bare callable
    gets a derived adjoint and a ``(f, fadjoint)`` pair is checked, once
    per distinct operator, as the one-problem front-ends do; an
    incompatible pair raises."""
    A = torch.from_numpy(np.random.default_rng(8).standard_normal((N, N)))
    X = _rows(9)
    batch = _Operators(lambda x: A @ x, P, False, templates=list(X))
    assert len(batch.distinct()) == 1
    _each_row(batch, [kt.ops.operator.as_operator((lambda x: A @ x, lambda y: A.T @ y))] * P,
              X, list(range(P)), exact=False)
    with pytest.raises(ValueError, match="not compatible"):
        _Operators((lambda x: A @ x, lambda y: A @ y), P, False, templates=list(X))
