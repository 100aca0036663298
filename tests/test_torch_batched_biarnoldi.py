"""PyTorch port: batched BiArnoldi ``bieigsolve``
(``solvers/batched_biarnoldi.py``) against ``jax.jit(jax.vmap(...))`` of the
JAX package's ``bieigsolve_driver`` on numpy-seeded inputs: a stack of three
real 24 × 24 float64 matrices with one shared ``(v0, w0)`` pair
(``in_dims=(0, None, None)``, 2 "LM"), a shared matrix in a space with its
own inner product (against the port's one-problem driver and numpy), and
the helpers of the other two files: ``tests/test_torch_batched_biarnoldi_shared.py`` (one shared real
matrix with three ``(v0, w0)`` pairs, "SR") and
``tests/test_torch_batched_biarnoldi_routes.py`` (complex128, a banded
operator with its adjoint planes, the projection flag, the WARN lines and
the refusals).  Tracing and compiling the vmapped driver take 6–14 s on the
CPU, so each file holds one.

Tolerances, stated per test: values within 1e-10 of the JAX package's,
counts exactly equal, and each pair's two residuals ``‖A v − λ v‖`` and
``‖Aᴴ w − conj(λ) w‖`` within their ``normres`` + 1e-10.  Against the
port's one-problem driver each problem is bit-identical where its operator
applies each row as the one-problem apply does (shared operators), and
within 1e-12 on a matrix stack (one batched product).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from krylovkit_tpu import BiArnoldi as JBiArnoldi
from krylovkit_tpu.ops.operator import MatrixOperator as JMatrixOperator
from krylovkit_tpu.solvers.biarnoldi import bieigsolve_driver as j_bieig
import krylovkit_tpu_torch as kt
from krylovkit_tpu_torch import convert
from krylovkit_tpu_torch.ops.operator import as_operator
from krylovkit_tpu_torch.solvers.biarnoldi import bieigsolve_driver as t_bieig

torch.set_num_threads(2)

N, P = 24, 3
KW = dict(krylovdim=12, tol=1e-10, maxiter=100)


def _stack(seed=0):
    """Three matrices drawn one after another and one ``(v0, w0)`` pair
    drawn after them."""
    rng = np.random.default_rng(seed)
    As = np.stack([rng.standard_normal((N, N)) for _ in range(P)])
    return As, rng.standard_normal(N), rng.standard_normal(N)


def counts(info):
    return [np.asarray(info.numops).tolist(), np.asarray(info.numiter).tolist(),
            np.asarray(info.converged).tolist()]


def check_pairs(A, vals, V, W, iV, iW, p):
    """``‖A v − λ v‖`` and ``‖Aᴴ w − conj(λ) w‖`` within their ``normres`` +
    1e-10 for the two pairs of problem ``p``."""
    for i in range(2):
        lam, v, w = complex(vals[p, i]), V[p, i].numpy(), W[p, i].numpy()
        rv = np.linalg.norm(A @ v - lam * v)
        rw = np.linalg.norm(A.conj().T @ w - np.conj(lam) * w)
        assert rv <= float(iV.normres[p, i]) + 1e-10, (p, i, rv)
        assert rw <= float(iW.normres[p, i]) + 1e-10, (p, i, rw)


def same(a, b):
    """Bit-identical values, vectors and infos of two solves."""
    (va, (Va, Wa), (ia, ja)), (vb, (Vb, Wb), (ib, jb)) = a, b
    return (torch.equal(va, vb) and torch.equal(Va, Vb) and torch.equal(Wa, Wb)
            and all(torch.equal(x.residual, y.residual) and torch.equal(x.normres, y.normres)
                    for x, y in ((ia, ib), (ja, jb))))


def problem(out, p):
    """Problem ``p`` of a batched solve, as a one-problem solve returns it."""
    vals, (V, W), (iV, iW) = out

    def info(i):
        return i._replace(residual=i.residual[p], normres=i.normres[p])

    return vals[p], (V[p], W[p]), (info(iV), info(iW))


def test_stack_of_matrices_matches_jax():
    """Three real 24 × 24 float64 matrices with one shared start pair
    (``in_dims=(0, None, None)``), 2 "LM": the problems converge after 210,
    112 and 148 applies, as ``jax.jit(jax.vmap(bieigsolve_driver))`` counts
    them; values within 1e-10 of the JAX package's, both residuals of each
    pair within their ``normres`` + 1e-10, and problem 1 within 1e-12 of its
    one-problem solve (counts equal)."""
    As, v0, w0 = _stack()
    jalg = JBiArnoldi(**KW)
    f = jax.jit(jax.vmap(lambda A: j_bieig(JMatrixOperator(A), jnp.asarray(v0), jnp.asarray(w0),
                                           2, "LM", jalg)))
    vj, _, (ij, _) = f(jnp.asarray(As))
    vals, (Vt, Wt), (iV, iW) = kt.bieigsolve_batched(
        convert.matrices_from_numpy(As, "cpu"), torch.from_numpy(v0), torch.from_numpy(w0), 2,
        "LM", kt.BiArnoldi(**KW), in_dims=(0, None, None))
    assert counts(iV) == counts(iW) == counts(ij)
    assert counts(iV)[0] == [210, 112, 148]
    assert vals.shape == (P, 2) and Vt.shape == Wt.shape == (P, 2, N)
    assert iV.numops.dtype == torch.int64 and iV.residual.shape == (P, 2, N)
    np.testing.assert_allclose(vals.numpy(), np.asarray(vj), rtol=0, atol=1e-10)
    for p in range(P):
        check_pairs(As[p], vals, Vt, Wt, iV, iW, p)
    v1, _, (i1, _) = t_bieig(as_operator(torch.from_numpy(As[1])), torch.from_numpy(v0),
                             torch.from_numpy(w0), 2, "LM", kt.BiArnoldi(**KW))
    assert [i1.numops, i1.numiter, i1.converged] == [c[1] for c in counts(iV)]
    np.testing.assert_allclose(vals[1].numpy(), v1.numpy(), rtol=0, atol=1e-12)


def test_custom_inner_product_space_is_each_problems_one_problem_solve():
    """A space with its own inner product (``VectorSpace(inner_fn=...)``,
    twice the Euclidean one, so ``Aᴴ`` stays the adjoint): one shared real
    matrix (a normal one scaled by ``1/√N`` plus ``diag(10, 6, 0, …)``: its
    two largest values well apart), three ``(v0, w0)`` pairs, 2 "LM"; each
    start is normalised in that space, and every problem is bit-identical
    to its one-problem solve in the same space (values, both vector sets,
    both infos, counts); the values within 1e-10 of numpy's eigenvalues."""
    rng = np.random.default_rng(20)
    A = rng.standard_normal((N, N)) / np.sqrt(N) + np.diag(np.r_[10.0, 6.0, np.zeros(N - 2)])
    V, W = (torch.from_numpy(rng.standard_normal((P, N))) for _ in range(2))
    At = torch.from_numpy(A)
    space = kt.VectorSpace(inner_fn=lambda x, y: 2.0 * torch.vdot(x, y))
    alg = kt.BiArnoldi(**KW)
    out = kt.bieigsolve_batched(At, V, W, 2, "LM", alg, space)
    assert out[2][0].converged.tolist() == [2] * P
    ev = np.linalg.eigvals(A)
    want = ev[np.argsort(-np.abs(ev))][:2]
    np.testing.assert_allclose(out[0].numpy(), np.broadcast_to(want, (P, 2)), rtol=0, atol=1e-10)
    for p in range(P):
        one = t_bieig(as_operator(At), V[p], W[p], 2, "LM", alg, space)
        assert same(problem(out, p), one)
        assert [one[2][0].numops, one[2][0].numiter] == [c[p] for c in counts(out[2][0])[:2]]
