"""PyTorch port: batched BiArnoldi ``bieigsolve`` against
``jax.jit(jax.vmap(...))`` of the JAX package's ``bieigsolve_driver`` on
one shared real 24 × 24 float64 matrix with three ``(v0, w0)`` pairs
(``in_dims=(None, 0, 0)``), 2 "SR".  The stack of matrices, the banded operator,
the projection flag, the WARN lines and the refusals are in
``tests/test_torch_batched_biarnoldi.py``; one JAX compilation of the
vmapped driver takes 6–12 s on the CPU, so each file holds one.

Tolerances: values within 1e-10 of the JAX package's, counts exactly equal,
each pair's two residuals within their ``normres`` + 1e-10, and each
problem bit-identical to the port's one-problem solve (a shared operator).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from krylovkit_tpu import BiArnoldi as JBiArnoldi
from krylovkit_tpu.ops.operator import MatrixOperator as JMatrixOperator
from krylovkit_tpu.solvers.biarnoldi import bieigsolve_driver as j_bieig
import krylovkit_tpu_torch as kt
from krylovkit_tpu_torch.ops.operator import as_operator
from krylovkit_tpu_torch.solvers.biarnoldi import bieigsolve_driver as t_bieig
from test_torch_batched_biarnoldi import KW, N, P, check_pairs, counts, problem, same

torch.set_num_threads(2)


def test_shared_real_matrix_with_three_start_pairs_matches_jax():
    """One shared real matrix (a normal one scaled by ``2/√N`` minus
    ``diag(linspace(0, 10)²/10)``: its leftmost values well apart), three
    ``(v0, w0)`` pairs drawn after it:
    counts equal to ``jax.vmap``'s, values within 1e-10, both residuals of
    each pair within their ``normres`` + 1e-10, and each problem
    bit-identical to its one-problem solve (values, both vector sets, both
    infos' residuals and norms, counts)."""
    rng = np.random.default_rng(8)
    A = 2 * rng.standard_normal((N, N)) / np.sqrt(N) - np.diag(np.linspace(0, 10, N) ** 2 / 10)
    V, W = rng.standard_normal((P, N)), rng.standard_normal((P, N))
    jalg = JBiArnoldi(**KW)
    f = jax.jit(jax.vmap(lambda v, w: j_bieig(JMatrixOperator(jnp.asarray(A)), v, w, 2, "SR",
                                              jalg)))
    vj, _, (ij, _) = f(jnp.asarray(V), jnp.asarray(W))
    At = torch.from_numpy(A)
    out = kt.bieigsolve_batched(At, torch.from_numpy(V), torch.from_numpy(W), 2, "SR",
                                kt.BiArnoldi(**KW))
    vals, (Vt, Wt), (iV, iW) = out
    assert counts(iV) == counts(iW) == counts(ij)
    assert Vt.dtype == torch.complex128 and Vt.shape == (P, 2, N)
    np.testing.assert_allclose(vals.numpy(), np.asarray(vj), rtol=0, atol=1e-10)
    for p in range(P):
        check_pairs(A, vals, Vt, Wt, iV, iW, p)
        one = t_bieig(as_operator(At), torch.from_numpy(V[p]), torch.from_numpy(W[p]), 2,
                      "SR", kt.BiArnoldi(**KW))
        assert same(problem(out, p), one)
        assert [one[2][0].numops, one[2][0].numiter, one[2][0].converged] == [
            c[p] for c in counts(iV)]

