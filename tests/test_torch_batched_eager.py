"""PyTorch port: batched eager solves (``eager=True``) of the Lanczos
eigsolve and the GKL ``svdsolve`` against ``jax.jit(jax.vmap(...))`` of the
JAX package's drivers on the same numpy-seeded float64 inputs
(``tests/batched_eager_specs.py``), each problem against the port's own
one-problem eager solve; a tuple case; and the refusals that remain.  The
other eager batches have a file each (``tests/test_torch_batched_eager_*.py``:
``schursolve``, ``eigsolve_arnoldi``, ``realeigsolve``, BiArnoldi, the
exponential integrators), so that each file stays under 20 s: a JAX compile
of a vmapped Arnoldi driver takes ~6 s on the CPU, of BiArnoldi ~10 s.

Tolerances, stated per test: values within 1e-10 of the JAX package's;
``numops``, ``numiter`` and ``converged`` equal; on a shared matrix each
problem bit-identical (``torch.equal``) to its one-problem solve, on a
matrix stack its values within 1e-12.  The card test (marker ``cuda``)
imports no JAX:

    python -m pytest --noconftest tests/test_torch_batched_eager.py -m cuda
"""

import numpy as np
import pytest
import torch

import krylovkit_tpu_torch as kt
from batched_eager_specs import check_against_jax, counts
from batched_grad_specs import check_one_rank_axis
from chip_smoke import SMALL_SHARDED_TOL, small_batched_eager_cases
from krylovkit_tpu_torch.ops.collectives import MeshAxis
from krylovkit_tpu_torch.ops.vector import tree_leaves, tree_row
from krylovkit_tpu_torch.solvers import batched as tbatched
from krylovkit_tpu_torch.solvers import lanczos as tlz
from krylovkit_tpu_torch.solvers.lanczos import eigsolve_lanczos as t_lanczos

try:  # the card's machine has no JAX; there only the card test runs
    import jax
    import jax.numpy as jnp
except ImportError:
    jax = None

torch.set_num_threads(2)
P = 3


def _jax():
    if jax is None:
        pytest.skip("needs JAX (the reference)")


@pytest.mark.parametrize("case", ["matrix_stack", "shared_matrix"])
@pytest.mark.parametrize("driver", ["eigsolve_lanczos_batched", "svdsolve_gkl_batched"])
def test_batched_eager_matches_jax_vmap(driver, case):
    """``eager=True``: values within 1e-10 of the vmapped JAX driver, counts
    equal, each problem its one-problem eager solve (bit for bit on a
    shared matrix)."""
    _jax()
    check_against_jax(driver, case)


def cut(v):
    return (v[..., :9], v[..., 9:])


def join(t):
    return (torch.cat if isinstance(t[0], torch.Tensor) else jnp.concatenate)(list(t), -1)


def _tree_problem():
    rng = np.random.default_rng(611)
    A = rng.standard_normal((24, 24))
    return (A + A.T) / 2, rng.standard_normal((P, 24))


def test_batched_eager_lanczos_on_tuples_matches_jax_vmap():
    """``P`` tuple starts (9 + 15 entries) of one symmetric map, eager
    Lanczos: values within 1e-10 of the vmapped JAX tree solve, counts
    equal; each problem its one-problem tuple solve, bit for bit, and each
    restart rotates only the problems that restart (no identity rotation)."""
    _jax()
    from krylovkit_tpu import Lanczos as JLanczos
    from krylovkit_tpu.ops import operator as jop
    from krylovkit_tpu.solvers.lanczos import eigsolve_lanczos as j_lanczos

    A, X = _tree_problem()
    kw = dict(krylovdim=8, tol=1e-10, maxiter=100, eager=True)
    Aj, At = jnp.asarray(A), torch.from_numpy(A)
    opj = jop.as_operator(lambda x: cut(Aj @ join(x)))
    jv, _, ji = jax.jit(jax.vmap(lambda x: j_lanczos(opj, x, 2, "SR", JLanczos(**kw))))(
        cut(jnp.asarray(X)))

    def opt(x):
        return cut(At @ join(x))

    rotated, restarts = [], []
    rotate, restart = tbatched._rotate, tlz._restart

    def rotating(Vb, Us, m_out):
        rotated.append(sorted(Us))
        return rotate(Vb, Us, m_out)

    def restarting(*a, **kw):
        restarts.append(a)
        return restart(*a, **kw)

    tbatched._rotate, tlz._restart = rotating, restarting
    try:
        Xt = cut(torch.from_numpy(X))
        vals, vecs, info = kt.eigsolve_lanczos_batched(opt, Xt, 2, "SR", kt.Lanczos(**kw))
        ones = [t_lanczos(kt.as_operator(opt), tree_row(Xt, p), 2, "SR", kt.Lanczos(**kw))
                for p in range(P)]
    finally:
        tbatched._rotate, tlz._restart = rotate, restart
    np.testing.assert_allclose(vals.numpy(), np.asarray(jv), rtol=0, atol=1e-10)
    assert counts(info) == counts(ji) and counts(info)[2] == [2] * P
    # as many rotations of a problem as its one-problem solve's restarts,
    # then the extraction's
    assert sum(len(r) for r in rotated[:-1]) == len(restarts) > 0
    assert rotated[-1] == list(range(P))
    for p, (v1, w1, i1) in enumerate(ones):
        assert torch.equal(vals[p], v1)
        for a, b in ((tree_row(vecs, p), w1), (tree_row(info.residual, p), i1.residual)):
            assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))
        assert [c[p] for c in counts(info)] == [i1.numops, i1.numiter, i1.converged]


@pytest.mark.parametrize("driver", ["eigsolve_lanczos_batched", "svdsolve_gkl_batched",
                                    "exponentiate_batched"])
def test_batched_eager_refusals_that_remain(driver):
    """``exponentiate`` refuses differentiation on every space (it has no
    rule), naming itself; an eager Lanczos or GKL batch differentiates, on
    a sharded space too: on a one-rank axis the unsharded batched gradient,
    each problem its one-problem eager sharded gradient, bit for bit; on a
    one-rank sharded axis a batch is the unsharded batch, bit for bit, a
    dict batch too."""
    A = torch.diag(torch.linspace(1.0, 2.0, 8, dtype=torch.float64))
    X = torch.ones((2, 8), dtype=torch.float64) + torch.arange(8.0, dtype=torch.float64) / 8
    one = kt.VectorSpace(psum_axis=MeshAxis("vec", None, 1, 0))

    def call(X0, space=kt.STANDARD, A=A):
        if isinstance(X0, dict):  # a dict batch: the map on dicts, with its adjoint
            A = (lambda x, A=A: {"a": A @ x["a"]}, lambda y, A=A: {"a": A.T @ y["a"]})
        if driver == "eigsolve_lanczos_batched":
            return kt.eigsolve_lanczos_batched(A, X0, 1, "LR", kt.Lanczos(krylovdim=4, eager=True),
                                               space)
        if driver == "svdsolve_gkl_batched":
            return kt.svdsolve_gkl_batched(A, X0, 1, "LR", kt.GKL(krylovdim=4, eager=True), space)
        return kt.exponentiate_batched(A, 0.1, X0, kt.Lanczos(krylovdim=4, eager=True), space)

    named = driver.replace("exponentiate", "expintegrator")
    if driver == "exponentiate_batched":
        for space in (one, kt.STANDARD):
            with pytest.raises(ValueError, match=f"{named}: differentiation has no rule"):
                call(X, space, A.clone().requires_grad_(True))
    else:
        Ag = A.clone().requires_grad_(True)
        call(X, kt.STANDARD, Ag)[0].sum().backward()
        assert Ag.grad is not None and bool(torch.isfinite(Ag.grad).all())
        check_one_rank_axis(driver, eager=True)
    got, want = call(X, one), call(X)
    assert torch.equal(got[0], want[0])
    got, want = call({"a": X}, one), call({"a": X})
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got[0]), tree_leaves(want[0])))


@pytest.mark.cuda
def test_batched_eager_on_the_card():
    """The small float64 eager batches of ``chip_smoke.py``'s phase
    ``batched_eager_selective`` on the card against the CPU: within
    ``SMALL_SHARDED_TOL``, counts equal, each problem bit-identical to its
    one-problem solve on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for name in small_batched_eager_cases(torch, np, kt, "cpu", one_problem=False):
        vc, cc, bc = small_batched_eager_cases(torch, np, kt, "cuda")[name]()
        vh, ch, _ = small_batched_eager_cases(torch, np, kt, "cpu", one_problem=False)[name]()
        assert float((vc - vh).abs().max()) <= SMALL_SHARDED_TOL * max(float(vh.abs().max()), 1)
        assert cc == ch and bc, name
