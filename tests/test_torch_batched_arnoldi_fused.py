"""PyTorch port: batched Krylov-Schur Arnoldi (``solvers/batched_arnoldi.py``)
on the shared-operator paths: each problem against the port's own
one-problem solve, the fused float32 ``schursolve`` against
``jax.jit(jax.vmap(...))`` of the JAX package's fused one, and the
projection flag on (the plain batched K5 and K6) against off.  The matrix
stacks against the JAX package, the WARN lines and the refusals are in
``tests/test_torch_batched_arnoldi.py``.

Tolerances, stated per test: 1e-12 against the port's one-problem solves
on a matrix stack (it applies as one batched product) and bit-equal on a
shared operator (the same arithmetic per problem); float32 fused values
1e-4 relative against the JAX package (two differently ordered float32
sums); counts always exactly equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krylovkit_tpu import Arnoldi as JArnoldi
from krylovkit_tpu import StencilOperator as JStencilOperator
from krylovkit_tpu.factorizations import krylov as jkf
from krylovkit_tpu.solvers import arnoldi as ja
import chip_smoke
import krylovkit_tpu_torch as kt
from krylovkit_tpu_torch import convert
from krylovkit_tpu_torch.ops import basis as tbs
from krylovkit_tpu_torch.ops import projections as tpb
from krylovkit_tpu_torch.solvers import arnoldi as ta

torch.set_num_threads(2)

N = 24
NONSYM = ((-1, 0, 1), (-1.3, 2.0, -0.7))


def _talg(jalg):
    return convert.arnoldi_from_dict({**dataclasses.asdict(jalg), "orth": type(jalg.orth).__name__})


def _counts(info):
    return [np.asarray(info.numops).tolist(), np.asarray(info.numiter).tolist(),
            np.asarray(info.converged).tolist()]


def _real_stack():
    """Three non-normal ``N × N`` float64 matrices with real spectra."""
    rng = np.random.default_rng(31)
    out = []
    for shift in (0.0, 0.5, -0.3):
        S = np.eye(N) + 0.2 * rng.standard_normal((N, N))
        out.append(S @ np.diag(np.linspace(-1, 3, N) + shift) @ np.linalg.inv(S))
    return np.stack(out)


@pytest.mark.parametrize("driver", ["schursolve", "eigsolve_arnoldi", "realeigsolve_arnoldi"])
def test_batched_arnoldi_equals_one_problem_solves(driver):
    """Each problem against the port's one-problem solve: a per-problem
    start on a matrix stack (values 1e-12, counts equal; the stack applies
    as one batched product), and a shared matrix with per-problem starts,
    whose applies are the one-problem ones (values bit-equal)."""
    As = _real_stack()
    X0 = np.random.default_rng(32).standard_normal((3, N))
    alg = kt.Arnoldi(krylovdim=12, tol=1e-10, maxiter=4)
    one = getattr(ta, driver)
    batched = getattr(kt, driver + "_batched")
    ops = convert.matrices_from_numpy(As, "cpu")
    for op, in_dims, exact in ((ops, (0, 0), False), (ops[0], (None, 0), True)):
        out = batched(op, torch.from_numpy(X0), 3, "LR", alg, in_dims=in_dims)
        info = out[3] if driver == "schursolve" else out[2]
        assert min(info.numiter.tolist()) > 1  # restarts happen
        for p in range(3):
            o1 = one(op[p] if in_dims[0] == 0 else op, torch.from_numpy(X0[p]), 3, "LR", alg)
            i1 = o1[3] if driver == "schursolve" else o1[2]
            assert [i1.numops, i1.numiter, i1.converged] == [
                int(info.numops[p]), int(info.numiter[p]), int(info.converged[p])]
            v1, v = (o1[2][0], out[2][0][p]) if driver == "schursolve" else (o1[0], out[0][p])
            if exact:
                assert torch.equal(v, v1) and torch.equal(info.normres[p], i1.normres)
            else:
                np.testing.assert_allclose(v.numpy(), v1.numpy(), rtol=0, atol=1e-12)


def _starts(P, R, seed=100):
    return chip_smoke.batched_starts(torch, np, R, P, "cpu", seed)


@pytest.fixture
def interpret_mode():
    old = jkf.fused_interpret
    jkf.fused_interpret = True
    try:
        yield
    finally:
        jkf.fused_interpret = old


def test_vmap_of_fused_schursolve_matches_jax(interpret_mode):
    """The fused real ``schursolve`` on the float32 chain (-1.3, 2, -0.7),
    P = 2, R = 16 (the smallest fused height in both packages), krylovdim
    12, maxiter 3 (the JAX side's K1/K2 in Pallas interpret mode, the
    port's plain versions): counts equal per problem, values within 1e-4
    relative, and each problem bit-equal to the port's one-problem fused
    solve."""
    X = _starts(2, 16).numpy()
    jalg = JArnoldi(krylovdim=12, maxiter=3, tol=1e-30)
    jop = JStencilOperator(*NONSYM)
    top = convert.stencil_from_arrays(*NONSYM, "cpu")
    assert kt.factorizations.krylov.fused_available(top, torch.from_numpy(X[0]), kt.STANDARD,
                                                    kmax=13)
    f = jax.jit(jax.vmap(lambda x: ja.schursolve(jop, x, 4, "LM", jalg)))
    _, _, (rej, imj), ij = f(jnp.asarray(X))
    _, V, (re_, im_), it = kt.schursolve_batched(top, torch.from_numpy(X), 4, "LM", _talg(jalg))
    assert _counts(it) == _counts(ij)
    lam, lamj = np.hypot(re_.numpy(), im_.numpy()), np.hypot(np.asarray(rej), np.asarray(imj))
    np.testing.assert_allclose(lam, lamj, rtol=1e-4)
    for p in range(2):
        _, V1, (r1, i1), inf1 = ta.schursolve(top, torch.from_numpy(X[p]), 4, "LM", _talg(jalg))
        assert (inf1.numops, inf1.numiter) == (int(it.numops[p]), int(it.numiter[p]))
        assert torch.equal(r1, re_[p]) and torch.equal(i1, im_[p]) and torch.equal(V1, V[p])


def test_projection_flag_on_equals_flag_off(monkeypatch):
    """The banded config-4 matrix at n = 2048 with ``(16, 128)`` float32
    starts: the projection flag on (the plain batched K5 and K6, one call
    each per sweep) against off, counts equal and values within 1e-4
    relative; flag on, each problem bit-equal to its one-problem flag-on
    solve."""
    n = 2048
    band = kt.banded_from_coo(*chip_smoke.tridiagonal_coo(np, n, -1.3, 2.0, -0.7, np.float32),
                              n, device="cpu")
    X = _starts(3, n // 128)
    alg = kt.Arnoldi(krylovdim=12, maxiter=3, tol=1e-30)
    calls = []
    real = tpb.project_pallas_batched
    monkeypatch.setattr(tpb, "project_pallas_batched",
                        lambda *a: (calls.append(len(a[0])), real(*a))[1])
    off = kt.eigsolve_arnoldi_batched(band, X, 4, "LM", alg)
    assert calls == []
    monkeypatch.setattr(tbs, "use_pallas_projections", True)
    on = kt.eigsolve_arnoldi_batched(band, X, 4, "LM", alg)
    assert _counts(on[2]) == _counts(off[2])
    # cgs2: two sweeps per step, every problem steps together here
    assert len(calls) == 2 * int(on[2].numops[0]) and set(calls) == {3}
    np.testing.assert_allclose(np.abs(on[0].numpy()), np.abs(off[0].numpy()), rtol=1e-4)
    for p in range(3):
        v1, w1, i1 = ta.eigsolve_arnoldi(band, X[p], 4, "LM", alg)
        assert torch.equal(v1, on[0][p]) and torch.equal(w1, on[1][p])
