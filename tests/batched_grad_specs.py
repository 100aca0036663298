"""Differentiation through the batched drivers on a sharded space, checked
on a one-rank ``vec`` axis (``MeshAxis("vec", None, 1, 0)``: every
collective is the identity, so a sharded solve must give the unsharded
bits).  Shared by the batched test files whose drivers have a rule.

:func:`check_one_rank_axis` holds, for one driver and rule:

* the batched gradient on the one-rank sharded space bit-equal to the
  batched gradient on the unsharded space;
* each problem's gradient bit-equal to its one-problem sharded solve's
  (``kt.linsolve``, ``kt.eigsolve``, ``kt.svdsolve`` with the same
  ``space``): the operators are one ``ParametricOperator`` a problem around
  a shared matrix (``x ↦ M x + g_p⊙x``), applied problem by problem, and a
  shared input's gradient (a linsolve's ``a0``) is the sum of the
  one-problem ones in problem order.
"""

import numpy as np
import torch

import krylovkit_tpu_torch as kt
from krylovkit_tpu_torch.ops.collectives import MeshAxis

N, P = 16, 2
LINEAR = {"linsolve_cg_batched": "CG", "linsolve_gmres_batched": "GMRES",
          "linsolve_minres_batched": "MINRES", "linsolve_bicgstab_batched": "BiCGStab"}
def one_rank_space():
    return kt.VectorSpace(psum_axis=MeshAxis("vec", None, 1, 0))


def _data(driver):
    """The shared matrix (symmetric positive definite; not symmetric for
    the GKL driver), the problems' parameters ``G``,
    right-hand sides or starts ``B`` and loss directions ``C``."""
    rng = np.random.default_rng(sum(map(ord, driver)))
    R = rng.standard_normal((N, N))
    M = R @ R.T / N + np.eye(N)
    if driver == "svdsolve_gkl_batched":
        M = M + 0.3 * rng.standard_normal((N, N))
    return (torch.from_numpy(M), torch.from_numpy(0.3 * rng.standard_normal((P, N))),
            torch.from_numpy(rng.standard_normal((P, N))),
            torch.from_numpy(rng.standard_normal((P, N))))


def _op(M, g):
    """``x ↦ M x + g⊙x`` and its adjoint (an Arnoldi pullback applies them to
    complex vectors)."""
    return kt.ParametricOperator(lambda g, x: M.to(x.dtype) @ x + g * x, g,
                                 lambda g, y: M.T.to(y.dtype) @ y + g * y)


def _alg(driver, eager=False):
    kw = dict(tol=1e-12, krylovdim=N)
    if driver in LINEAR:
        return getattr(kt, LINEAR[driver])(**({"tol": 1e-12, "krylovdim": N}
                                              if driver == "linsolve_gmres_batched"
                                              else {"tol": 1e-12, "maxiter": 200}))
    if driver == "eigsolve_lanczos_batched":
        return kt.Lanczos(eager=eager, **kw)
    if driver == "eigsolve_arnoldi_batched":
        return kt.Arnoldi(eager=eager, **kw)
    return kt.GKL(eager=eager, **kw)


def _loss(driver, out, C):
    """A real loss of the outputs, gauge-invariant for the vectors."""
    if driver in LINEAR:
        return torch.sum(out[0] * C)
    vals, vecs = out[0], out[1:-1]
    loss = torch.sum(vals.real)
    for v in vecs:
        loss = loss + torch.sum(torch.abs(torch.sum(v * C[..., None, :], -1)) ** 2)
    return loss


def _batched(driver, rule, space, eager):
    """The batched solve of every problem differentiated: ``[Ḡ, B̄, ā0]``
    (a linear driver) or ``[Ḡ]``."""
    M, G0, B0, C = _data(driver)
    G = G0.clone().requires_grad_(True)
    ops = [_op(M, G[p]) for p in range(P)]
    alg = _alg(driver, eager)
    fn = getattr(kt, driver)
    if driver in LINEAR:
        B = B0.clone().requires_grad_(True)
        a0 = torch.tensor(0.5, dtype=torch.float64, requires_grad=True)
        out = fn(ops, B, torch.zeros_like(B), a0, 1.0, alg, space, in_dims=(0, 0, 0))
        _loss(driver, out, C).backward()
        return [G.grad, B.grad, a0.grad]
    rrule = kt.Arnoldi(tol=1e-12, krylovdim=N) if rule == "arnoldi" else None
    which = "LR" if driver == "svdsolve_gkl_batched" else "SR"
    out = fn(ops, B0, 2, which, alg, space, in_dims=(0, 0), alg_rrule=rrule)
    _loss(driver, out, C).backward()
    return [G.grad]


def _one_problem(driver, rule, space, p, eager):
    """Problem ``p`` by its one-problem front-end in ``space``: the
    gradients :func:`_batched` gives it (``ā0`` its own part)."""
    M, G0, B0, C = _data(driver)
    g = G0[p].clone().requires_grad_(True)
    op = _op(M, g)
    alg = _alg(driver, eager)
    if driver in LINEAR:
        b = B0[p].clone().requires_grad_(True)
        a0 = torch.tensor(0.5, dtype=torch.float64, requires_grad=True)
        x, info = kt.linsolve(op, b, torch.zeros_like(b), a0, 1.0, alg=alg, space=space)
        torch.sum(x * C[p]).backward()
        return [g.grad, b.grad, a0.grad]
    rrule = kt.Arnoldi(tol=1e-12, krylovdim=N) if rule == "arnoldi" else None
    if driver == "svdsolve_gkl_batched":
        out = kt.svdsolve(op, B0[p], 2, "LR", alg=alg, alg_rrule=rrule, space=space)
    else:
        out = kt.eigsolve(op, B0[p], 2, "SR", alg=alg, alg_rrule=rrule, space=space)
    vals, vecs = out[0], out[1:-1]
    loss = torch.sum(vals.real)
    for v in vecs:
        loss = loss + torch.sum(torch.abs(torch.sum(v * C[p], -1)) ** 2)
    loss.backward()
    return [g.grad]


def check_one_rank_axis(driver, rule=None, eager=False):
    """The two bit-equalities of the module docstring for ``driver`` (one
    of :data:`LINEAR`, ``eigsolve_lanczos_batched``,
    ``eigsolve_arnoldi_batched``, ``svdsolve_gkl_batched``) and ``rule``
    (``None``: the GMRES rule; ``"arnoldi"``: the Sylvester rule)."""
    one = one_rank_space()
    got = _batched(driver, rule, one, eager)
    want = _batched(driver, rule, kt.STANDARD, eager)
    assert all(torch.equal(a, b) for a, b in zip(got, want)), driver
    parts = [_one_problem(driver, rule, one, p, eager) for p in range(P)]
    for p, part in enumerate(parts):
        assert torch.equal(got[0][p], part[0]), (driver, p)
        if driver in LINEAR:
            assert torch.equal(got[1][p], part[1]), (driver, p)
    if driver in LINEAR:
        assert torch.equal(got[2], sum((part[2] for part in parts[1:]), parts[0][2])), driver
