"""The eager batched drivers of ``tests/test_torch_batched_eager*.py``, each
with its JAX driver under ``jax.jit(jax.vmap(...))``, the port's batched
driver and the port's one-problem driver on the same numpy-seeded float64
problems (``P = 3``, ``n <= 30``).

A driver's JAX side is one compiled ``vmap`` over ``(A, x0)`` (``(A, u0,
u1)`` for ``expintegrator``), fed a matrix stack with a repeated start
(the problems stop apart) or a repeated matrix with ``P`` starts (a shared
operator: each problem bit-identical to its one-problem solve), compiled
once per module (``jax_solve``).  The BiArnoldi driver takes the start as
both ``v0`` and ``w0``.
"""

import functools

import numpy as np
import torch

import krylovkit_tpu_torch as kt
from krylovkit_tpu_torch import convert
from krylovkit_tpu_torch.solvers import arnoldi as tarn
from krylovkit_tpu_torch.solvers import biarnoldi as tba
from krylovkit_tpu_torch.solvers import expintegrator as te
from krylovkit_tpu_torch.solvers import svdsolve as tsv
from krylovkit_tpu_torch.solvers.lanczos import eigsolve_lanczos as t_lanczos

P = 3
T_EXP = 0.5
# each driver: (matrix kind, howmany, which, algorithm keywords); the
# non-symmetric ones end within a few rounds, each round a dense Schur step
SPECS = {
    "eigsolve_lanczos_batched": ("sym", 2, "LR", dict(krylovdim=12, tol=1e-10, maxiter=100)),
    "svdsolve_gkl_batched": ("rect", 2, "LR", dict(krylovdim=8, tol=1e-10, maxiter=100)),
    "expintegrator_batched": ("sym", None, None, dict(krylovdim=10, tol=1e-8)),
    "exponentiate_batched": ("sym", None, None, dict(krylovdim=10, tol=1e-8)),
    "schursolve_batched": ("nonsym", 1, "LR", dict(krylovdim=8, tol=1e-8, maxiter=100)),
    "eigsolve_arnoldi_batched": ("nonsym", 1, "LR", dict(krylovdim=8, tol=1e-8, maxiter=100)),
    "realeigsolve_arnoldi_batched": ("nonsym", 1, "LR", dict(krylovdim=8, tol=1e-8, maxiter=100)),
    "bieigsolve_batched": ("nonsym", 1, "LR", dict(krylovdim=8, tol=1e-8, maxiter=100)),
}
SEEDS = {"bieigsolve_batched": 603}  # else 601: seeds whose problems stop apart


def problems(kind, seed=601):
    """``(As (P, m, n), X (P, m), U1 (P, m))``: symmetric 24 × 24, real
    non-symmetric 24 × 24 with a real leading spectrum (a diagonal of 3, 2
    and [0, 1] plus a random part of norm ~0.4: an eager solve processes
    after every step, so each converges within a few rounds), or 30 × 20
    rectangular matrices; starts in the codomain."""
    rng = np.random.default_rng(seed)
    m, n = (30, 20) if kind == "rect" else (24, 24)
    As = np.stack([rng.standard_normal((m, n)) for _ in range(P)])
    if kind == "sym":
        As = (As + As.transpose(0, 2, 1)) / 8
    elif kind == "nonsym":
        d = np.linspace(0.0, 1.0, n)
        d[-2:] = (2.0, 3.0)
        As = As * 0.2 / np.sqrt(n) + np.diag(d)[None]
    return As, rng.standard_normal((P, m)), rng.standard_normal((P, m))


def counts(info):
    return [np.asarray(info.numops).tolist(), np.asarray(info.numiter).tolist(),
            np.asarray(info.converged).tolist()]


def _alg(name):
    kw = {**SPECS[name][3], "eager": True}
    if name in ("eigsolve_lanczos_batched", "expintegrator_batched", "exponentiate_batched"):
        return kt.Lanczos(**kw)
    if name == "svdsolve_gkl_batched":
        return kt.GKL(**kw)
    if name == "bieigsolve_batched":
        return kt.BiArnoldi(**kw)
    return kt.Arnoldi(**kw)


@functools.lru_cache(maxsize=None)
def jax_solve(name):
    """``jax.jit(jax.vmap(f))`` of the JAX driver ``f(A, x0[, u1])``, giving
    ``(values, info)``."""
    import jax
    from krylovkit_tpu import GKL as JGKL
    from krylovkit_tpu import Arnoldi as JArnoldi
    from krylovkit_tpu import BiArnoldi as JBiArnoldi
    from krylovkit_tpu import Lanczos as JLanczos
    from krylovkit_tpu.ops.operator import MatrixOperator as JM
    from krylovkit_tpu.ops.vector import STANDARD as JSTANDARD
    from krylovkit_tpu.solvers import arnoldi as ja
    from krylovkit_tpu.solvers.biarnoldi import bieigsolve_driver
    from krylovkit_tpu.solvers.expintegrator import _expintegrator_core
    from krylovkit_tpu.solvers.lanczos import eigsolve_lanczos
    from krylovkit_tpu.solvers.svdsolve import svdsolve_gkl

    _, howmany, which, kw = SPECS[name]
    kw = {**kw, "eager": True}

    def f(A, x, u1):
        op = JM(A)
        if name == "eigsolve_lanczos_batched":
            vals, _, info = eigsolve_lanczos(op, x, howmany, which, JLanczos(**kw))
        elif name == "svdsolve_gkl_batched":
            vals, _, _, info = svdsolve_gkl(op, x, howmany, which, JGKL(**kw))
        elif name == "expintegrator_batched":
            vals, info = _expintegrator_core(op, T_EXP, (x, u1), JLanczos(**kw), JSTANDARD)
        elif name == "exponentiate_batched":
            vals, info = _expintegrator_core(op, T_EXP, (x,), JLanczos(**kw), JSTANDARD)
        elif name == "schursolve_batched":
            _, _, vals, info = ja.schursolve(op, x, howmany, which, JArnoldi(**kw))
        elif name == "eigsolve_arnoldi_batched":
            vals, _, info = ja.eigsolve_arnoldi(op, x, howmany, which, JArnoldi(**kw))
        elif name == "realeigsolve_arnoldi_batched":
            vals, _, info = ja.realeigsolve_arnoldi(op, x, howmany, which, JArnoldi(**kw))[:3]
        else:
            vals, _, (info, _) = bieigsolve_driver(op, x, x, howmany, which, JBiArnoldi(**kw))
        return vals, info

    return jax.jit(jax.vmap(f))


def port_batched(name, op, X, U1, dims):
    """The port's batched driver: ``(values, outputs, info)``, ``outputs``
    every tensor output (for the bits)."""
    _, howmany, which, _ = SPECS[name]
    alg = _alg(name)
    if name == "eigsolve_lanczos_batched":
        vals, vecs, info = kt.eigsolve_lanczos_batched(op, X, howmany, which, alg, in_dims=dims)
        return vals, (vals, vecs, info.residual, info.normres), info
    if name == "svdsolve_gkl_batched":
        S, U, V, info = kt.svdsolve_gkl_batched(op, X, howmany, which, alg, in_dims=dims)
        return S, (S, U, V, info.residual, info.normres), info
    if name == "expintegrator_batched":
        y, info = kt.expintegrator_batched(op, T_EXP, (X, U1), alg,
                                           in_dims=(dims[0], None, dims[1]))
        return y, (y, info.normres), info
    if name == "exponentiate_batched":
        y, info = kt.exponentiate_batched(op, T_EXP, X, alg, in_dims=(dims[0], None, dims[1]))
        return y, (y, info.normres), info
    if name == "schursolve_batched":
        T, V, vals, info = kt.schursolve_batched(op, X, howmany, which, alg, in_dims=dims)
        return vals, (T, V, *vals, info.residual, info.normres), info
    if name in ("eigsolve_arnoldi_batched", "realeigsolve_arnoldi_batched"):
        out = getattr(kt, name)(op, X, howmany, which, alg, in_dims=dims)
        return out[0], (out[0], out[1], out[2].residual, out[2].normres), out[2]
    vals, (V, W), (iV, iW) = kt.bieigsolve_batched(op, X, X, howmany, which, alg,
                                                   in_dims=(dims[0], dims[1], dims[1]))
    return vals, (vals, V, W, iV.residual, iV.normres, iW.residual), iV


def port_one(name, A, x, u1):
    """The port's one-problem driver on ``A`` (a tensor): ``(values,
    outputs, info)`` as :func:`port_batched` gives a problem's."""
    _, howmany, which, _ = SPECS[name]
    alg = _alg(name)
    op = kt.as_operator(A)
    if name == "eigsolve_lanczos_batched":
        vals, vecs, info = t_lanczos(op, x, howmany, which, alg)
        return vals, (vals, vecs, info.residual, info.normres), info
    if name == "svdsolve_gkl_batched":
        S, U, V, info = tsv.svdsolve_gkl(op, x, howmany, which, alg)
        return S, (S, U, V, info.residual, info.normres), info
    if name in ("expintegrator_batched", "exponentiate_batched"):
        u = (x, u1) if name == "expintegrator_batched" else (x,)
        y, info = te._expintegrator_core(op, T_EXP, u, alg, kt.STANDARD)
        return y, (y, info.normres), info
    if name == "schursolve_batched":
        T, V, vals, info = tarn.schursolve(op, x, howmany, which, alg)
        return vals, (T, V, *vals, info.residual, info.normres), info
    if name in ("eigsolve_arnoldi_batched", "realeigsolve_arnoldi_batched"):
        one = tarn.eigsolve_arnoldi if name == "eigsolve_arnoldi_batched" else \
            tarn.realeigsolve_arnoldi
        out = one(op, x, howmany, which, alg)
        return out[0], (out[0], out[1], out[2].residual, out[2].normres), out[2]
    vals, (V, W), (iV, iW) = tba.bieigsolve_driver(op, x, x, howmany, which, alg)
    return vals, (vals, V, W, iV.residual, iV.normres, iW.residual), iV


def _host(v):
    """Values as one complex or real numpy array (``(re, im)`` joined)."""
    if isinstance(v, tuple):
        return np.asarray(v[0]) + 1j * np.asarray(v[1])
    return np.asarray(v)


def check_against_jax(name, case):
    """One case of a driver: ``"matrix_stack"`` (the matrices batched, one
    start: the problems stop apart; each problem's values within 1e-12 of
    its one-problem solve's, its vectors free to differ in sign) or
    ``"shared_matrix"`` (one matrix, ``P`` starts: each problem
    bit-identical to its one-problem solve).  Values within
    1e-10 of the vmapped JAX driver, ``numops``, ``numiter`` and
    ``converged`` equal."""
    import jax.numpy as jnp

    As, X, U1 = problems(SPECS[name][0], SEEDS.get(name, 601))
    if case == "matrix_stack":
        jA, jX, jU = As, np.repeat(X[:1], P, 0), np.repeat(U1[:1], P, 0)
        op, x0, u1 = convert.matrices_from_numpy(As, "cpu"), X[0], U1[0]
        dims = (0, None)
    else:
        jA, jX, jU = np.repeat(As[:1], P, 0), X, U1
        op, x0, u1 = torch.from_numpy(As[0]), X, U1
        dims = (None, 0)
    jv, ji = jax_solve(name)(jnp.asarray(jA), jnp.asarray(jX), jnp.asarray(jU))
    vals, outs, info = port_batched(name, op, torch.from_numpy(x0), torch.from_numpy(u1), dims)
    tv = _host(tuple(v.numpy() for v in vals) if isinstance(vals, tuple) else vals.numpy())
    np.testing.assert_allclose(tv, _host(tuple(jv) if isinstance(jv, tuple) else jv), rtol=0,
                               atol=1e-10)
    assert counts(info) == counts(ji), (counts(info), counts(ji))
    if case == "matrix_stack":
        assert len(set(counts(info)[0])) > 1, counts(info)  # the problems stop apart
    for p in range(P):
        A = torch.from_numpy(As[p] if case == "matrix_stack" else As[0])
        xp = torch.from_numpy(X[0] if case == "matrix_stack" else X[p])
        up = torch.from_numpy(U1[0] if case == "matrix_stack" else U1[p])
        v1, outs1, i1 = port_one(name, A, xp, up)
        assert [c[p] for c in counts(info)] == [i1.numops, i1.numiter, i1.converged]
        if case == "shared_matrix":
            assert all(torch.equal(o[p], o1) for o, o1 in zip(outs, outs1)), name
        else:
            np.testing.assert_allclose(_host(tuple(v[p].numpy() for v in vals)
                                             if isinstance(vals, tuple) else vals[p].numpy()),
                                       _host(tuple(v.numpy() for v in v1)
                                             if isinstance(v1, tuple) else v1.numpy()),
                                       rtol=0, atol=1e-12)
    return counts(info)
