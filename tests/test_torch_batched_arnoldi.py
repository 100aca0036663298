"""PyTorch port: batched Krylov-Schur Arnoldi (``solvers/batched_arnoldi.py``)
against ``jax.jit(jax.vmap(...))`` of the JAX package's ``schursolve``,
``eigsolve_arnoldi`` and ``realeigsolve_arnoldi`` on stacks of three float64
matrices and one shared start (``in_dims=(0, None)``), the WARN lines and
the refusals.  The shared-operator paths (one-problem equality, the fused
float32 solve, the projection flag) are in
``tests/test_torch_batched_arnoldi_fused.py``.

Tolerances, stated per test: float64 values 1e-10 against the JAX package
(Schur vectors up to phase: through ``‖A Vᵀ − Vᵀ T‖`` and ``|diag T|``),
counts always exactly equal.
"""

import contextlib
import dataclasses
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krylovkit_tpu import Arnoldi as JArnoldi
from krylovkit_tpu.ops.operator import MatrixOperator as JMatrixOperator
from krylovkit_tpu.solvers import arnoldi as ja
import chip_smoke
import krylovkit_tpu_torch as kt
from krylovkit_tpu_torch import convert
from krylovkit_tpu_torch.ops.collectives import MeshAxis
from krylovkit_tpu_torch.solvers import arnoldi as tarn

torch.set_num_threads(2)

N = 24
NONSYM = ((-1, 0, 1), (-1.3, 2.0, -0.7))


def _talg(jalg):
    return convert.arnoldi_from_dict({**dataclasses.asdict(jalg), "orth": type(jalg.orth).__name__})


def _counts(info):
    return [np.asarray(info.numops).tolist(), np.asarray(info.numiter).tolist(),
            np.asarray(info.converged).tolist()]


def _real_spectrum(rng, shift=0.0):
    """A non-normal ``N × N`` float64 matrix with the real spectrum
    ``linspace(-1, 3) + shift``."""
    S = np.eye(N) + 0.2 * rng.standard_normal((N, N))
    return S @ np.diag(np.linspace(-1, 3, N) + shift) @ np.linalg.inv(S)


def _problems(kind):
    """Three ``N × N`` float64 matrices and one shared start: general
    (complex pairs), or with real spectra for ``realeigsolve``."""
    rng = np.random.default_rng(31)
    if kind == "real":
        As = np.stack([_real_spectrum(rng, s) for s in (0.0, 0.5, -0.3)])
    else:
        As = rng.standard_normal((3, N, N)) / N ** 0.5
    return As, rng.standard_normal(N)


def _jax_vmap(driver, As, x0, howmany, which, jalg):
    f = jax.jit(jax.vmap(lambda A: driver(JMatrixOperator(A), jnp.asarray(x0), howmany, which,
                                          jalg)))
    return f(jnp.asarray(As))


def _match(got, want, atol):
    """Each wanted value has a got value within ``atol`` (conjugate pairs
    may come in either order)."""
    got = np.array(got, dtype=complex)
    for w in np.asarray(want, dtype=complex):
        i = int(np.argmin(np.abs(got - w)))
        assert abs(got[i] - w) <= atol, (got, want)
        got[i] = np.inf


JALG = JArnoldi(krylovdim=16, tol=1e-10, maxiter=60)


def test_vmap_of_schursolve_matches_jax():
    """``schursolve`` on a stack of three general float64 matrices
    (``in_dims=(0, None)``; the two wanted values of each are a conjugate
    pair, so no 2×2 block straddles ``howmany``): counts equal per problem,
    eigenvalues and ``|diag T|`` within 1e-10, and each problem's Schur
    relation ``A Vᵀ = Vᵀ T`` within 1e-8 (the vectors agree up to phase)."""
    As, x0 = _problems("general")
    Tj, _, (rej, imj), ij = _jax_vmap(ja.schursolve, As, x0, 2, "LM", JALG)
    ops = convert.matrices_from_numpy(As, "cpu")
    T, V, (re_, im_), it = kt.schursolve_batched(ops, torch.from_numpy(x0), 2, "LM",
                                                 _talg(JALG), in_dims=(0, None))
    assert _counts(it) == _counts(ij) and it.converged.tolist() == [2, 2, 2]
    assert T.shape == (3, 2, 2) and V.shape == (3, 2, N) and re_.shape == (3, 2)
    assert it.numops.dtype == torch.int64 and it.normres.shape == (3, 2)
    for p in range(3):
        _match(re_[p].numpy() + 1j * im_[p].numpy(), np.asarray(rej[p]) + 1j * np.asarray(imj[p]),
               1e-10)
        np.testing.assert_allclose(np.sort(np.abs(np.diag(T[p].numpy()))),
                                   np.sort(np.abs(np.diag(np.asarray(Tj[p])))), atol=1e-10)
        Vm = V[p].numpy().T
        assert np.linalg.norm(As[p] @ Vm - Vm @ T[p].numpy()) < 1e-8
        np.testing.assert_allclose(Vm.T @ Vm, np.eye(2), atol=1e-12)


def test_vmap_of_eigsolve_arnoldi_matches_jax():
    """``eigsolve_arnoldi`` on the general stack: counts equal, complex
    eigenvalues within 1e-10, each eigenvector equation within 1e-8."""
    As, x0 = _problems("general")
    vj, _, ij = _jax_vmap(ja.eigsolve_arnoldi, As, x0, 4, "LR", JALG)
    vals, vecs, it = kt.eigsolve_arnoldi_batched(convert.matrices_from_numpy(As, "cpu"),
                                                 torch.from_numpy(x0), 4, "LR", _talg(JALG),
                                                 in_dims=(0, None))
    assert _counts(it) == _counts(ij)
    assert vals.dtype == torch.complex128 and vecs.shape == (3, 4, N)
    for p in range(3):
        _match(vals[p].numpy(), np.asarray(vj[p]), 1e-10)
        X = vecs[p].numpy().T
        assert np.max(np.abs(As[p] @ X - X * vals[p].numpy())) < 1e-8


def test_vmap_of_realeigsolve_matches_jax():
    """``realeigsolve_arnoldi`` on three matrices with real spectra: counts
    equal, real eigenvalues within 1e-10, ``maximag`` zero, each
    eigenvector equation within 1e-8."""
    As, x0 = _problems("real")
    vj, _, ij, mj = _jax_vmap(ja.realeigsolve_arnoldi, As, x0, 3, "LR", JALG)
    vals, vecs, it, mi = kt.realeigsolve_arnoldi_batched(
        convert.matrices_from_numpy(As, "cpu"), torch.from_numpy(x0), 3, "LR", _talg(JALG),
        in_dims=(0, None))
    assert _counts(it) == _counts(ij)
    np.testing.assert_allclose(vals.numpy(), np.asarray(vj), rtol=0, atol=1e-10)
    assert not mi.any() and not np.asarray(mj).any()
    for p in range(3):
        X = vecs[p].numpy().T
        assert np.max(np.abs(As[p] @ X - X * vals[p].numpy())) < 1e-8


_NUM = re.compile(r"[-+]?\d+\.\d+(?:e[-+]?\d+)?")


def _capture(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
        jax.effects_barrier()
    return [line for line in buf.getvalue().splitlines() if line.strip()]


def test_realeigsolve_warn_lines_match_jax_vmap():
    """At WARN, one "complex conjugate pair" line per offending problem
    (two of three here), with that problem's ``max |imag|``: the same texts
    as the JAX package's vmapped ``warn_if`` (sorted: its callbacks need not
    print in problem order), the numbers within 1e-10 relative."""
    rng = np.random.default_rng(3)
    As = np.stack([_real_spectrum(rng) for _ in range(3)])
    As[1:, :2, :2] += [[0.0, 4.0], [-4.0, 0.0]]
    x0 = rng.standard_normal(N)
    jalg = JArnoldi(krylovdim=12, tol=1e-10, maxiter=40, verbosity=1)
    jlines = _capture(lambda: np.asarray(_jax_vmap(ja.realeigsolve_arnoldi, As, x0, 2, "LM",
                                                   jalg)[3]))
    tlines = _capture(lambda: kt.realeigsolve_arnoldi_batched(
        convert.matrices_from_numpy(As, "cpu"), torch.from_numpy(x0), 2, "LM", _talg(jalg),
        in_dims=(0, None)))
    assert len(tlines) == len(jlines) == 2

    def key(line):
        return _NUM.sub("#", line), float(_NUM.search(line).group())

    tk, jk = sorted(map(key, tlines), key=lambda t: t[1]), sorted(map(key, jlines),
                                                                   key=lambda t: t[1])
    assert [t for t, _ in tk] == [t for t, _ in jk]
    np.testing.assert_allclose([v for _, v in tk], [v for _, v in jk], rtol=1e-10)
    assert "complex conjugate pair" in tlines[0]


def test_batched_arnoldi_refusals():
    """Each piece this slice does not batch raises ``ValueError`` with its
    name: differentiation of ``schursolve``, which has no rule.  A sharded
    space is batched: on a one-rank axis, the unsharded bits, a dict batch
    too; so is ``Arnoldi(eager=True)``: each problem its one-problem eager
    solve, bit for bit."""
    top = convert.stencil_from_arrays(*NONSYM, "cpu")
    X = chip_smoke.batched_starts(torch, np, 16, 2, "cpu")
    alg = kt.Arnoldi(krylovdim=10)
    one = kt.VectorSpace(psum_axis=MeshAxis("vec", None, 1, 0))
    cases = [
        (lambda: kt.schursolve_batched(top, X.clone().requires_grad_(True), 1, "LM", alg),
         "schursolve_batched: differentiation has no rule"),
        (lambda: kt.eigsolve_arnoldi_batched(top, X, 1, "LM", alg, in_dims=(None, None)),
         "in_dims"),
        (lambda: kt.schursolve_batched([top], X, 1, "LM", alg, in_dims=(0, 0)), "disagree"),
        (lambda: kt.schursolve_batched(top, X, 11, "LM", alg), "krylovdim"),
        (lambda: kt.realeigsolve_arnoldi_batched(top, X.to(torch.complex64), 1, "LM", alg),
         "real"),
    ]
    for call, word in cases:
        with pytest.raises(ValueError, match=word):
            call()
    # a sharded space is batched: on a one-rank axis (no collective) each
    # problem solves as on the unsharded space, bit for bit
    short = kt.Arnoldi(krylovdim=10, maxiter=2)
    # a dict batch: each problem is its one-problem dict Schur solve, bit for bit
    dict_op = kt.as_operator(lambda x: {"a": top.normal(x["a"])})
    T, V, (re_, im_), info = kt.schursolve_batched(dict_op, {"a": X}, 1, "LM", short)
    for p in range(2):
        T1, V1, (re1, im1), i1 = kt.schursolve(dict_op, {"a": X[p]}, 1, "LM", short)
        assert torch.equal(T[p], T1) and torch.equal(V["a"][p], V1["a"])
        assert torch.equal(re_[p], re1) and int(info.numops[p]) == i1.numops
    T1, V1, (re1, _), info1 = kt.schursolve_batched(dict_op, {"a": X}, 1, "LM", short, one)
    assert torch.equal(T1, T) and torch.equal(V1["a"], V["a"]) and torch.equal(re1, re_)
    assert torch.equal(info1.numops, info.numops)
    eager = kt.Arnoldi(krylovdim=10, maxiter=2, eager=True)
    vals, vecs, info = kt.realeigsolve_arnoldi_batched(top, X, 1, "LM", eager)[:3]
    for p in range(2):
        v1, w1, i1 = tarn.realeigsolve_arnoldi(top, X[p], 1, "LM", eager)[:3]
        assert torch.equal(vals[p], v1) and torch.equal(vecs[p], w1)
        assert int(info.numops[p]) == i1.numops
    got = kt.eigsolve_arnoldi_batched(top, X, 1, "LM", short, space=one)
    want = kt.eigsolve_arnoldi_batched(top, X, 1, "LM", short)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[2].numops, want[2].numops)
