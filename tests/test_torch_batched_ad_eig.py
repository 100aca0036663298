"""PyTorch port: gradients through ``eigsolve_lanczos_batched`` by
``eigsolve``'s GMRES rule (``ad/batched.py``: the ``P × howmany`` bordered
systems in one batched GMRES) against ``jax.grad`` of the sum over
``jax.vmap`` of the JAX package's ``eigsolve`` with the same algorithms, on
the CPU.  The Sylvester rule (``P`` eigensolves on ``(w, x)`` tuples in one
batched Arnoldi) is in ``test_torch_batched_ad_eig_sylvester.py``, the
batched Arnoldi eigsolve's rules in ``..._eig_arnoldi.py`` and
``..._eig_general.py``, the GKL svdsolve's in ``..._svd.py`` and
``..._svd_sylvester.py`` (one JAX compile of 5–14 s a rule, so each file
stays near 20 s on one worker); this file holds the helpers they share.

Each rule's JAX reference is compiled once (``lru_cache``) and takes the
matrices as data: ``P`` matrices (a sequence of operators, ``in_dims`` 0)
and one matrix repeated (a shared operator, whose gradient is the sum over
the problems).  The loss takes the values and the first eigenvector's
first entry (``|v₀[0]|²``, gauge-free).  The complex128 case of each rule is
held against the port's one-problem ``eigsolve`` gradient, which
``tests/test_torch_ad.py::test_ad_complex_routes_match_jax`` holds against
the JAX package.

Tolerances: every gradient within :data:`TOL` of JAX's (relative to the
largest entry); each problem's within :data:`TOL_ONE` of its one-problem
``kt.eigsolve`` gradient (the batched applies of a matrix sequence round
otherwise than one matrix's); the forward's counts and the backward's
inner-solve counts equal to the one-problem solves'.
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import krylovkit_tpu as kk
import krylovkit_tpu_torch as kt
from krylovkit_tpu_torch.solvers import arnoldi as tarn
from krylovkit_tpu_torch.solvers import batched as tb
from krylovkit_tpu_torch.solvers import batched_arnoldi as tba
from krylovkit_tpu_torch.solvers import linsolve as tlin

N, P = 16, 2
TOL = 1e-10
TOL_ONE = 1e-12
# (howmany, which) and the Sylvester rule's inner Arnoldi of each primal
SPEC = {"lanczos": (2, "SR"), "arnoldi": (1, "LR"), "gkl": (2, "LR")}
RRULE = {"lanczos": {"tol": 1e-12, "krylovdim": 30, "maxiter": 100},
         "arnoldi": {"tol": 1e-12, "krylovdim": 30, "maxiter": 100},
         "gkl": {"tol": 1e-12, "krylovdim": 40, "maxiter": 200}}


def data(kind, dtype=np.float64, seed=0):
    """``P`` matrices and starts of ``kind``: Hermitian (``lanczos``), a
    graded general matrix (``arnoldi``), a ``2N × N`` rectangle (``gkl``:
    its starts in the codomain)."""
    rng = np.random.default_rng(seed)

    def rand(shape):
        a = rng.standard_normal(shape)
        return a + 1j * rng.standard_normal(shape) if np.dtype(dtype).kind == "c" else a

    if kind == "lanczos":
        As = np.stack([(lambda H: (H + H.conj().T) / 2)(rand((N, N))) for _ in range(P)])
    elif kind == "arnoldi":
        As = np.stack([rand((N, N)) / 4 + np.diag(np.linspace(1, 2, N)) for _ in range(P)])
    else:
        As = np.stack([rand((2 * N, N)) for _ in range(P)])
    return As.astype(dtype), rand((P, As.shape[1])).astype(dtype)


def _alg(lib, kind):
    kw = {"tol": 1e-12, "krylovdim": N}
    if kind == "gkl":
        return lib.GKL(maxiter=100, **kw)
    return (lib.Lanczos if kind == "lanczos" else lib.Arnoldi)(**kw)


def _loss(lib, kind, out):
    """The loss of one problem's solve (``lib`` ``jnp`` or ``torch``)."""
    if kind == "gkl":
        s, U, V = out[:3]
        return lib.sum(s) + lib.real(U[0, 0] * V[0, 1])
    vals, vecs = out[:2]
    if kind == "lanczos":
        return vals[0] + 0.5 * vals[1] + lib.abs(vecs[0, 0]) ** 2
    return lib.real(vals[0]) + 0.7 * lib.imag(vals[0]) + lib.abs(vecs[0, 0]) ** 2


@lru_cache(maxsize=None)
def _jax_grad(kind, sylvester):
    """``jax.grad`` of the sum of the losses over ``jax.vmap`` of the JAX
    front-end (the matrices' gradient), compiled once."""
    howmany, which = SPEC[kind]
    alg = _alg(kk, kind)
    rr = kk.Arnoldi(**RRULE[kind]) if sylvester else None

    def loss(As, X0):
        def one(A, x):
            if kind == "gkl":
                out = kk.svdsolve(A, x, howmany, which, alg=alg, alg_rrule=rr)
            else:
                out = kk.eigsolve(A, x, howmany, which, alg=alg, alg_rrule=rr)
            return _loss(jnp, kind, out)

        return jnp.sum(jax.vmap(one)(As, X0))

    return jax.jit(jax.grad(loss))


def jax_grad(kind, sylvester, As, X0):
    return np.asarray(_jax_grad(kind, sylvester)(jnp.asarray(As), jnp.asarray(X0)))


def _batched_driver(kind):
    return {"lanczos": kt.eigsolve_lanczos_batched, "arnoldi": kt.eigsolve_arnoldi_batched,
            "gkl": kt.svdsolve_gkl_batched}[kind]


def _rrule(kind, sylvester):
    return kt.Arnoldi(**RRULE[kind]) if sylvester else None


def batched(kind, sylvester, As, X0, shared=False):
    """The batched solve differentiated: ``(grad, info)``, the gradient of
    the stack (or of the shared matrix)."""
    howmany, which = SPEC[kind]
    S = torch.tensor(As[0] if shared else As, requires_grad=True)
    ops = S if shared else [kt.MatrixOperator(S[p]) for p in range(P)]
    out = _batched_driver(kind)(ops, torch.from_numpy(X0), howmany, which, _alg(kt, kind),
                                in_dims=(None if shared else 0, 0),
                                alg_rrule=_rrule(kind, sylvester))
    loss = 0
    for p in range(P):
        loss = loss + _loss(torch, kind, [o[p] for o in out[:-1]])
    loss.backward()
    return S.grad, out[-1]


def one_problem(kind, sylvester, A, x0):
    """One problem's ``kt.eigsolve``/``kt.svdsolve`` differentiated:
    ``(grad, info)``."""
    howmany, which = SPEC[kind]
    At = torch.tensor(A, requires_grad=True)
    front = kt.svdsolve if kind == "gkl" else kt.eigsolve
    out = front(At, torch.from_numpy(x0), howmany, which, alg=_alg(kt, kind),
                alg_rrule=_rrule(kind, sylvester))
    _loss(torch, kind, out).backward()
    return At.grad, out[-1]


@pytest.fixture
def inner_infos(monkeypatch):
    """The ``info`` of every inner solve of a backward, recorded in call
    order: the batched rules' GMRES and Arnoldi drivers (``batched``; the
    batched Arnoldi eigsolve's forward passes there too) and the
    one-problem rules' ``_linsolve_impl`` and ``eigsolve_arnoldi``
    (``one``)."""
    seen = {"batched": [], "one": []}

    def recording(module, name, key):
        fn = getattr(module, name)

        def rec(*a, **kw):
            out = fn(*a, **kw)
            seen[key].append(out[-1])
            return out

        monkeypatch.setattr(module, name, rec)

    recording(tb, "linsolve_gmres_batched", "batched")
    recording(tba, "eigsolve_arnoldi_batched", "batched")
    recording(tlin, "_linsolve_impl", "one")
    recording(tarn, "eigsolve_arnoldi", "one")
    return seen


def counts(info):
    return [np.atleast_1d(np.asarray(getattr(info, k))).tolist()
            for k in ("numops", "numiter", "converged")]


def close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.detach().numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, np.abs(want).max()))


def check_rule(kind, sylvester, inner_infos, dtype=np.float64, shared=False):
    """The batched gradient against JAX (real ``dtype``) and against each
    problem's one-problem gradient, with the forward's and the backward's
    counts."""
    As, X0 = data(kind, dtype, seed=1 if shared else 0)
    if shared:
        As = np.stack([As[0]] * P)
    g, info = batched(kind, sylvester, As, X0, shared)
    back = inner_infos["batched"][-1]
    if np.dtype(dtype).kind != "c":
        want = jax_grad(kind, sylvester, As, X0)
        close(g, want.sum(0) if shared else want)
    inner_infos["one"].clear()
    total, fwd_counts = 0, []
    for p in range(P):
        g1, info1 = one_problem(kind, sylvester, As[p], X0[p])
        if not shared:
            close(g[p], g1, TOL_ONE)
        total = total + g1
        fwd_counts.append([c[0] for c in counts(info1)])
    if shared:
        close(g, total, TOL_ONE)
    assert [list(c) for c in zip(*counts(info))] == fwd_counts
    ones = [counts(i) for i in inner_infos["one"]]
    assert [list(c) for c in zip(*counts(back))] == [[c[0] for c in o] for o in ones]


@pytest.mark.parametrize("shared", [False, True], ids=["sequence", "shared"])
def test_batched_lanczos_gmres_rule_matches_jax(shared, inner_infos):
    """``eigsolve_lanczos_batched`` of ``P`` Hermitian float64 matrices (a
    sequence, or one shared), the two lowest values and the first
    eigenvector, through the GMRES rule: within :data:`TOL` of ``jax.grad``
    over ``jax.vmap``; each problem within :data:`TOL_ONE` of its
    one-problem gradient; the backward's ``P × 2`` bordered systems in one
    batched GMRES with the one-problem rule's counts."""
    check_rule("lanczos", False, inner_infos, shared=shared)


def test_batched_lanczos_gmres_rule_complex_matches_one_problem(inner_infos):
    """The complex128 Hermitian case: each problem's batched gradient within
    :data:`TOL_ONE` of its one-problem gradient, with the forward's and the
    backward's counts."""
    check_rule("lanczos", False, inner_infos, dtype=np.complex128)
