"""PyTorch port: the verbosity contract of ``tests/test_verbosity.py``
(the reference's ``@test_logs``, ``test/eigsolve.jl:15-60`` and
``test/linsolve.jl:18-43``), held in both packages on the same seeded
problems: the exact number of lines per verbosity level (``:77``) and per
expansion (``:93``, ``:109``), and for a wider set of solvers the number of
lines of each message kind at every level.

A line's kind is its text with the numbers and printed arrays taken out.
Counts per kind are compared, not the order of the lines, nor the numbers:
an Arnoldi iteration may print the residual norms of a complex-conjugate
pair in the other order in the two packages (their small Schur solvers
pick the order of a pair each their own way), with values and counts
equal.
"""

import collections
import contextlib
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import krylovkit_tpu as kk
import krylovkit_tpu_torch as kt
from krylovkit_tpu.info import EACHITERATION, SILENT, STARTSTOP, WARN
from testsetup import hermitize, n, rand_mat, rand_vec

torch.set_num_threads(2)

PACKAGES = {"jax": (kk, jnp.asarray), "port": (kt, lambda a: torch.from_numpy(np.asarray(a)))}


def _capture(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
        jax.effects_barrier()
    return buf.getvalue()


def _lines(out):
    return [line for line in out.splitlines() if line.strip()]


ARRAY = re.compile(r"\[[^\]]*\]")  # a printed array, which may wrap over lines
NUMBER = re.compile(r"[-+]?(\d+\.?\d*|\.\d+)([eE][-+]?\d+)?j?")


def _kinds(out):
    """The count of each message kind: a message with its arrays and
    numbers replaced by ``#``."""
    return collections.Counter(NUMBER.sub("#", line) for line in _lines(ARRAY.sub("#", out)))


def _eig(pkg, verbosity, maxiter=50, tol=1e-10, krylovdim=n):
    mod, arr = PACKAGES[pkg]
    rng = np.random.default_rng(91)
    A = hermitize(rand_mat(rng, n, n, np.float64))
    x0 = rand_vec(rng, n, np.float64)
    alg = mod.Lanczos(krylovdim=krylovdim, tol=tol, maxiter=maxiter, verbosity=verbosity)
    return mod.eigsolve(arr(A), arr(x0), 2, "LR", ishermitian=True, alg=alg)


def _gmres(pkg, verbosity):
    mod, arr = PACKAGES[pkg]
    rng = np.random.default_rng(93)
    A = rand_mat(rng, n, n, np.float64) + 2 * np.eye(n)
    b = rand_vec(rng, n, np.float64)
    return mod.linsolve(arr(A), arr(b),
                        alg=mod.GMRES(tol=1e-10, krylovdim=n, maxiter=10, verbosity=verbosity))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_silent_and_warn_are_quiet_on_success(pkg):
    assert _capture(lambda: _eig(pkg, SILENT)) == ""
    assert _capture(lambda: _eig(pkg, WARN)) == ""


@pytest.mark.parametrize("pkg", PACKAGES)
def test_warn_on_failure(pkg):
    out = _capture(lambda: _eig(pkg, WARN, maxiter=1, tol=1e-30, krylovdim=5))
    assert "without convergence" in out
    assert len(_lines(out)) == 1


def test_exact_log_counts_per_level():
    """``tests/test_verbosity.py:77``: 0, 0 and 1 lines at SILENT, WARN and
    STARTSTOP; at EACHITERATION one iteration line and one finished line,
    in both packages, each kind alike."""
    for verbosity, want in ((SILENT, 0), (WARN, 0), (STARTSTOP, 1)):
        outs = {pkg: _capture(lambda p=pkg: _eig(p, verbosity)) for pkg in PACKAGES}
        for pkg, out in outs.items():
            assert len(_lines(out)) == want, (pkg, verbosity, out)
        assert _kinds(outs["jax"]) == _kinds(outs["port"])
    outs = {pkg: _capture(lambda p=pkg: _eig(p, EACHITERATION)) for pkg in PACKAGES}
    for pkg, out in outs.items():
        lines = _lines(out)
        assert sum("in iteration" in line for line in lines) == 1, (pkg, out)
        assert sum("finished" in line for line in lines) == 1, (pkg, out)
        assert len(lines) == 2, (pkg, out)
    assert _kinds(outs["jax"]) == _kinds(outs["port"])


def test_per_expansion_log_level():
    """``tests/test_verbosity.py:93``: at EACHITERATION + 1 the Lanczos
    driver prints one line per expansion, ``numops`` of them, in both."""
    kinds = {}
    for pkg in PACKAGES:
        box = {}

        def run(p=pkg):
            box["numops"] = int(_eig(p, EACHITERATION + 1)[2].numops)

        out = _capture(run)
        nexp = sum("Lanczos expansion to dimension" in line for line in _lines(out))
        assert nexp == box["numops"], (pkg, nexp, box, out)
        kinds[pkg] = _kinds(out)
    assert kinds["jax"] == kinds["port"]


def test_per_expansion_log_level_gmres():
    """``tests/test_verbosity.py:109``: GMRES at EACHITERATION + 1 prints
    between one and ``numops`` expansion lines, as many in both."""
    kinds = {}
    for pkg in PACKAGES:
        box = {}

        def run(p=pkg):
            box["numops"] = int(_gmres(p, EACHITERATION + 1)[1].numops)

        out = _capture(run)
        nexp = sum("Krylov expansion to dimension" in line for line in _lines(out))
        assert 1 <= nexp <= box["numops"], (pkg, nexp, box, out)
        assert "GMRES linsolve finished" in out
        kinds[pkg] = _kinds(out)
    assert kinds["jax"] == kinds["port"]


def _solvers(pkg, verbosity):
    """Solvers of the re-anchor's probe on one seeded problem of size 60
    (float64; restarts with ``krylovdim`` 12)."""
    mod, arr = PACKAGES[pkg]
    m = 60
    rng = np.random.default_rng(94)
    A = rand_mat(rng, m, m, np.float64) + 2 * np.eye(m)
    H = hermitize(rand_mat(rng, m, m, np.float64)) + 3 * np.eye(m)
    R = rand_mat(rng, m + 10, m, np.float64)
    x0 = rand_vec(rng, m, np.float64)
    b = rand_vec(rng, m + 10, np.float64)
    kw = dict(tol=1e-8, krylovdim=12, maxiter=30, verbosity=verbosity)
    return {
        "lanczos": lambda: mod.eigsolve(arr(H), arr(x0), 2, "LR", alg=mod.Lanczos(**kw)),
        "arnoldi": lambda: mod.eigsolve(arr(A), arr(x0), 2, "LM", alg=mod.Arnoldi(**kw)),
        "cg": lambda: mod.linsolve(arr(H), arr(x0), alg=mod.CG(tol=1e-8, maxiter=200,
                                                               verbosity=verbosity)),
        "minres": lambda: mod.linsolve(arr(H), arr(x0), alg=mod.MINRES(tol=1e-8, maxiter=200,
                                                                       verbosity=verbosity)),
        "gkl": lambda: mod.svdsolve(arr(R), arr(b), 2, "LR", alg=mod.GKL(**kw)),
        "lsmr": lambda: mod.lssolve(arr(R), arr(b), alg=mod.LSMR(tol=1e-8, maxiter=200,
                                                                 verbosity=verbosity)),
    }


@pytest.mark.parametrize("verbosity", [STARTSTOP, EACHITERATION, EACHITERATION + 1])
@pytest.mark.parametrize("solver", ["lanczos", "arnoldi", "cg", "minres", "gkl", "lsmr"])
def test_message_kinds_match_jax(solver, verbosity):
    """The lines of each message kind, counted, are the JAX package's at
    every level from STARTSTOP up (the order within a line is not
    compared: see the module docstring)."""
    outs = {pkg: _capture(_solvers(pkg, verbosity)[solver]) for pkg in PACKAGES}
    assert _kinds(outs["jax"]) == _kinds(outs["port"]), outs
