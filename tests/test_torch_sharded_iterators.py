"""PyTorch port: ``bieigsolve`` and the five iterators on a sharded space
(``VectorSpace(psum_axis=...)``) against the JAX package's GSPMD solves on
the CPU, the rest of ``tests/test_torch_sharded_front_ends.py`` (split off
to keep each file's run short; its helpers serve both).

One group of 4 gloo ranks on the CPU runs these scenarios of
``chip_smoke.front_end_cases``, every rank returning the same bits, while
the module's fixture computes the JAX side (cached).
Tolerances: ``bieigsolve``'s values within 1e-10 with ``numops``,
``numiter`` and ``converged`` equal; after :data:`chip_smoke.FRONT_END_STEPS`
expansions, the iterators' projected matrices within 1e-10 and ``β`` to a
relative 1e-10.  The JAX iterators' steps are jitted.
"""

from functools import lru_cache

import pytest

import chip_smoke
import krylovkit_tpu as kk
from krylovkit_tpu.factorizations import iterators as jits
from test_torch_sharded_front_ends import TOL, _case, _close, _counts_equal, _host, \
    _jax_problem, run_scenarios


@pytest.fixture(scope="module")
def ranks():
    return run_scenarios(("bieigsolve",) + chip_smoke.FRONT_END_ITERATORS,
                         [_jax_bieigsolve] + [lambda name=name: _jax_iterator(name)
                                              for name in chip_smoke.FRONT_END_ITERATORS])


@lru_cache(maxsize=None)
def _jax_bieigsolve():
    prob, _, op, put = _jax_problem("bieigsolve")
    vals, _, (info, _) = kk.bieigsolve(op, put(prob["x"]), put(prob["y"]), 3, "LM",
                                       krylovdim=24, tol=TOL, maxiter=100)
    return _host((vals, info))


def test_sharded_bieigsolve_matches_jax(ranks):
    """The adjoint of the sharded ELL operator runs on its adjoint plan."""
    out = _case(ranks, "bieigsolve")
    vals, info = _jax_bieigsolve()
    _close(out["vals"], vals)
    _counts_equal(out, info)
    assert out["converged"] == 3


@lru_cache(maxsize=None)
def _jax_iterator(name):
    import jax

    prob, _, op, put = _jax_problem(name)
    x0 = put(prob["x"])
    make = {
        "lanczos_iterator": lambda: kk.LanczosIterator(op, x0, krylovdim=12),
        "arnoldi_iterator": lambda: kk.ArnoldiIterator(op, x0, krylovdim=12),
        "gkl_iterator": lambda: kk.GKLIterator(op, x0, krylovdim=12),
        "block_lanczos_iterator": lambda: kk.BlockLanczosIterator(
            op, kk.Block([put(b) for b in prob["block"][:2]]).stacked, krylovdim=24),
        "biarnoldi_iterator": lambda: kk.BiArnoldiIterator(op, x0, put(prob["y"]), krylovdim=12),
    }[name]
    it = make()
    # one compiled step: op-by-op dispatch on sharded arrays costs seconds a step
    expand = jax.jit(it.expand)
    st = it.initialize()
    for _ in range(chip_smoke.FRONT_END_STEPS):
        st = expand(st)
    return st


@pytest.mark.parametrize("name", chip_smoke.FRONT_END_ITERATORS)
def test_sharded_iterators_match_jax(ranks, name):
    out = _case(ranks, name)
    st = _jax_iterator(name)
    if name == "biarnoldi_iterator":
        fV, fW = st
        assert out["k"] == int(fV.k)
        _close(out["H"], fV.H)
        _close(out["K"], fW.H)
        assert float(out["beta"]) == pytest.approx(float(fV.beta), rel=TOL)
        assert float(out["beta_left"]) == pytest.approx(float(fW.beta), rel=TOL)
        return
    assert out["k"] == int(st.k)
    _close(out["H"], jits.rayleighquotient(st))
    assert float(out["beta"]) == pytest.approx(float(jits.normres(st)), rel=TOL)
