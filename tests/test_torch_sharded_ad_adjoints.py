"""PyTorch port: gradients through a sharded ``ShardedELLOperator``,
adjoints derived across the ranks, and phase ``sharded_ad`` of
``chip_smoke.py`` on CPU ranks (``tests/test_torch_sharded_ad.py`` says how
the two sides run and what they are held to).

The ``ShardedELLOperator`` scenarios run on GSPMD on the JAX side (the JAX
package's sharded ELL operator is a global-array operator): the gathered
gradient is held against the JAX one.
"""

from functools import lru_cache, partial

import numpy as np
import pytest

import chip_smoke
import krylovkit_tpu as kk
import krylovkit_tpu.parallel as jpar
from test_torch_sharded_ad import WORLD, _case, _close, _counts_equal, _jinfo, run_cases

NAMES = ("ell_linsolve", "ell_eigsolve_derived", "collective_error") + \
    tuple("dot_" + k for k in chip_smoke.SHARDED_AD_DOT)


@pytest.fixture(scope="module")
def ranks():
    return run_cases(NAMES, [partial(_jax_ell, name) for name in ("ell_linsolve",
                                                                  "ell_eigsolve_derived")])


# --------------------------------------------------------------------------
# ShardedELLOperator
# --------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _jax_ell(name):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    prob = chip_smoke.sharded_ad_problem(np, name)
    mesh = jpar.make_mesh(WORLD)
    n = prob["n"]
    E = jpar.sharded_ell_from_coo(*jpar.banded_coo(n, halfband=4, seed=11, spd=True), (n, n), mesh)
    put = lambda a: jax.device_put(jnp.asarray(a), NamedSharding(mesh, P("vec")))  # noqa: E731
    g = put(prob["g"])
    if name == "ell_linsolve":
        alg = kk.GMRES(tol=chip_smoke.SHARDED_AD_TOL, krylovdim=30, maxiter=200,
                       verbosity=kk.SILENT)

        def f(g, b):
            op = kk.ParametricOperator(lambda p, x: E.normal(x) + p * x, g,
                                       lambda p, y: E.apply_adjoint(y) + p * y)
            x, info = kk.linsolve(op, b, alg=alg)
            return x, _jinfo(info)

        x, vjp, info = jax.vjp(f, g, put(prob["b"]), has_aux=True)
        return (x,) + vjp(put(prob["c"])), info
    alg = kk.Lanczos(tol=chip_smoke.SHARDED_AD_TOL, krylovdim=30, maxiter=100, verbosity=kk.SILENT)

    def f(g):
        op = kk.ParametricOperator(lambda p, x: E.normal(x) + p * x, g)
        vals, _, info = kk.eigsolve(op, put(prob["x0"]), 2, "SR", alg=alg)
        return vals, _jinfo(info)

    vals, vjp, info = jax.vjp(f, g, has_aux=True)
    return (vals,) + vjp(jnp.ones_like(vals)), info


def test_sharded_ell_parametric_linsolve_gradient_matches_jax(ranks):
    """A ``ParametricOperator`` around a ``ShardedELLOperator``: the sharded
    shift ``g`` and ``b`` get each rank's block of the JAX gradient."""
    out = _case(ranks, "ell_linsolve")
    (x, gb, bb), info = _jax_ell("ell_linsolve")
    _counts_equal(out, info)
    _close(out["x"], x)
    _close(out["g"], gb)
    _close(out["b"], bb)


def test_sharded_ell_eigsolve_with_derived_adjoint_matches_jax(ranks):
    """No ``adjoint_fn``: the backward's adjoint is derived across the
    ranks through the ELL halo round's transpose."""
    out = _case(ranks, "ell_eigsolve_derived")
    (vals, gb), info = _jax_ell("ell_eigsolve_derived")
    _counts_equal(out, info)
    _close(out["vals"], vals)
    _close(out["g"], gb)


# --------------------------------------------------------------------------
# derived adjoints and the transposed collectives
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kind", chip_smoke.SHARDED_AD_DOT)
def test_derived_adjoint_across_ranks(ranks, kind):
    """``Σ_ranks ⟨y, A x⟩ = Σ_ranks ⟨Aᴴ y, x⟩`` for the adjoint derived by
    ``with_adjoint_from`` (``torch.autograd``) through the transposed edge
    exchange (chain and grid stencils), the ELL halo round and a psum; it
    equals the explicit adjoint, and ``torch.func.vjp`` derives the same,
    bit for bit."""
    out = _case(ranks, "dot_" + kind)
    assert abs(out["yAx"] - out["Ayx"]) <= 1e-12 * max(1.0, abs(out["yAx"]))
    assert out["explicit_gap"] <= 1e-12 * max(1.0, abs(out["yAx"]))
    assert out["func_gap"] == 0.0


def test_derived_adjoint_refuses_a_collective_without_a_transpose(ranks):
    """A map that calls ``torch.distributed`` itself: its derived adjoint
    raises rather than drop the term across the ranks."""
    assert _case(ranks, "collective_error")["raised"]


def test_sharded_ad_phase_on_cpu_ranks():
    """Phase ``sharded_ad`` of ``chip_smoke.py`` on two CPU ranks at N = 128
    (the kernels' plain versions; float32): the fused GMRES forward on
    ``shard_local_stencil`` and its unfused adjoint solve, the eigenvalue
    gradients by the GMRES and Sylvester rules, their batched twins
    (``eigsolve_lanczos_batched``, ``linsolve_gmres_batched``, two
    problems) and the derived adjoint, each against one rank (the phase's
    guards: Hellmann–Feynman and the joined gradients within 1e-3, values
    and the linsolve's gradients within 1e-4, counts equal)."""
    import torch

    import krylovkit_tpu_torch as kt
    from krylovkit_tpu_torch import _build

    launches = chip_smoke.sharded_ad(torch, np, kt, _build, "cpu", N=128, dev="cpu")
    assert set(launches) == set(chip_smoke.SHARDED_AD_PASSES
                                + chip_smoke.SHARDED_AD_BATCHED_PASSES)
