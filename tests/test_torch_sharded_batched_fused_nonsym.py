"""PyTorch port: fused batched Arnoldi processes on a sharded space against
the JAX package on the CPU (a part of ``tests/test_torch_sharded_batched.py``).

One group of 4 gloo ranks on the CPU, a ``batch 2 × vec 2`` mesh, runs
``schursolve`` on a non-symmetric chain and GMRES on the 2-D Poisson grid,
fused on ``shard_local_stencil`` operators (float32 ``(32, 128)`` blocks a
rank), from ``chip_smoke.sharded_batched_cases``.  Every lock-step is one
batched K1 launch per distinct live-row count with every problem's
external halos (its plain version on the CPU), then one all-reduce for all
the stepping problems.  The JAX side is ``jax.vmap`` inside the
``shard_map`` body with ``psum_axis="vec"`` and the fused kernel in
interpret mode (``tests/test_fused_lanczos.py:734-800``), on 4 of the
conftest's virtual CPU devices as a ``(batch, vec)`` mesh.

Tolerances: values rtol 2e-4 (two roundings of one kernel), GMRES's ``x``
within 2e-4 of its largest entry, counts equal.  Each problem is also held
against its one-problem sharded solve: the same bits (two ``vec`` ranks),
counts and WARN lines.
"""

from functools import lru_cache, partial

import numpy as np
import pytest

import chip_smoke
import krylovkit_tpu as kk
import krylovkit_tpu.parallel as jpar

WORLD = 4
SCENARIOS = ("schursolve_fused", "gmres_fused")


@pytest.fixture(scope="module")
def ranks():
    # the JAX side (cached) runs while the ranks do
    handle = chip_smoke.start_ranks(WORLD, "sharded_batched_cases", dev="cpu", timeout=400,
                                    names=SCENARIOS)
    try:
        _jax_schursolve()
        _jax_gmres()
    finally:
        res = chip_smoke.collect_ranks(handle)
    return chip_smoke.same_on_every_rank(np, res)


def _case(ranks, name):
    out = ranks[name]
    assert "error" not in out, out.get("error")
    assert out["fused"]
    assert out["one_problem_counts"] == [list(c) for c in zip(
        out["numops"], out["numiter"], out["converged"])]
    assert out["one_problem_bits"] and out["warn_lines_equal"]
    return out


def _vmapped_in_shard_map(body, X, n_out):
    """``jax.vmap(body)`` over this device's problems inside ``shard_map`` on
    a ``(batch 2, vec 2)`` mesh, the fused kernel in interpret mode; ``X``
    ``(P, R, 128)`` split over both axes.  ``body`` returns ``n_out``
    per-problem values (leading axis the problem) and a vector last."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as Ps

    from krylovkit_tpu.factorizations import krylov as jkf

    if len(jax.devices()) < WORLD:
        pytest.skip(f"needs {WORLD} virtual devices")
    mesh = Mesh(np.array(jax.devices()[:WORLD]).reshape(2, 2), ("batch", "vec"))
    vec_spec = Ps("batch", "vec", None)

    @partial(jax.shard_map, mesh=mesh, in_specs=vec_spec,
             out_specs=(Ps("batch"),) * n_out + (vec_spec,), check_vma=False)
    def run(Xl):
        return jax.vmap(body)(Xl)

    old = jkf.fused_interpret
    jkf.fused_interpret = True
    try:
        return jax.jit(run)(jax.device_put(jnp.asarray(X), NamedSharding(mesh, vec_spec)))
    finally:
        jkf.fused_interpret = old


def _space():
    from krylovkit_tpu.ops.vector import VectorSpace as JSpace

    return JSpace(psum_axis="vec")


def _counts_equal(out, numops, numiter, conv):
    assert out["numops"] == np.asarray(numops).tolist()
    assert out["numiter"] == np.asarray(numiter).tolist()
    assert out["converged"] == np.asarray(conv).tolist()


@lru_cache(maxsize=None)
def _jax_schursolve():
    import jax.numpy as jnp

    from krylovkit_tpu.solvers.arnoldi import schursolve

    prob = chip_smoke.sharded_batched_problem(np, "schursolve_fused")
    op = jpar.shard_local_stencil(kk.StencilOperator((-1, 0, 1), chip_smoke.FRONT_END_TRI),
                                  "vec")
    alg = kk.Arnoldi(krylovdim=16, maxiter=3, tol=1e-6)

    def body(x):
        _, V, (re, im), info = schursolve(op, jnp.asarray(x), 2, "LM", alg, _space())
        return re, im, info.numops, info.numiter, info.converged, V[0]

    return tuple(np.asarray(a) for a in _vmapped_in_shard_map(body, prob["X"], 5))


@lru_cache(maxsize=None)
def _jax_gmres():
    import jax.numpy as jnp

    from krylovkit_tpu.solvers.gmres import linsolve_gmres

    prob = chip_smoke.sharded_batched_problem(np, "gmres_fused")
    op = jpar.shard_local_stencil(jpar.poisson_2d(*chip_smoke.SHARDED_BATCHED_GRID,
                                                  jnp.float32), "vec")
    alg = kk.GMRES(krylovdim=16, maxiter=3, tol=1e-6)

    def body(b):
        x, info = linsolve_gmres(op, b, jnp.zeros_like(b), jnp.float32(0.5), jnp.float32(1.0),
                                 alg, _space())
        return info.numops, info.numiter, info.converged, x

    return tuple(np.asarray(a) for a in _vmapped_in_shard_map(body, prob["X"], 3))


def test_sharded_batched_fused_schursolve_matches_jax(ranks):
    out = _case(ranks, "schursolve_fused")
    re, im, numops, numiter, conv, _ = _jax_schursolve()
    np.testing.assert_allclose(out["vals"][:, 0], re, rtol=2e-4)
    np.testing.assert_allclose(out["vals"][:, 1], im, rtol=0,
                               atol=2e-4 * float(np.abs(re).max()))
    _counts_equal(out, numops, numiter, conv)


def test_sharded_batched_fused_gmres_matches_jax(ranks):
    out = _case(ranks, "gmres_fused")
    numops, numiter, conv, x = _jax_gmres()
    np.testing.assert_allclose(out["X"], x, rtol=0, atol=2e-4 * float(np.abs(x).max()))
    _counts_equal(out, numops, numiter, conv)
