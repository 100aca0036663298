"""PyTorch port: batched eigensolves on a sharded space against the JAX
package on the CPU (a part of ``tests/test_torch_sharded_batched.py``).

One group of 4 gloo ranks on the CPU, a ``batch 2 × vec 2`` mesh, runs
Lanczos on the sharded ELL operator (float64) and ``eigsolve_arnoldi``
unfused with the projection flag on (float32 ``(8, 128)`` blocks a rank of
the sharded bidiagonal: one batched K5 launch a sweep, its plain version
here, then one all-reduce of the ``(P, k)`` coefficients) from
``chip_smoke.sharded_batched_cases``.  The JAX side is ``jax.vmap`` of the
GSPMD solve on 4 of the conftest's virtual CPU devices, its starts split
over the mesh's ``batch`` and ``vec`` axes; its projection flag stays off
(its kernel route returns before the ``psum`` on a sharded space).

Tolerances: float64 within 1e-10, float32 rtol 2e-4; ``numops``,
``numiter`` and ``converged`` equal.  Each problem is also held against its
one-problem sharded solve: the same bits (two ``vec`` ranks), counts and
WARN lines.
"""

from functools import lru_cache
from types import SimpleNamespace

import numpy as np
import pytest

import chip_smoke
import krylovkit_tpu as kk
import krylovkit_tpu.parallel as jpar

WORLD = 4
TOL = 1e-10
SCENARIOS = ("lanczos_ell", "arnoldi_flag")


@pytest.fixture(scope="module")
def ranks():
    # the JAX side (cached) runs while the ranks do
    handle = chip_smoke.start_ranks(WORLD, "sharded_batched_cases", dev="cpu", timeout=400,
                                    names=SCENARIOS)
    try:
        _jax_lanczos()
        _jax_arnoldi()
    finally:
        res = chip_smoke.collect_ranks(handle)
    return chip_smoke.same_on_every_rank(np, res)


def _case(ranks, name):
    out = ranks[name]
    assert "error" not in out, out.get("error")
    return out


def _mesh():
    import jax

    if len(jax.devices()) < WORLD:
        pytest.skip(f"needs {WORLD} virtual devices")
    return jpar.make_mesh(WORLD, batch=2)


def _put(x, mesh):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as Ps

    spec = ("batch", "vec") + (None,) * (np.ndim(x) - 2)
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, Ps(*spec)))


def _counts_equal(out, info):
    for k in ("numops", "numiter", "converged"):
        assert out[k] == np.asarray(getattr(info, k)).tolist(), k


def _against_one_problem(out):
    """Each problem's one-problem sharded solve: the same counts, the same
    bits, the same WARN lines."""
    assert out["one_problem_counts"] == [list(c) for c in zip(
        out["numops"], out["numiter"], out["converged"])]
    assert out["one_problem_bits"] and out["warn_lines_equal"]


def _ell(name, mesh, tile=None):
    prob = chip_smoke.sharded_batched_problem(np, name)
    n = prob["n"]
    coo = prob["coo"] or jpar.banded_coo(n, halfband=4, seed=11, spd=True)
    return prob, jpar.sharded_ell_from_coo(*coo, (n, n), mesh, tile=tile)


@lru_cache(maxsize=None)
def _jax_lanczos():
    import jax

    from krylovkit_tpu.solvers.lanczos import eigsolve_lanczos

    mesh = _mesh()
    prob, op = _ell("lanczos_ell", mesh)
    alg = kk.Lanczos(krylovdim=20, maxiter=50, tol=1e-10)
    vals, _, info = jax.jit(jax.vmap(lambda x: eigsolve_lanczos(op, x, 2, "LM", alg)))(
        _put(prob["X"], mesh))
    return np.asarray(vals), _host_info(info)


@lru_cache(maxsize=None)
def _jax_arnoldi():
    import jax

    from krylovkit_tpu.solvers.arnoldi import eigsolve_arnoldi

    mesh = _mesh()
    prob, op = _ell("arnoldi_flag", mesh, tile=128)
    alg = kk.Arnoldi(krylovdim=16, maxiter=20, tol=1e-5)
    vals, _, info = jax.jit(jax.vmap(lambda x: eigsolve_arnoldi(op, x, 2, "LM", alg)))(
        _put(prob["X"], mesh))
    return np.asarray(vals), _host_info(info)


def _host_info(info):
    """The counts of a JAX info as host arrays."""
    return SimpleNamespace(**{k: np.asarray(getattr(info, k))
                              for k in ("numops", "numiter", "converged")})


def test_sharded_batched_lanczos_ell_matches_jax_vmap(ranks):
    out = _case(ranks, "lanczos_ell")
    vals, info = _jax_lanczos()
    np.testing.assert_allclose(out["vals"], vals, rtol=0, atol=TOL)
    _counts_equal(out, info)
    _against_one_problem(out)


def test_sharded_batched_arnoldi_with_flag_matches_jax_vmap(ranks):
    """``eigsolve_arnoldi_batched`` unfused with the projection flag on
    (float32 ``(8, 128)`` blocks a rank: one batched K5 launch a sweep,
    then one all-reduce of the ``(P, k)`` coefficients) against the JAX
    package's vmapped GSPMD solve with its flag off."""
    out = _case(ranks, "arnoldi_flag")
    vals, info = _jax_arnoldi()
    np.testing.assert_allclose(out["vals"][:, 0], vals.real, rtol=2e-4)
    np.testing.assert_allclose(out["vals"][:, 1], vals.imag, rtol=0,
                               atol=2e-4 * float(np.abs(vals).max()))
    _counts_equal(out, info)
    _against_one_problem(out)
