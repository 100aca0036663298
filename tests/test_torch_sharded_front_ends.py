"""PyTorch port: the remaining front-ends on a sharded space
(``VectorSpace(psum_axis=...)``) against the JAX package's sharded solves
on the CPU.

One group of 4 gloo ranks on the CPU is spawned for the module
(``chip_smoke.start_ranks``) and runs the solvers' scenarios of
``chip_smoke.front_end_cases`` (``bieigsolve`` and the iterators are in
``tests/test_torch_sharded_iterators.py``); each is its own test, and every
rank must return the same bits.  The JAX side runs the same problem (the same COO
triplets and start vectors, ``chip_smoke.front_end_problem`` with the JAX
package's generators) on 4 of the conftest's virtual CPU devices: GSPMD on
``parallel.sharded_ell_from_coo`` for the ELL cases, and ``shard_map`` with
``psum_axis`` and the fused kernel in interpret mode for the fused
``exponentiate`` (as ``tests/test_fused_lanczos.py:775`` runs the fused
Lanczos).

Tolerances: float64 values within 1e-10 with ``numops``, ``numiter`` and
``converged`` equal; the float32 fused ``exponentiate`` within rtol 2e-4
(two roundings of one kernel) with equal counts; the iterators' projected
matrices within 1e-10 after the same expansions.
"""

from functools import lru_cache, partial

import numpy as np
import pytest

import chip_smoke
import krylovkit_tpu as kk
import krylovkit_tpu.parallel as jpar

WORLD = 4
TOL = 1e-10


SOLVERS = ("minres", "bicgstab", "minres_tree", "exponentiate", "exponentiate_fused",
           "expintegrator", "geneigsolve", "block_lanczos")


def run_scenarios(names, meanwhile=()):
    """``chip_smoke.front_end_cases`` of ``names`` on :data:`WORLD` CPU
    ranks, after checking that every rank returned the same bits; the
    calls ``meanwhile`` (the JAX side, cached) run while the ranks do."""
    handle = chip_smoke.start_ranks(WORLD, "front_end_cases", dev="cpu", timeout=400,
                                    names=names)
    try:
        for call in meanwhile:
            call()
    finally:
        res = chip_smoke.collect_ranks(handle)
    return chip_smoke.same_on_every_rank(np, res)


@pytest.fixture(scope="module")
def ranks():
    return run_scenarios(SOLVERS, [partial(_jax_solve, name) for name in SOLVERS])


def _case(ranks, name):
    out = ranks[name]
    assert "error" not in out, out.get("error")
    return out


def _counts_equal(out, info):
    assert (out["numops"], out["numiter"], out["converged"]) == (
        int(info.numops), int(info.numiter), int(info.converged))


def _mesh():
    import jax

    if len(jax.devices()) < WORLD:
        pytest.skip(f"needs {WORLD} virtual devices")
    return jpar.make_mesh(WORLD)


def _put(x, mesh):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("vec")))


def _jax_problem(name):
    """``(problem, mesh, sharded operator, put)`` of scenario ``name``."""
    prob = chip_smoke.front_end_problem(np, jpar, name)
    mesh = _mesh()
    op = jpar.sharded_ell_from_coo(*prob["coo"], prob["shape"], mesh)
    return prob, mesh, op, partial(_put, mesh=mesh)


def _close(got, want, atol=TOL):
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol)


def _host(tree):
    """A JAX result as numpy arrays (its info as host ints)."""
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


@lru_cache(maxsize=None)
def _jax_solve(name):
    """The JAX package's solve of scenario ``name``, on the host."""
    if name == "exponentiate_fused":
        return _jax_fused_exponentiate()
    prob, mesh, op, put = _jax_problem(name)
    if name == "minres":
        return _host(kk.linsolve(op, put(prob["x"]), alg=kk.MINRES(tol=TOL, maxiter=400)))
    if name == "bicgstab":
        return _host(kk.linsolve(op, put(prob["x"]), None, 1.0, 1.0,
                                 alg=kk.BiCGStab(tol=TOL, maxiter=400)))
    if name == "minres_tree":
        def apply(v):
            return {"p": op.normal(v["p"]) + 0.5 * v["q"],
                    "q": op.normal(v["q"]) + 0.5 * v["p"]}

        return _host(kk.linsolve(apply, {"p": put(prob["x"]), "q": put(prob["y"])},
                                 alg=kk.MINRES(tol=TOL, maxiter=400)))
    if name == "exponentiate":
        return _host(kk.exponentiate(op, -0.05, put(prob["x"]), ishermitian=True, tol=TOL,
                                     krylovdim=20))
    if name == "expintegrator":
        return _host(kk.expintegrator(op, 0.1, *(put(prob[k]) for k in ("x", "y", "z")),
                                      ishermitian=True, tol=TOL, krylovdim=20))
    if name == "geneigsolve":
        opb = jpar.sharded_ell_from_coo(*prob["coo_b"], prob["shape"], mesh)
        return _host(kk.geneigsolve((op, opb), put(prob["x"]), 2, "SR", krylovdim=25,
                                    tol=1e-8, maxiter=200))
    assert name == "block_lanczos"
    return _host(kk.eigsolve(op, kk.Block([put(b) for b in prob["block"]]), 3, "LM",
                             tol=TOL, krylovdim=30, maxiter=100))


def test_sharded_minres_matches_jax(ranks):
    out = _case(ranks, "minres")
    x, info = _jax_solve("minres")
    _close(out["x"], x)
    _counts_equal(out, info)
    assert out["converged"] == 1


def test_sharded_bicgstab_matches_jax(ranks):
    out = _case(ranks, "bicgstab")
    x, info = _jax_solve("bicgstab")
    _close(out["x"], x)
    _counts_equal(out, info)
    assert out["converged"] == 1


def test_sharded_minres_on_a_dict_vector_matches_jax(ranks):
    """A dict vector whose two leaves are each sharded on their rows."""
    out = _case(ranks, "minres_tree")
    x, info = _jax_solve("minres_tree")
    _close(out["p"], x["p"])
    _close(out["q"], x["q"])
    _counts_equal(out, info)


def test_sharded_exponentiate_matches_jax(ranks):
    out = _case(ranks, "exponentiate")
    y, info = _jax_solve("exponentiate")
    _close(out["y"], y)
    _counts_equal(out, info)


def _jax_fused_exponentiate():
    """The JAX package's sharded fused solve inside ``shard_map`` (the kernel
    in interpret mode): ``(y, (converged, numiter, numops))``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from krylovkit_tpu.factorizations import krylov as jkf
    from krylovkit_tpu.ops.vector import VectorSpace

    prob = chip_smoke.front_end_problem(np, jpar, "exponentiate_fused")
    if len(jax.devices()) < WORLD:
        pytest.skip(f"needs {WORLD} virtual devices")
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("vec",))
    space = VectorSpace(psum_axis="vec")
    op = jpar.shard_local_stencil(kk.StencilOperator(*chip_smoke.FRONT_END_NEG_LAP), "vec")
    alg = kk.Lanczos(krylovdim=30, tol=1e-4)

    @partial(jax.shard_map, mesh=mesh, in_specs=P("vec", None),
             out_specs=(P("vec", None), P()), check_vma=False)
    def run(x0):
        assert jkf.fused_available(op, x0, space, kmax=31)
        y, info = kk.exponentiate(op, 0.1, x0, alg=alg, space=space)
        return y, (info.converged, info.numiter, info.numops)

    old = jkf.fused_interpret
    jkf.fused_interpret = True
    try:
        x0 = jax.device_put(jnp.asarray(prob["x"]), NamedSharding(mesh, P("vec", None)))
        return _host(jax.jit(run)(x0))
    finally:
        jkf.fused_interpret = old


def test_sharded_fused_exponentiate_matches_jax(ranks):
    """K1 per rank with external halos against the JAX package's sharded
    fused solve inside ``shard_map`` (the kernel in interpret mode)."""
    out = _case(ranks, "exponentiate_fused")
    assert out["fused"]
    y, (conv, numiter, numops) = _jax_solve("exponentiate_fused")
    np.testing.assert_allclose(out["y"], y, rtol=0, atol=2e-4 * np.abs(y).max())
    assert (out["numops"], out["numiter"], out["converged"]) == (
        int(numops), int(numiter), int(conv))


def test_sharded_expintegrator_matches_jax(ranks):
    out = _case(ranks, "expintegrator")
    y, info = _jax_solve("expintegrator")
    _close(out["y"], y)
    _counts_equal(out, info)


def test_sharded_geneigsolve_matches_jax(ranks):
    out = _case(ranks, "geneigsolve")
    vals, vecs, info = _jax_solve("geneigsolve")
    _close(out["vals"], vals)
    _counts_equal(out, info)
    assert out["converged"] == 2
    dots = np.abs(np.sum(out["vectors"] * np.asarray(vecs), axis=1))
    np.testing.assert_allclose(dots, np.abs(np.sum(np.asarray(vecs) ** 2, axis=1)), rtol=1e-8)


def test_sharded_block_lanczos_matches_jax(ranks):
    out = _case(ranks, "block_lanczos")
    vals, _, info = _jax_solve("block_lanczos")
    _close(out["vals"], vals)
    _counts_equal(out, info)
    assert out["converged"] == 3
