"""PyTorch port: gradients of sharded solves (``VectorSpace(psum_axis=...)``)
against the JAX package on the CPU: linsolve, eigsolve and the psum's
cotangent here; svdsolve in ``test_torch_sharded_ad_svd.py`` and, with
derived adjoints, in ``test_torch_sharded_ad_derived.py``; the
``ShardedELLOperator``, the adjoint identities and the phase rehearsal in
``test_torch_sharded_ad_adjoints.py`` (four files, so that each stays near
a minute on one worker).

One group of 4 gloo ranks on the CPU is spawned for each file's module
(``chip_smoke.start_ranks``) and runs the file's scenarios of
``chip_smoke.sharded_ad_cases``, while the module's fixture computes the
JAX side (cached); every rank must return the same bits.
The JAX side runs the same problems (``chip_smoke.sharded_ad_problem``) on
4 of the conftest's virtual CPU devices, float64:

* the stencil scenarios inside ``jax.shard_map`` with ``psum_axis`` and
  ``check_vma=False``, the vector-Jacobian product taken in the body, so
  each device's cotangent is the derivative of the global loss with respect
  to that device's copy of each input: its block of a sharded input (``g``,
  ``b``) and a partial of a replicated one (``s``, ``a0``, ``a1``).  Each
  rank's cotangents are held against its device's, the partials summed
  over the ranks against the unsharded JAX gradient;
* the ``ShardedELLOperator`` scenarios on GSPMD (the JAX package's sharded
  ELL operator is a global-array operator), the gathered gradient against
  the JAX one.

Where the JAX package's in-body cotangent is wrong, the port's is held
against the unsharded JAX gradient instead: the Sylvester pullbacks' Gram
matrices (``bs.gram``) sum only a device's rows inside ``shard_map``, which
breaks the general Sylvester route and the Sylvester routes with
eigenvector or singular-vector cotangents (ROADMAP queue 3); the
``_values`` scenarios, whose cotangents touch the values only, hold the
Sylvester routes against the in-body ones.

The scenarios that differ only in data share one compiled JAX program
(:data:`SHARED_GROUPS`): a ``_values`` scenario is its full one with the
vector cotangent scaled by 0, and the three ``svdsolve_derived`` maps are
one map whose pick rides in its parameters (each term the scenario's, the
others multiplied by an exact 0).

Tolerances: gradients within 1e-10 (relative to the largest entry of the
reference), ``numops``, ``numiter`` and ``converged`` of the forward equal,
and the applies of the backward's inner solves equal to the JAX package's
in the body (linsolve, and the GMRES and values-only Sylvester rules of
eigsolve and svdsolve: the port counts its adjoint's applies, the JAX side
the ``numops`` of its pullbacks' inner solves).
"""

from functools import lru_cache, partial

import numpy as np
import pytest

import chip_smoke
import krylovkit_tpu as kk
import krylovkit_tpu.parallel as jpar

WORLD = 4
TOL = 1e-10


NAMES = ("linsolve", "psum_loss") + chip_smoke.SHARDED_AD_EIG


def run_cases(names, meanwhile=()):
    """The scenarios ``names`` of ``chip_smoke.sharded_ad_cases`` on one
    group of :data:`WORLD` CPU ranks, the same on every rank.  The calls
    ``meanwhile`` (the JAX side, cached) run while the ranks do."""
    handle = chip_smoke.start_ranks(WORLD, "sharded_ad_cases", dev="cpu", timeout=600,
                                    names=names)
    try:
        for call in meanwhile:
            call()
    finally:
        res = chip_smoke.collect_ranks(handle)
    return chip_smoke.same_on_every_rank(np, res)


def spectral_refs(names, in_body):
    """The JAX side of :func:`_check_spectral` for ``names``, as calls for
    :func:`run_cases`' ``meanwhile``."""
    return [partial(_jax_spectral, name, sharded=sharded) for name in names
            for sharded in ((False, True) if in_body else (False,))]


@pytest.fixture(scope="module")
def ranks():
    return run_cases(NAMES, [partial(_jax_linsolve, sharded=True),
                             partial(_jax_linsolve, sharded=False)]
                     + spectral_refs(("eigsolve_gmres", "eigsolve_sylvester_values",
                                      "eigsolve_general"), True)
                     + spectral_refs(("eigsolve_sylvester",), False))


def _case(ranks, name):
    out = ranks[name]
    assert "error" not in out, out.get("error")
    return out


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, np.abs(want).max()))


def _mesh():
    import jax
    from jax.sharding import Mesh

    if len(jax.devices()) < WORLD:
        pytest.skip(f"needs {WORLD} virtual devices")
    return Mesh(np.array(jax.devices()[:WORLD]), ("vec",))


# the numops of every inner solve that ran, appended by the compiled
# programs' callbacks (a cached program keeps the callback it was traced with)
_SEEN = []


class _InnerSolves:
    """The applies of the backward's inner solves of the JAX package (its
    pullbacks' ``_linsolve_impl`` and ``eigsolve_arnoldi``, which they
    import at call time): each solve's ``numops``, read by a
    ``jax.debug.callback`` once per device into :data:`_SEEN`.  Inside, the
    two are wrapped (for a program traced there); :attr:`numops` sums what
    ran inside."""

    def __init__(self, devices):
        self.devices, self.seen = devices, _SEEN

    def __enter__(self):
        import jax
        import krylovkit_tpu.solvers.arnoldi as jarn
        import krylovkit_tpu.solvers.linsolve as jlin

        _SEEN.clear()

        def counted(fn):
            def solve(*a, **kw):
                out = fn(*a, **kw)
                jax.debug.callback(lambda n: _SEEN.append(int(n)), out[-1].numops)
                return out

            return solve

        self.saved = (jlin._linsolve_impl, jarn.eigsolve_arnoldi)
        jlin._linsolve_impl = counted(jlin._linsolve_impl)
        jarn.eigsolve_arnoldi = counted(jarn.eigsolve_arnoldi)
        return self

    def __exit__(self, *exc):
        import jax
        import krylovkit_tpu.solvers.arnoldi as jarn
        import krylovkit_tpu.solvers.linsolve as jlin

        jax.effects_barrier()  # every callback of the (asynchronous) runs has fired
        jlin._linsolve_impl, jarn.eigsolve_arnoldi = self.saved

    @property
    def numops(self):
        return sum(self.seen) // self.devices


def _in_body(fn, sharded_in, n_rep_out, n_dev_out):
    """``fn`` inside ``shard_map`` over the 4 devices: its first
    ``sharded_in`` arguments are split on their rows, the rest replicated;
    its outputs are ``n_rep_out`` replicated values, then ``n_dev_out``
    per-device ones (blocks, or scalars stacked by device)."""
    import jax
    from jax.sharding import PartitionSpec as P

    def body(*args):
        out = fn(*args)
        return out[:n_rep_out] + tuple(
            o.reshape((1,)) if o.ndim == 0 else o for o in out[n_rep_out:])

    def run(*args):
        specs = tuple(P("vec") if i < sharded_in else P() for i in range(len(args)))
        return jax.shard_map(body, mesh=_mesh(), in_specs=specs,
                             out_specs=(P(),) * n_rep_out + (P("vec"),) * n_dev_out,
                             check_vma=False)(*args)

    return run


def _infos(info):
    return int(info.numops), int(info.numiter), int(info.converged)


def _counts_equal(out, counts):
    assert (out["numops"], out["numiter"], out["converged"]) == tuple(int(c) for c in counts)


# --------------------------------------------------------------------------
# linsolve on the sharded 1-D Laplacian: b, a0, a1
# --------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _jax_linsolve(sharded):
    import jax
    import jax.numpy as jnp

    prob = chip_smoke.sharded_ad_problem(np, "linsolve")
    L = jpar.laplacian_1d(prob["n"], jnp.float64)
    alg = kk.GMRES(tol=chip_smoke.SHARDED_AD_TOL, krylovdim=30, maxiter=200, verbosity=kk.SILENT)

    def fn(b, c, a0, a1, space, A):
        op = kk.LinearOperator(A.normal, A.apply_adjoint)

        def f(b, a0, a1):
            x, info = kk.linsolve(op, b, None, a0, a1, alg=alg, space=space)
            return x, _jinfo(info)

        x, vjp, info = jax.vjp(f, b, a0, a1, has_aux=True)
        bb, a0b, a1b = vjp(c)
        return info + (x, bb, a0b, a1b)

    args = (jnp.asarray(prob["b"]), jnp.asarray(prob["c"]), jnp.float64(prob["a0"]),
            jnp.float64(prob["a1"]))
    with _InnerSolves(WORLD if sharded else 1) as inner:
        if sharded:
            run = _in_body(lambda b, c, a0, a1: fn(b, c, a0, a1, kk.VectorSpace(psum_axis="vec"),
                                                  jpar.shard_local_stencil(L, "vec")), 2, 3, 4)
            out = run(*args)
        else:
            out = fn(*args, kk.VectorSpace(), L)
    # the forward solve is an _linsolve_impl too
    return out, inner.numops - int(out[0])


def _jinfo(info):
    return (info.numops, info.numiter, info.converged)


def test_sharded_linsolve_gradient_matches_jax_in_body(ranks):
    """``b̄`` is each rank's block of the JAX device's; ``ā0``, ``ā1`` are
    each rank's partial, equal to its device's, and their sum over the
    ranks is the unsharded gradient."""
    out = _case(ranks, "linsolve")
    (*counts, x, bb, a0b, a1b), applies = _jax_linsolve(sharded=True)
    _counts_equal(out, counts)
    assert out["adjoint_applies"] == applies
    _close(out["x"], x)
    _close(out["b"], bb)
    _close(out["a0"], a0b)
    _close(out["a1"], a1b)
    (*_, xu, bu, a0u, a1u), _ = _jax_linsolve(sharded=False)
    _close(out["b"], bu)
    _close(out["a0"].sum(), a0u)
    _close(out["a1"].sum(), a1u)


# --------------------------------------------------------------------------
# eigsolve and svdsolve: x ↦ A x + g⊙x + s·mask⊙x on a sharded stencil
# --------------------------------------------------------------------------


def _group(name):
    """The scenarios that share one compiled JAX program: a ``_values``
    scenario its full one's (the cotangent on the vectors scaled by 0), the
    three ``svdsolve_derived`` maps one (:func:`_derived_map`)."""
    return "svdsolve_derived" if "_derived" in name else name.replace("_values", "")


def _weights(name):
    """The data that picks scenario ``name`` in its group's program: the
    vector cotangent's scale, and the ``_scaled`` and ``_rank1`` terms'."""
    return (0.0 if name.endswith("_values") else 1.0,
            1.0 if name.endswith("_scaled") else 0.0,
            1.0 if name.endswith("_rank1") else 0.0)


def _derived_map(A, inner):
    """``chip_smoke.sharded_ad_map``'s three ``svdsolve_derived`` maps as one,
    the pick ``(w_s, w_r)`` in the parameters ``(g, s, mask, d, w)``: each
    term the scenario's, in its order, the others multiplied by 0 (exact)."""

    def apply(p, x):
        g, s, mask, d, w = p
        ws, wr = w[1], w[2]
        return (((1 + ws * g) * A.normal(x) + (1 - ws) * g * x)
                + ((1 - wr) * s * mask) * x + (wr * s * inner(mask, x)) * d)

    return apply, None


# the groups of more than one scenario: each compiles once (jax.jit); a
# group of one runs op by op, as each scenario did alone
SHARED_GROUPS = ("eigsolve_sylvester", "svdsolve_sylvester", "svdsolve_derived")


@lru_cache(maxsize=None)
def _jax_program(group, sharded):
    """The JAX side of the scenarios of ``group``, on the 4 devices in the
    body (``sharded``) or on one: a function of ``(g, mask, x0, c, d, s,
    w)`` returning ``(vals, numops, numiter, converged, ḡ, s̄)``, compiled
    once for a group of :data:`SHARED_GROUPS`."""
    import jax
    import jax.numpy as jnp

    svd = group.startswith("svdsolve")
    alg, rrule = chip_smoke.sharded_ad_algs(kk, group)
    A = (kk.StencilOperator(*chip_smoke.SHARDED_AD_CHAIN) if svd
         else jpar.laplacian_1d(chip_smoke.sharded_ad_problem(np, group)["n"], jnp.float64))

    def fn(g, mask, x0, c, d, s, w, space, A, psum):
        # mask, d and w ride in the parameters: a jitted solve cannot close
        # over a shard_map value
        if group == "svdsolve_derived":
            apply, adj = _derived_map(A, space.inner)
        else:
            apply, adj = chip_smoke.sharded_ad_map(group, A, space.inner)

        def f(g, s):
            op = kk.ParametricOperator(apply, (g, s, mask, d) + ((w,) if adj is None else ()),
                                       adj)
            if svd:
                vals, U, V, info = kk.svdsolve(op, x0, 2, "LR", alg=alg, alg_rrule=rrule,
                                               space=space)
                return (vals, U, V), _jinfo(info)
            vals, vecs, info = kk.eigsolve(op, x0, 2, "SR", alg=alg, alg_rrule=rrule, space=space)
            return (vals, vecs), _jinfo(info)

        outs, vjp, info = jax.vjp(f, g, s, has_aux=True)
        vals = outs[0]
        ones = jnp.ones_like(vals)
        if svd:
            U, V = outs[1], outs[2]
            cu = psum(jnp.sum(c[None] * U, axis=(1, 2)))
            dv = psum(jnp.sum(d[None] * V, axis=(1, 2)))
            gU, gV = w[0] * dv[:, None, None] * c[None], w[0] * cu[:, None, None] * d[None]
            gb, sb = vjp((ones, gU, gV))
        else:
            vecs = outs[1]
            cv = psum(jnp.sum(c[None] * vecs, axis=(1, 2)))
            gb, sb = vjp((ones, w[0] * 2 * cv[:, None, None] * c[None]))
        return (vals,) + info + (gb, sb)

    if sharded:
        run = _in_body(lambda *a: fn(*a, kk.VectorSpace(psum_axis="vec"),
                                     jpar.shard_local_stencil(A, "vec"),
                                     partial(jax.lax.psum, axis_name="vec")), 5, 4, 2)
    else:
        def run(*a):
            return fn(*a, kk.VectorSpace(), A, lambda t: t)
    return jax.jit(run) if group in SHARED_GROUPS else run


@lru_cache(maxsize=None)
def _jax_spectral(name, sharded):
    """``(vals, ḡ, s̄, counts, the backward's applies)`` of scenario
    ``name``; ``s̄`` per device when ``sharded``."""
    import jax.numpy as jnp

    prob = chip_smoke.sharded_ad_problem(np, name)
    args = tuple(jnp.asarray(prob[k]) for k in ("g", "mask", "x0", "c", "d")) + (
        jnp.float64(prob["s"]), jnp.asarray(_weights(name), jnp.float64))
    with _InnerSolves(WORLD if sharded else 1) as inner:
        vals, *counts, gb, sb = _jax_program(_group(name), sharded)(*args)
        vals = np.asarray(vals)  # the run has ended: its callbacks have fired
    return vals, np.asarray(gb), np.asarray(sb), [int(c) for c in counts], inner.numops


def _check_spectral(ranks, name, in_body):
    out = _case(ranks, name)
    vals_u, g_u, s_u, counts_u, applies_u = _jax_spectral(name, sharded=False)
    if in_body:
        vals, g, s, counts, applies = _jax_spectral(name, sharded=True)
        _close(out["s"], s)
    else:
        vals, g, counts, applies = vals_u, g_u, counts_u, applies_u
    _counts_equal(out, counts)
    _close(out["vals"], np.real(np.asarray(vals)))
    _close(out["g"], g)
    _close(out["g"], g_u)
    _close(out["s"].sum(), s_u)
    if in_body and "adjoint_applies" in out:
        # svdsolve's operator cotangent applies the adjoint once more a
        # triplet (its terms on the left vectors); the JAX side counts the
        # inner solves only
        extra = 2 if name.startswith("svdsolve") else 0
        assert out["adjoint_applies"] == applies + extra
    return out


@pytest.mark.parametrize("name", ["eigsolve_gmres", "eigsolve_sylvester_values"])
def test_sharded_eigsolve_gradient_matches_jax_in_body(ranks, name):
    """The GMRES rule (bordered systems on ``(vector, scalar)`` tuples whose
    replicated scalar leaf the all-reduced inner product weighs ``D`` times,
    as the JAX package's) and the Sylvester rule with a cotangent on the
    values: each rank's ``ḡ`` and ``s̄`` are its device's, with equal
    counts."""
    _check_spectral(ranks, name, in_body=True)


@pytest.mark.parametrize("name", ["eigsolve_sylvester", "eigsolve_general"])
def test_sharded_eigsolve_sylvester_gradient_matches_unsharded_jax(ranks, name):
    """The Sylvester rules with eigenvector cotangents (and the general
    rule, whose Gram matrix ``G = VᴴV`` enters even a values-only
    cotangent): the port all-reduces the Gram matrices, so its gradient is
    the unsharded one; the JAX package's in-body one is not (queue 3).  The
    backward's applies are not compared here: the inner eigensolve starts
    from ``(0, ones)``, whose Krylov space turns with the signs of the
    eigenvectors, and torch's and JAX's small eigensolvers pick the signs
    each their own way (198 against 174 applies here, on one device too)."""
    _check_spectral(ranks, name, in_body=False)


def test_jax_in_body_sylvester_gram_is_local():
    """The fault the port avoids: inside ``shard_map`` the JAX package's
    Sylvester pullback reads a device's Gram rows only, so its eigenvector
    cotangent misses the unsharded gradient by far more than the port's
    1e-10."""
    _, g, _, _, _ = _jax_spectral("eigsolve_general", sharded=True)
    _, g_u, _, _, _ = _jax_spectral("eigsolve_general", sharded=False)
    assert not np.allclose(np.asarray(g), np.asarray(g_u), rtol=0, atol=1e-6)


# --------------------------------------------------------------------------
# the cotangent of a psum's output
# --------------------------------------------------------------------------


def test_psum_cotangent_is_summed_over_ranks(ranks):
    """``space.inner(c, b).backward()`` on every rank: the psum's backward
    sums the ranks' cotangents of its output, so each rank's ``b̄`` is ``D``
    times its block of ``c``, as the JAX package's in-body gradient is
    (``psum``'s transpose under ``check_vma=False``).  A replicated loss
    reduced through the space is thus divided by ``D``, or built from the
    ranks' local partials."""
    import jax
    import jax.numpy as jnp

    prob = chip_smoke.sharded_ad_problem(np, "psum_loss")
    space = kk.VectorSpace(psum_axis="vec")
    run = _in_body(lambda c, b: (jax.grad(lambda b: space.inner(c, b))(b),), 2, 0, 1)
    want = run(jnp.asarray(prob["c"]), jnp.asarray(prob["b"]))[0]
    _close(_case(ranks, "psum_loss")["b"], want)
    _close(_case(ranks, "psum_loss")["b"], WORLD * prob["c"])
