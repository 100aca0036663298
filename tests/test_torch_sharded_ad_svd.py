"""PyTorch port: gradients of a sharded ``svdsolve`` against the JAX package
on the CPU, through the GMRES and Sylvester rules with the adjoint given,
and of ``svdsolve_gkl_batched`` through the GMRES rule
(``tests/test_torch_sharded_ad.py`` says how the two sides run and what
they are held to; ``tests/test_torch_sharded_ad_derived.py`` holds the
derived adjoints).
"""

import pytest

from test_torch_sharded_ad import _check_spectral, run_cases, spectral_refs

NAMES = ("svdsolve_gmres", "svdsolve_sylvester_values", "svdsolve_sylvester",
         "batched_svdsolve_gmres")


@pytest.fixture(scope="module")
def ranks():
    return run_cases(NAMES, spectral_refs(NAMES[:2], True) + spectral_refs(NAMES[2:3], False))


@pytest.mark.parametrize("name", ["svdsolve_gmres", "svdsolve_sylvester_values",
                                  "batched_svdsolve_gmres"])
def test_sharded_svdsolve_gradient_matches_jax_in_body(ranks, name):
    """The GMRES rule and the Sylvester rule with a cotangent on the
    values, against the in-body JAX cotangents: each rank's ``ḡ`` and
    ``s̄`` are its device's, ``s̄`` summed over the ranks the unsharded JAX
    gradient, with equal counts.  ``batched_svdsolve_gmres``:
    ``svdsolve_gkl_batched`` on one ``ParametricOperator`` a problem, each
    problem's ``ḡ`` block, counts and backward applies its device's under
    ``jax.vmap`` (the one reference run of ``svdsolve_gmres``'s problems)."""
    _check_spectral(ranks, name, in_body=True)


def test_sharded_svdsolve_sylvester_gradient_matches_unsharded_jax(ranks):
    """The Sylvester rule with singular-vector cotangents: the port
    all-reduces the Gram matrices, so its gradient is the unsharded one
    (the JAX package's in-body one is not, ROADMAP queue 3)."""
    _check_spectral(ranks, "svdsolve_sylvester", in_body=False)
