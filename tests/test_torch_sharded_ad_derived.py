"""PyTorch port: gradients of a sharded ``svdsolve`` whose operator has no
``adjoint_fn``, against the JAX package's in-body cotangents on the CPU
(``tests/test_torch_sharded_ad.py`` says how the two sides run and what
they are held to).

The adjoint is derived across the ranks by ``torch.autograd``, and where a
parameter requires grad the operator cotangent's ``("adjoint", u, ·)``
terms differentiate the derived adjoint once more, so the transposed
collectives are differentiated themselves: through the edge exchange
(``svdsolve_derived_scaled``: ``x ↦ (1 + g)⊙(A x) + s·mask⊙x``) and through
the space's psum (``svdsolve_derived_rank1``: ``x ↦ A x + g⊙x +
s·⟨mask, x⟩·d``).  Dropping either term would leave ``ḡ`` or ``s̄`` wrong
by far more than the 1e-10 they are held to.
"""

import pytest

from test_torch_sharded_ad import _check_spectral, run_cases, spectral_refs

NAMES = ("svdsolve_derived", "svdsolve_derived_scaled", "svdsolve_derived_rank1")


@pytest.fixture(scope="module")
def ranks():
    return run_cases(NAMES, spectral_refs(NAMES, True))


@pytest.mark.parametrize("name", NAMES)
def test_sharded_svdsolve_derived_gradient_matches_jax_in_body(ranks, name):
    """Each rank's ``ḡ`` and ``s̄`` are its device's (the JAX package's
    adjoint transposed by ``jax.linear_transpose`` in the body), ``s̄``
    summed over the ranks the unsharded JAX gradient, with equal counts."""
    _check_spectral(ranks, name, in_body=True)
