"""PyTorch port: gradients through ``eigsolve_lanczos_batched`` by
``eigsolve``'s Sylvester rule (an ``Arnoldi`` ``alg_rrule``;
``ad/batched.py``: the ``P`` subspace-aware Sylvester eigensolves on ``(w,
x)`` tuples in one batched Arnoldi, each with its own nearest-value
sorter) against ``jax.grad`` over ``jax.vmap`` of the JAX package's
``eigsolve``, on the CPU.  The helpers, the JAX reference (compiled once
for the rule) and the tolerances are ``test_torch_batched_ad_eig.py``'s.
"""

import numpy as np
import pytest

from test_torch_batched_ad_eig import check_rule, inner_infos  # noqa: F401 - a fixture


@pytest.mark.parametrize("shared", [False, True], ids=["sequence", "shared"])
def test_batched_lanczos_sylvester_rule_matches_jax(shared, inner_infos):  # noqa: F811
    """``P`` Hermitian float64 matrices (a sequence, or one shared), the two
    lowest values and the first eigenvector: within ``TOL`` of
    ``jax.grad`` over ``jax.vmap``; each problem within ``TOL_ONE`` of its
    one-problem gradient; the ``P`` Sylvester eigensolves in one batched
    Arnoldi with the one-problem rule's counts."""
    check_rule("lanczos", True, inner_infos, shared=shared)


def test_batched_lanczos_sylvester_rule_complex_matches_one_problem(inner_infos):  # noqa: F811
    """The complex128 Hermitian case: each problem's batched gradient
    within ``TOL_ONE`` of its one-problem gradient, with the counts."""
    check_rule("lanczos", True, inner_infos, dtype=np.complex128)
