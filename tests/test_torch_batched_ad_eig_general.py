"""PyTorch port: gradients through ``eigsolve_arnoldi_batched`` by
``eigsolve``'s general Sylvester rule (an ``Arnoldi`` ``alg_rrule`` on an
``Arnoldi`` primal; ``ad/batched.py``: the ``P`` Sylvester eigensolves,
projected through each problem's Gram matrix, in one batched Arnoldi)
against ``jax.grad`` over ``jax.vmap`` of the JAX package's ``eigsolve``,
on the CPU.  The helpers, the JAX reference (compiled once for the rule)
and the tolerances are ``test_torch_batched_ad_eig.py``'s.
"""

import numpy as np
import pytest

from test_torch_batched_ad_eig import check_rule, inner_infos  # noqa: F401 - a fixture


@pytest.mark.parametrize("shared", [False, True], ids=["sequence", "shared"])
def test_batched_arnoldi_general_sylvester_rule_matches_jax(shared, inner_infos):  # noqa: F811
    """``P`` general float64 matrices (a sequence, or one shared): within
    ``TOL`` of ``jax.grad`` over ``jax.vmap``; each problem within
    ``TOL_ONE`` of its one-problem gradient; the counts of the forward and
    of the Sylvester eigensolves equal to the one-problem solves'."""
    check_rule("arnoldi", True, inner_infos, shared=shared)


def test_batched_arnoldi_general_sylvester_rule_complex_matches_one_problem(  # noqa: F811
        inner_infos):
    """The complex128 case: each problem's batched gradient within
    ``TOL_ONE`` of its one-problem gradient, with the counts."""
    check_rule("arnoldi", True, inner_infos, dtype=np.complex128)
