"""PyTorch port: gradients through ``svdsolve_gkl_batched`` by
``svdsolve``'s Sylvester rule (an ``Arnoldi`` ``alg_rrule``;
``ad/batched.py``: the ``P`` eigensolves on ``(x, y, z)`` tuples in one
batched Arnoldi) against ``jax.grad`` over ``jax.vmap`` of the JAX
package's ``svdsolve``, on the CPU.  The helpers, the JAX reference
(compiled once for the rule) and the tolerances are
``test_torch_batched_ad_eig.py``'s.
"""

import pytest

from test_torch_batched_ad_eig import check_rule, inner_infos  # noqa: F401 - a fixture


@pytest.mark.parametrize("shared", [False, True], ids=["sequence", "shared"])
def test_batched_gkl_sylvester_rule_matches_jax(shared, inner_infos):  # noqa: F811
    """``P`` float64 ``2N × N`` matrices (a sequence, or one shared): within
    ``TOL`` of ``jax.grad`` over ``jax.vmap``; each problem within
    ``TOL_ONE`` of its one-problem gradient; the counts of the forward and
    of the Sylvester eigensolves equal to the one-problem solves'."""
    check_rule("gkl", True, inner_infos, shared=shared)
