"""PyTorch port: gradients through ``svdsolve_gkl_batched`` by
``svdsolve``'s GMRES rule (``ad/batched.py``: the ``P × howmany`` coupled
``(x, y)`` systems in one batched GMRES) against ``jax.grad`` over
``jax.vmap`` of the JAX package's ``svdsolve``, on the CPU; the Sylvester
rule is in ``test_torch_batched_ad_svd_sylvester.py``.  The helpers, the
JAX reference (compiled once for the rule) and the tolerances are
``test_torch_batched_ad_eig.py``'s.
"""

import pytest

from test_torch_batched_ad_eig import check_rule, inner_infos  # noqa: F401 - a fixture


@pytest.mark.parametrize("shared", [False, True], ids=["sequence", "shared"])
def test_batched_gkl_gmres_rule_matches_jax(shared, inner_infos):  # noqa: F811
    """``P`` float64 ``2N × N`` matrices (a sequence, or one shared), the two
    largest singular values and the first pair's vectors: within ``TOL`` of
    ``jax.grad`` over ``jax.vmap``; each problem within ``TOL_ONE`` of its
    one-problem gradient; the counts of the forward and of the coupled
    systems equal to the one-problem solves'."""
    check_rule("gkl", False, inner_infos, shared=shared)


def test_chip_smoke_batched_ad_phase_rehearses_on_cpu():
    """``chip_smoke.py``'s phase ``batched_ad`` on a 32 × 32 grid on the CPU
    (plain versions; the launch counts are the card's to check): through
    both eigsolve rules every problem's gradient meets Hellmann–Feynman and
    its one-problem gradient, through the CG rule the independent solves;
    its small float64 batches run alike on the CPU twice."""
    import numpy as np
    import torch

    import chip_smoke
    import krylovkit_tpu_torch as kt
    from krylovkit_tpu_torch import _build

    out = chip_smoke.batched_ad_phase(torch, np, kt, _build, N=32, dev="cpu")
    assert set(out["launches"]) == {"wells_gmres", "wells_sylvester", "potential_cg"}

