"""PyTorch port: batched eager and selective solves on a sharded space (the
counterpart of ``jax.vmap`` over a sharded ``eager=True`` or
``Lanczos(reorth="selective")`` solve).

One group of 4 gloo ranks on the CPU, a ``batch 2 × vec 2`` mesh, runs the
scenarios ``chip_smoke.SHARDED_BATCHED_EAGER`` of
``chip_smoke.sharded_batched_cases``: selective and eager Lanczos on the
sharded ELL operator (float64), eager ``schursolve`` on the sharded
tridiagonal, eager GKL on the sharded rectangular ELL operator, eager
BiArnoldi on the non-symmetric tridiagonal and an eager ``exponentiate``
(float32, unfused) on ``shard_local_stencil``.  Every rank must return the
same bits, and each problem is held against its one-problem sharded solve
on the same ranks: the same bits (two ``vec`` ranks), counts and WARN
lines.  The JAX package's parity of these drivers is in
``tests/test_torch_batched_eager*.py`` and ``..._selective.py``; the
sharded one-problem solves are held against it in
``tests/test_torch_sharded*.py``.
"""

import numpy as np
import pytest

import chip_smoke

WORLD = 4


@pytest.fixture(scope="module")
def ranks():
    res = chip_smoke.run_ranks(WORLD, "sharded_batched_cases", dev="cpu", timeout=400,
                               names=chip_smoke.SHARDED_BATCHED_EAGER)
    return chip_smoke.same_on_every_rank(np, res)


@pytest.mark.parametrize("name", chip_smoke.SHARDED_BATCHED_EAGER)
def test_sharded_eager_and_selective_batches_are_one_problem_solves(ranks, name):
    """Each problem of the batch, split over the ``batch`` axis and sharded
    over two ``vec`` ranks, is its one-problem sharded solve bit for bit,
    with its counts and WARN lines; the batch makes fewer collectives than
    its one-problem solves."""
    out = ranks[name]
    assert "error" not in out, out.get("error")
    assert out["one_problem_bits"], out["one_problem_max_abs_diff"]
    assert out["one_problem_counts"] == [list(c) for c in zip(
        out["numops"], out["numiter"], out["converged"])]
    assert out["warn_lines_equal"]
    assert all(b < o for b, o in zip(out["collectives"], out["one_problem_collectives"]))
