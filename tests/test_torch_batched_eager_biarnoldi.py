"""PyTorch port: batched eager ``bieigsolve_batched``
(``BiArnoldi(eager=True)``, the start as both ``v0`` and ``w0``) against
``jax.jit(jax.vmap(...))`` of the JAX package's ``bieigsolve_driver`` on the
same numpy-seeded float64 inputs (``tests/batched_eager_specs.py``), each
problem against the port's own one-problem eager solve.  A file of its own:
the JAX compile takes most of its time on the CPU.

Tolerances: values within 1e-10 of the JAX package's; ``numops``,
``numiter`` and ``converged`` equal; on a shared matrix each problem
bit-identical (``torch.equal``) to its one-problem solve, on a matrix stack
its values within 1e-12.
"""

import pytest
import torch

from batched_eager_specs import check_against_jax

torch.set_num_threads(2)


@pytest.mark.parametrize("case", ["matrix_stack", "shared_matrix"])
def test_batched_eager_bieigsolve_matches_jax_vmap(case):
    """``eager=True``, 1 "LR": values within 1e-10 of the vmapped JAX
    driver, counts equal, each problem its one-problem eager solve."""
    check_against_jax("bieigsolve_batched", case)
