"""PyTorch port: batched eager exponential integrators
(``expintegrator_batched`` with two vectors, ``exponentiate_batched``, a
``Lanczos(eager=True)``) against ``jax.jit(jax.vmap(...))`` of the JAX
package's ``_expintegrator_core`` on the same numpy-seeded float64 inputs
(``tests/batched_eager_specs.py``), each problem against the port's own
one-problem eager integration.

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
@pytest.mark.parametrize("driver", ["expintegrator_batched", "exponentiate_batched"])
def test_batched_eager_integrators_match_jax_vmap(driver, case):
    """An eager integration (t = 0.5, tol 1e-8) makes one step a cycle and
    attempts the remaining interval: values within 1e-10 of the vmapped JAX
    driver, counts equal, each problem its one-problem eager integration."""
    check_against_jax(driver, case)
