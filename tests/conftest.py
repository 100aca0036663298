"""Test harness: run everything on a virtual 8-device CPU mesh with x64 enabled.

Mirrors the reference's CI strategy (``.github/workflows/ci.yml:46-75``): the same
suite is exercised single-device and re-run under parallelism — here via
``--xla_force_host_platform_device_count=8`` so sharded paths execute real
collectives without TPU hardware.
"""

import os

os.environ.setdefault("JAX_TRACEBACK_FILTERING", "off")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import faulthandler

faulthandler.enable()  # native stack on SIGSEGV (see fixture docstring)

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop compiled executables after each test module.

    A single pytest process accumulates hundreds of compiled XLA:CPU
    executables (including 8-device mesh programs); past ~250 compilations the
    CPU client segfaults inside ``backend_compile_and_load`` (observed
    deterministically at round 2 HEAD). Clearing JAX's caches per module keeps
    the number of live executables bounded so the documented single command
    ``python -m pytest tests/ -q`` runs the whole suite green.

    Root-cause status (round 5, tools/segfault_repro.py): NOT a generic
    compile-count budget — 400+ fresh compilations of simple or
    while_loop-heavy programs in one process run clean.  The crash needs the
    suite's specific accumulation (large multi-device mesh executables +
    Pallas interpret programs).  Set ``KK_NO_CLEAR_CACHES=1`` to disable
    this workaround and reproduce with a faulthandler-captured native
    stack."""
    yield
    if not os.environ.get("KK_NO_CLEAR_CACHES"):
        jax.clear_caches()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped where CUDA is unavailable"
    )
