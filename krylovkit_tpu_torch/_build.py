"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface.  It is compiled by ``nvcc``
for ``sm_90a`` into ``_build/lib<name>-<hash>.so`` at first use and loaded
with ``ctypes``; the hash of the source names the library, so an edited
source is rebuilt.  ``build()`` starts one ``nvcc`` per source, all at once.

``launches`` counts kernel launches by wrapper name: each wrapper adds one
where it launches its kernel, so a run can show which kernels it went
through.  ``refuse_autograd`` is each wrapper's first check: a launch
through ``data_ptr()`` records no graph, so a wrapper refuses a tensor that
requires grad or that ``torch.func`` has wrapped, on every device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from collections import Counter
from pathlib import Path

__all__ = ["SOURCES", "BUILD_DIR", "launches", "reset_launches", "build",
           "library", "check", "refuse_autograd"]

PKG = Path(__file__).resolve().parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
SOURCES = ("fused_lanczos", "transform", "banded_spmv", "laplacian_1d", "projections")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

launches: Counter = Counter()
_libs: dict = {}


def reset_launches() -> None:
    launches.clear()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _target(name: str):
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=SOURCES) -> float:
    """Compile every library in ``names`` that is not built yet, one ``nvcc``
    process per source, all running together.  Returns the seconds taken.
    The compiler's report (``-Xptxas -v``) goes to ``_build/<name>.log``."""
    t0 = time.perf_counter()
    jobs = []
    try:
        for name in names:
            src, out = _target(name)
            if out.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            jobs.append((name, proc, tmp, out))
        for name, proc, tmp, out in jobs:
            log, _ = proc.communicate()
            (BUILD_DIR / f"{name}.log").write_text(log)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
            os.replace(tmp, out)
    finally:
        for _, proc, _, _ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(_target(name)[1]))
        lib.kk_error_string.argtypes = [ctypes.c_int]
        lib.kk_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise when a C entry returned a CUDA error (``cudaGetLastError()``
    right after the launch)."""
    if status != 0:
        msg = lib.kk_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")


def refuse_autograd(what: str, *tensors) -> None:
    """Raise ``RuntimeError`` when one of ``tensors`` requires grad or is a
    ``torch.func`` wrapper (``vjp``, ``grad``, ``vmap``): the kernel named
    ``what`` has no derivative, and a launch on such a tensor would return a
    result with no graph, a zero gradient nothing would catch (the JAX
    package's ``pallas_call`` has no transpose rule either)."""
    import torch

    for t in tensors:
        if isinstance(t, torch.Tensor) and (
                t.requires_grad or torch._C._functorch.is_functorch_wrapped_tensor(t)):
            raise RuntimeError(
                f"{what}: the kernel is not differentiable and refuses a tensor that "
                "requires grad or is wrapped by torch.func; give the operator an adjoint "
                "(adjoint_fn, a (f, fadjoint) tuple) instead of deriving one, or apply the "
                "kernel's plain version"
            )
