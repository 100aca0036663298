"""The 1-D Dirichlet Laplacian as a hand-written kernel — the counterpart of
``krylovkit_tpu/ops/pallas_stencil.py``, named for the operator rather than
for the TPU kernel language:

    y[i] = 2 x[i] − x[i−1] − x[i+1]        (zero outside [0, n))

:func:`laplacian_1d_flat` is the wrapper of the CUDA kernel
``csrc/laplacian_1d.cu`` (the port of the TPU kernel
``krylovkit_tpu/ops/pallas_stencil.py:_kernel``); its plain version
:func:`laplacian_1d_flat_reference` sits beside it and serves CPU tensors.
:func:`laplacian_1d_pallas` keeps the JAX operator's name and contract, and
returns a :class:`Laplacian1DOperator`, by which a batched solve knows to
apply it to a stack of vectors with :func:`laplacian_1d_flat_batched` (one
launch of ``kk_laplacian_1d_batched``, the TPU kernel under ``jax.vmap``).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from .. import _build
from .operator import LinearOperator, _shift_flat, resolve_device

__all__ = ["Laplacian1DOperator", "laplacian_1d_pallas", "laplacian_1d_flat",
           "laplacian_1d_flat_batched", "laplacian_1d_flat_batched_reference",
           "laplacian_1d_flat_reference"]

LANES = 128


def laplacian_1d_flat_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version: ``(2x[i] − x[i−1]) − x[i+1]`` on the flattening of
    ``x``, as a flat ``(n,)`` vector."""
    xf = x.reshape(-1)
    return 2 * xf - _shift_flat(xf, -1) - _shift_flat(xf, 1)


def laplacian_1d_flat_batched_reference(X: torch.Tensor) -> torch.Tensor:
    """Plain version of the batched map: :func:`laplacian_1d_flat_reference`'s
    operations on every row of the stack ``X`` at once, as ``(rows, n)``."""
    Xf = X.reshape(X.shape[0], -1)
    return 2 * Xf - _shift_flat(Xf, -1) - _shift_flat(Xf, 1)


_stencil_lib = None


def _lib():
    global _stencil_lib
    if _stencil_lib is None:
        lib = _build.library("laplacian_1d")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.kk_laplacian_1d.argtypes = [p, p, ctypes.c_longlong, i, p]
        lib.kk_laplacian_1d.restype = i
        ll = ctypes.c_longlong
        lib.kk_laplacian_1d_batched.argtypes = [p, p, ll, ll, ll, i, i, p]
        lib.kk_laplacian_1d_batched.restype = i
        _stencil_lib = lib
    return _stencil_lib


def laplacian_1d_flat(x: torch.Tensor) -> torch.Tensor:
    """The 1-D Dirichlet Laplacian of the flattening of ``x``, returned as a
    flat ``(n,)`` vector.

    A CUDA tensor runs the kernel of ``csrc/laplacian_1d.cu`` (float32 or
    float64); a CPU tensor (or a ``meta`` one, to infer the result type) runs
    :func:`laplacian_1d_flat_reference`.  A tensor that requires grad or is
    wrapped by ``torch.func`` is refused (``_build.refuse_autograd``)."""
    _build.refuse_autograd("laplacian_1d", x)
    if x.device.type in ("cpu", "meta"):
        return laplacian_1d_flat_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the CUDA 1-D Laplacian takes float32 or float64, got {x.dtype}")
    xf = x.reshape(-1)
    if not xf.is_contiguous() or xf.data_ptr() % 16:
        xf = xf.clone(memory_format=torch.contiguous_format)
    y = torch.empty_like(xf)
    lib = _lib()
    status = lib.kk_laplacian_1d(
        xf.data_ptr(), y.data_ptr(), xf.numel(), int(x.dtype == torch.float64),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, status, "laplacian_1d")
    _build.launches["laplacian_1d"] += 1
    return y


def laplacian_1d_flat_batched(X: torch.Tensor) -> torch.Tensor:
    """:func:`laplacian_1d_flat` of each row of the stack ``X`` (``(rows,
    ...)``), returned as ``(rows, n)``.

    A CUDA tensor runs ``kk_laplacian_1d_batched`` of
    ``csrc/laplacian_1d.cu`` (float32 or float64), one launch for every row,
    each row bit-identical to a :func:`laplacian_1d_flat` launch on it; a
    CPU or ``meta`` tensor runs :func:`laplacian_1d_flat_batched_reference`.
    Refuses what :func:`laplacian_1d_flat` refuses."""
    _build.refuse_autograd("laplacian_1d_batched", X)
    if X.device.type in ("cpu", "meta"):
        return laplacian_1d_flat_batched_reference(X)
    if X.device.type != "cuda":
        raise ValueError(f"unsupported device {X.device}")
    if X.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the CUDA 1-D Laplacian takes float32 or float64, got {X.dtype}")
    rows = X.shape[0]
    if rows > 65535:
        raise ValueError(f"the CUDA 1-D Laplacian takes at most 65535 rows a launch, got {rows}")
    Xf = X.reshape(rows, -1)
    n = Xf.shape[1]
    vec = 16 // X.element_size()
    ld = -(-n // vec) * vec
    if Xf.stride(1) != 1 or Xf.stride(0) != ld or Xf.data_ptr() % 16:
        Xp = torch.zeros((rows, ld), dtype=X.dtype, device=X.device)
        Xp[:, :n] = Xf
        Xf = Xp
    Y = torch.empty((rows, ld), dtype=X.dtype, device=X.device)
    lib = _lib()
    status = lib.kk_laplacian_1d_batched(
        Xf.data_ptr(), Y.data_ptr(), n, ld, ld, rows, int(X.dtype == torch.float64),
        torch.cuda.current_stream(X.device).cuda_stream,
    )
    _build.check(lib, status, "laplacian_1d_batched")
    _build.launches["laplacian_1d_batched"] += 1
    return Y[:, :n]


@dataclasses.dataclass(frozen=True)
class Laplacian1DOperator(LinearOperator):
    """The kernel-backed 1-D Dirichlet Laplacian of
    :func:`laplacian_1d_pallas` on vectors of ``n`` entries: a
    :class:`LinearOperator` whose ``normal`` and ``adjoint`` are the JAX
    operator's ``(apply, apply)`` pair, so it is checked as a caller's pair
    (``pair_from_caller``) where the JAX package checks one."""

    n: int = 0
    pair_from_caller = True

    def __init__(self, n: int):
        object.__setattr__(self, "n", int(n))
        object.__setattr__(self, "normal", self._apply)
        object.__setattr__(self, "adjoint", self._apply)

    def _apply(self, x):
        if x.numel() != self.n:
            raise ValueError(f"vector of {x.numel()} entries for an n={self.n} Laplacian")
        return laplacian_1d_flat(x)


def laplacian_1d_pallas(n: int, dtype=torch.float32, device="cuda") -> Laplacian1DOperator:
    """Kernel-backed 1-D Dirichlet Laplacian on vectors of ``n`` entries, the
    JAX operator's contract: ``n`` must be a multiple of 128, and the result
    is a flat ``(n,)`` vector whatever the input's shape, in the input's
    type.  ``dtype`` (float32 or float64, the types the kernel takes) names
    the vectors the operator is built for; ``device`` is checked here."""
    if n % LANES != 0:
        raise ValueError(f"n={n} must be a multiple of {LANES}")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype must be float32 or float64, got {dtype}")
    resolve_device(device)
    return Laplacian1DOperator(n)
