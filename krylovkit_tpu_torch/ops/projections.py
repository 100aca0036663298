"""Basis projections that read only the live rows (counterpart of
``krylovkit_tpu/ops/pallas_basis.py``).

``project_pallas(V, w, k)`` is ``c[j] = <V[j], w>`` for ``j < k`` (zero
beyond) and ``unproject_pallas(V, c, k)`` is ``y = Σ_{j<k} c[j] V[j]``, on a
``(kmax, R, 128)`` float32 basis: the two halves of a classical Gram-Schmidt
sweep.  The names are the JAX package's, so a reader finds the counterpart;
here they are the wrappers of the hand-written CUDA kernels of
``csrc/projections.cu``.  Each sits beside its plain PyTorch version
(:func:`project_reference`, :func:`unproject_reference`), which serves CPU
tensors; a CUDA tensor launches the kernel or raises.

``k`` is a host ``int`` or a 1-element int32 tensor on the basis's device.
A tensor reaches the kernel as a pointer and is never read on the host: the
launch is the same for every ``k`` (the kernel clamps it to ``[0, kmax]``),
and rows ``>= k`` of the basis are never read.

``ops/basis.py`` routes ``project``/``unproject`` here when its module flag
``use_pallas_projections`` is on.

:func:`project_pallas_batched` and :func:`unproject_pallas_batched` run the
two kernels for ``P`` problems in one launch (the TPU kernels under
``jax.vmap``), each problem on its own basis, operand and host ``int`` ``k``;
each problem's result is the one-problem launch's, bit for bit.  Their plain
versions loop the one-problem plain versions.
"""

from __future__ import annotations

import ctypes
from typing import Union

import torch

from .. import _build

__all__ = [
    "LANES",
    "MAX_KMAX",
    "supported_leaf",
    "project_pallas",
    "project_reference",
    "unproject_pallas",
    "unproject_reference",
    "MAX_BATCH",
    "project_pallas_batched",
    "project_batched_reference",
    "unproject_pallas_batched",
    "unproject_batched_reference",
]

LANES = 128
# widest basis the kernels take (csrc/projections.cu kMaxK): the warp sums of
# project and the coefficients of unproject sit in shared memory by row
MAX_KMAX = 128

LiveRows = Union[int, torch.Tensor]


def supported_leaf(V: torch.Tensor) -> bool:
    """True if ``V`` is a basis these kernels take: ``(kmax, R, 128)``
    float32 with ``R % 8 == 0`` (the JAX package's rule) and
    ``kmax <= MAX_KMAX`` (this port's shared-memory budget)."""
    return (
        V.ndim == 3
        and V.shape[2] == LANES
        and V.shape[1] % 8 == 0
        and V.dtype == torch.float32
        and V.shape[0] <= MAX_KMAX
    )


def _host_k(k: LiveRows) -> int:
    return int(k.item()) if isinstance(k, torch.Tensor) else int(k)


def project_reference(V: torch.Tensor, w: torch.Tensor, k: LiveRows) -> torch.Tensor:
    """Plain version of the project kernel: reads ``V[:k]`` only."""
    k = _host_k(k)
    kmax = V.shape[0]
    c = torch.zeros(kmax, dtype=torch.float32, device=V.device)
    if k > 0:
        c[:k] = V[:k].reshape(k, -1) @ w.reshape(-1)
    return c


def unproject_reference(V: torch.Tensor, c: torch.Tensor, k: LiveRows) -> torch.Tensor:
    """Plain version of the unproject kernel: adds ``c[j]·V[j]`` for
    ``j = 0 … k−1`` in ascending order, as the kernel does, and reads
    ``V[:k]`` only."""
    k = _host_k(k)
    c = c.to(torch.float32)
    y = torch.zeros(V.shape[1:], dtype=torch.float32, device=V.device)
    for j in range(k):
        y = torch.addcmul(y, c[j], V[j])
    return y


_proj_lib = None


def _lib():
    global _proj_lib
    if _proj_lib is None:
        lib = _build.library("projections")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.kk_project_blocks.argtypes = [ll]
        lib.kk_project_blocks.restype = i
        lib.kk_project.argtypes = [p, p, p, p, p, i, i, ll, p]
        lib.kk_project.restype = i
        lib.kk_unproject.argtypes = [p, p, p, p, i, i, ll, p]
        lib.kk_unproject.restype = i
        lib.kk_project_batched.argtypes = [p, p, p, i, p, p, i, ll, p]
        lib.kk_project_batched.restype = i
        lib.kk_unproject_batched.argtypes = [p, p, p, i, p, i, ll, p]
        lib.kk_unproject_batched.restype = i
        _proj_lib = lib
    return _proj_lib


def _check(name: str, V: torch.Tensor, x: torch.Tensor, xshape, k: LiveRows):
    """Shared gates of both wrappers; returns ``(k pointer, k value)`` for
    the C entry (CUDA tensors) after validating everything a host can."""
    if V.ndim != 3 or V.shape[2] != LANES or V.shape[1] % 8 != 0:
        raise ValueError(f"{name} needs a (kmax, R % 8 == 0, 128) basis, got {tuple(V.shape)}")
    if V.dtype != torch.float32 or x.dtype != torch.float32:
        raise ValueError(f"{name} takes float32, got {V.dtype} and {x.dtype}")
    if tuple(x.shape) != tuple(xshape):
        raise ValueError(f"{name}: operand of shape {tuple(x.shape)}, expected {tuple(xshape)}")
    if x.device != V.device:
        raise ValueError(f"{name}: operands on {V.device} and {x.device}")
    kmax = V.shape[0]
    if isinstance(k, torch.Tensor):
        if k.dtype != torch.int32 or k.numel() != 1 or k.device != V.device:
            raise ValueError(f"{name}: a tensor k must be one int32 on {V.device}")
        return k.data_ptr(), 0
    k = int(k)
    if not 0 <= k <= kmax:
        raise ValueError(f"{name} needs 0 <= k <= kmax = {kmax}, got k = {k}")
    return None, k


def _check_cuda(name: str, V: torch.Tensor, *others: torch.Tensor):
    if V.device.type != "cuda":
        raise ValueError(f"unsupported device {V.device}")
    if V.shape[0] > MAX_KMAX:
        raise ValueError(f"the CUDA {name} kernel takes kmax <= {MAX_KMAX}, got {V.shape[0]}")
    for t in (V, *others):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"the CUDA {name} kernel needs contiguous, 16-byte aligned tensors")


def project_pallas(V: torch.Tensor, w: torch.Tensor, k: LiveRows) -> torch.Tensor:
    """``c[j] = <V[j], w>`` for ``j < k``, zero beyond: a ``(kmax,)`` float32
    vector.  Port of the TPU kernel ``krylovkit_tpu/ops/pallas_basis.py:
    project_pallas``.  Rows ``>= k`` of ``V`` are never read, and two calls on
    the same input agree to the bit (fixed-order reduction).

    A CUDA basis runs the kernel of ``csrc/projections.cu``; a CPU basis runs
    :func:`project_reference`.  A tensor that requires grad or is wrapped by
    ``torch.func`` is refused (``_build.refuse_autograd``)."""
    _build.refuse_autograd("project", V, w)
    kptr, kval = _check("project_pallas", V, w, V.shape[1:], k)
    if V.device.type == "cpu":
        return project_reference(V, w, k)
    _check_cuda("project", V, w)
    kmax = V.shape[0]
    ncols = V[0].numel()
    lib = _lib()
    c = torch.empty(kmax, dtype=torch.float32, device=V.device)
    partials = torch.empty((lib.kk_project_blocks(ncols), kmax), dtype=torch.float32,
                           device=V.device)
    status = lib.kk_project(
        V.data_ptr(), w.data_ptr(), partials.data_ptr(), c.data_ptr(), kptr, kval,
        kmax, ncols, torch.cuda.current_stream(V.device).cuda_stream,
    )
    _build.check(lib, status, "project")
    _build.launches["project"] += 1
    return c


def unproject_pallas(V: torch.Tensor, c: torch.Tensor, k: LiveRows) -> torch.Tensor:
    """``y = Σ_{j<k} c[j] V[j]``, an ``(R, 128)`` float32 vector; ``c`` is a
    real ``(kmax,)`` vector already zero beyond ``k``.  Port of the TPU kernel
    ``krylovkit_tpu/ops/pallas_basis.py:unproject_pallas``.  Rows ``>= k`` of
    ``V`` are never read.

    A CUDA basis runs the kernel of ``csrc/projections.cu``; a CPU basis runs
    :func:`unproject_reference`.  A tensor that requires grad or is wrapped
    by ``torch.func`` is refused (``_build.refuse_autograd``)."""
    _build.refuse_autograd("unproject", V, c)
    if torch.is_complex(c) or not torch.is_floating_point(c):
        raise ValueError(f"unproject_pallas needs real floating coefficients, got {c.dtype}")
    c = c.to(torch.float32).contiguous()
    kptr, kval = _check("unproject_pallas", V, c, (V.shape[0],), k)
    if V.device.type == "cpu":
        return unproject_reference(V, c, k)
    _check_cuda("unproject", V)
    kmax = V.shape[0]
    ncols = V[0].numel()
    lib = _lib()
    y = torch.empty(V.shape[1:], dtype=torch.float32, device=V.device)
    status = lib.kk_unproject(
        V.data_ptr(), c.data_ptr(), y.data_ptr(), kptr, kval, kmax, ncols,
        torch.cuda.current_stream(V.device).cuda_stream,
    )
    _build.check(lib, status, "unproject")
    _build.launches["unproject"] += 1
    return y


# problems one batched launch takes (csrc/projections.cu kMaxProblems); the
# wrappers launch a longer list in chunks of this many
MAX_BATCH = 64

_batch_scratch: dict = {}


def _batched_operands(name: str, Vs, xs, ks, operand_shape):
    """The lists ``(Vs, xs, ks)`` of a batched call, each problem checked as
    the one-problem wrapper checks it; every basis of one shape, type and
    device."""
    Vs, xs = list(Vs), list(xs)
    ks = [int(k.item()) if isinstance(k, torch.Tensor) else int(k) for k in ks]
    if not Vs or len(xs) != len(Vs) or len(ks) != len(Vs):
        raise ValueError(f"{name}: {len(Vs)} bases, {len(xs)} operands and {len(ks)} k")
    V0 = Vs[0]
    for V, x, k in zip(Vs, xs, ks):
        if (V.shape, V.dtype, V.device) != (V0.shape, V0.dtype, V0.device):
            raise ValueError(f"{name}: bases of shapes {tuple(V0.shape)} and {tuple(V.shape)}, "
                             f"or on {V0.device} and {V.device}")
        _check(name, V, x, operand_shape(V), k)
    return Vs, xs, ks


def project_batched_reference(Vs, ws, ks) -> torch.Tensor:
    """Plain version of the batched project: :func:`project_reference` of
    each problem, stacked ``(P, kmax)``."""
    Vs, ws, ks = _batched_operands("project_batched", Vs, ws, ks, lambda V: V.shape[1:])
    return torch.stack([project_reference(V, w, k) for V, w, k in zip(Vs, ws, ks)])


def unproject_batched_reference(Vs, cs, ks) -> torch.Tensor:
    """Plain version of the batched unproject: :func:`unproject_reference` of
    each problem, stacked ``(P, R, 128)``."""
    cs = [c.to(torch.float32) for c in cs]
    Vs, cs, ks = _batched_operands("unproject_batched", Vs, cs, ks, lambda V: (V.shape[0],))
    return torch.stack([unproject_reference(V, c, k) for V, c, k in zip(Vs, cs, ks)])


def _batch_partials(device: torch.device, floats: int) -> torch.Tensor:
    """Per device: the partials of a batched project launch, grown to
    ``floats``.  One stream at a time may use them (a one-problem launch
    has its own)."""
    buf = _batch_scratch.get(device)
    if buf is None or buf.numel() < floats:
        buf = torch.empty(floats, dtype=torch.float32, device=device)
        _batch_scratch[device] = buf
    return buf


def _pointers(ts):
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


def project_pallas_batched(Vs, ws, ks) -> torch.Tensor:
    """``C[p, j] = <V_p[j], w_p>`` for ``j < k_p``, zero beyond, for ``P``
    problems: ``Vs`` ``P`` bases ``(kmax, R, 128)`` float32 of one shape (a
    ``(P, kmax, R, 128)`` stack iterates as one), ``ws`` ``P`` operands,
    ``ks`` ``P`` host ints.  Returns ``C (P, kmax)``; row ``p`` is
    :func:`project_pallas` of problem ``p`` bit for bit, and rows ``>= k_p``
    of its basis are never read.

    A CUDA basis runs ``kk_project_batched`` of ``csrc/projections.cu``,
    :data:`MAX_BATCH` problems a launch; a CPU basis runs
    :func:`project_batched_reference`."""
    Vs, ws = list(Vs), list(ws)
    _build.refuse_autograd("project_batched", *Vs, *ws)
    Vs, ws, ks = _batched_operands("project_batched", Vs, ws, ks, lambda V: V.shape[1:])
    V0 = Vs[0]
    if V0.device.type == "cpu":
        return project_batched_reference(Vs, ws, ks)
    _check_cuda("project_batched", V0)
    for V, w in zip(Vs, ws):
        _check_cuda("project_batched", V, w)
    kmax, ncols, P = V0.shape[0], V0[0].numel(), len(Vs)
    lib = _lib()
    nblocks = lib.kk_project_blocks(ncols)
    chunk = min(P, MAX_BATCH)
    partials = _batch_partials(V0.device, chunk * nblocks * kmax)
    C = torch.empty((P, kmax), dtype=torch.float32, device=V0.device)
    stream = torch.cuda.current_stream(V0.device).cuda_stream
    for c0 in range(0, P, MAX_BATCH):
        part = range(c0, min(c0 + MAX_BATCH, P))
        status = lib.kk_project_batched(
            _pointers([Vs[i] for i in part]), _pointers([ws[i] for i in part]),
            (ctypes.c_int * len(part))(*[ks[i] for i in part]), len(part),
            partials.data_ptr(), C[c0].data_ptr(), kmax, ncols, stream,
        )
        _build.check(lib, status, "project_batched")
        _build.launches["project_batched"] += 1
    return C


def unproject_pallas_batched(Vs, cs, ks) -> torch.Tensor:
    """``Y[p] = Σ_{j<k_p} c_p[j] V_p[j]`` for ``P`` problems (``cs`` real
    ``(kmax,)`` vectors, each zero beyond its ``k``).  Returns ``Y (P, R,
    128)``; row ``p`` is :func:`unproject_pallas` of problem ``p`` bit for
    bit, and rows ``>= k_p`` of its basis are never read.

    A CUDA basis runs ``kk_unproject_batched`` of ``csrc/projections.cu``,
    :data:`MAX_BATCH` problems a launch; a CPU basis runs
    :func:`unproject_batched_reference`."""
    Vs, cs = list(Vs), list(cs)
    _build.refuse_autograd("unproject_batched", *Vs, *cs)
    for c in cs:
        if torch.is_complex(c) or not torch.is_floating_point(c):
            raise ValueError(f"unproject_pallas_batched needs real floating coefficients, "
                             f"got {c.dtype}")
    cs = [c.to(torch.float32).contiguous() for c in cs]
    Vs, cs, ks = _batched_operands("unproject_batched", Vs, cs, ks, lambda V: (V.shape[0],))
    V0 = Vs[0]
    if V0.device.type == "cpu":
        return unproject_batched_reference(Vs, cs, ks)
    for V in Vs:
        _check_cuda("unproject_batched", V)
    kmax, ncols, P = V0.shape[0], V0[0].numel(), len(Vs)
    lib = _lib()
    Y = torch.empty((P,) + tuple(V0.shape[1:]), dtype=torch.float32, device=V0.device)
    stream = torch.cuda.current_stream(V0.device).cuda_stream
    for c0 in range(0, P, MAX_BATCH):
        part = range(c0, min(c0 + MAX_BATCH, P))
        status = lib.kk_unproject_batched(
            _pointers([Vs[i] for i in part]), _pointers([cs[i] for i in part]),
            (ctypes.c_int * len(part))(*[ks[i] for i in part]), len(part),
            Y[c0].data_ptr(), kmax, ncols, stream,
        )
        _build.check(lib, status, "unproject_batched")
        _build.launches["unproject_batched"] += 1
    return Y
