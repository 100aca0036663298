"""Stacked Krylov basis (counterpart of ``krylovkit_tpu/ops/basis.py``).

The basis is one tensor ``V`` of shape ``(kmax,) + vector.shape``; on the
main path ``(kmax, R, 128)`` float32.  The active length ``k`` is a host
``int``.  Unlike the JAX package, updates are in place (``set`` writes
``V[j]``; :func:`transform_partial` rotates the leading rows in place), which
keeps one basis buffer alive per solve.

:func:`transform_partial_inplace` is the wrapper of the hand-written CUDA
kernel ``csrc/transform.cu`` (the port of the TPU kernel
``krylovkit_tpu/ops/basis.py:_pallas_transform_inplace``); its plain version
:func:`transform_partial_inplace_reference` sits beside it and serves CPU
tensors.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .vector import STANDARD, VectorSpace

__all__ = [
    "alloc",
    "get",
    "set",
    "prefix",
    "buckets_for",
    "bucket_for",
    "project",
    "project_bucketed",
    "unproject",
    "unproject_bucketed",
    "transform",
    "transform_partial",
    "transform_partial_inplace",
    "transform_partial_inplace_reference",
    "gram",
    "batch_inner",
]

LANES = 128
# widest basis the transform kernel keeps in registers (csrc/transform.cu)
TRANSFORM_MAX_KMAX = 128


def alloc(template: torch.Tensor, kmax: int, dtype=None) -> torch.Tensor:
    """A zeroed basis of capacity ``kmax`` shaped like ``template``."""
    return torch.zeros(
        (kmax,) + tuple(template.shape), dtype=dtype or template.dtype,
        device=template.device,
    )


def get(V: torch.Tensor, j: int) -> torch.Tensor:
    """Basis vector ``V[j]`` (a view)."""
    return V[j]


def set(V: torch.Tensor, j: int, v: torch.Tensor) -> torch.Tensor:
    """``V[j] = v`` in place; returns ``V``."""
    V[j] = v.to(V.dtype)
    return V


def prefix(V: torch.Tensor, B: int) -> torch.Tensor:
    """The first ``B`` rows of the basis (a view)."""
    return V[:B]


def buckets_for(kmax: int):
    """Static prefix sizes for bucketed basis reads: a step-4 ladder plus
    ``kmax - 1`` and ``kmax`` (coarser steps beyond 64), exactly the JAX
    package's ladder, so both read the same rows."""
    if kmax < 8:
        return (kmax,)
    step = 4 if kmax <= 64 else 8 if kmax <= 128 else 16
    return tuple(sorted({*range(step, kmax, step), kmax - 1, kmax}))


def bucket_for(k: int, kmax: int) -> int:
    """The smallest bucket ``B >= k`` of :func:`buckets_for`."""
    buckets = buckets_for(kmax)
    return next((b for b in buckets if b >= k), buckets[-1])


def project(V: torch.Tensor, x: torch.Tensor, k: int,
            space: VectorSpace = STANDARD) -> torch.Tensor:
    """``c[j] = <V[j], x>`` for ``j < k``, zero beyond — the ``Vᴴx`` kernel
    (reference ``project!!``, ``src/orthonormal.jl:88-118``)."""
    kb = V.shape[0]
    if space.inner_fn is None:
        dt = torch.promote_types(V.dtype, x.dtype)
        c = V.reshape(kb, -1).to(dt).conj() @ x.reshape(-1).to(dt)
        if space.real_inner:
            c = torch.real(c)
    else:
        c = torch.stack([space.inner(V[j], x) for j in range(kb)])
    idx = torch.arange(kb, device=c.device)
    return torch.where(idx < k, c, torch.zeros((), dtype=c.dtype, device=c.device))


def project_bucketed(V: torch.Tensor, x: torch.Tensor, k: int,
                     space: VectorSpace = STANDARD) -> torch.Tensor:
    """:func:`project` over the smallest bucket prefix ``B >= k``, padded
    back to ``kmax`` entries."""
    kmax = V.shape[0]
    if space.inner_fn is not None:
        return project(V, x, k, space)
    B = bucket_for(k, kmax)
    return torch.nn.functional.pad(project(V[:B], x, k, space), (0, kmax - B))


def unproject(V: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``y = Σ_j c[j] V[j]`` — the ``V c`` kernel (reference ``unproject!!``,
    ``src/orthonormal.jl:132-196``).  The caller masks ``c``."""
    kb = V.shape[0]
    dt = torch.promote_types(c.dtype, V.dtype)
    return (c.to(dt) @ V.reshape(kb, -1).to(dt)).reshape(V.shape[1:])


def unproject_bucketed(V: torch.Tensor, c: torch.Tensor, k: int) -> torch.Tensor:
    """``V c`` over the smallest bucket prefix ``B >= k`` (``c`` must be zero
    beyond ``k``)."""
    B = bucket_for(k, V.shape[0])
    return unproject(V[:B], c[:B])


def transform(V: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """``V @ U`` as a new basis: row ``m`` is ``Σ_j U[j, m] V[j]`` (reference
    ``basistransform!``, ``src/orthonormal.jl:291-354``)."""
    kmax = V.shape[0]
    dt = torch.promote_types(U.dtype, V.dtype)
    out = U.to(dt).T @ V.reshape(kmax, -1).to(dt)
    return out.reshape(V.shape).to(V.dtype)


def _leaf_ok(V: torch.Tensor) -> bool:
    """The JAX package's ``_pallas_leaf_ok`` conditions, plus the kernel's
    register budget ``kmax <= TRANSFORM_MAX_KMAX``."""
    return (
        V.ndim == 3
        and V.shape[2] % LANES == 0
        and V.shape[1] % 8 == 0
        and V.dtype in (torch.float32, torch.bfloat16)
        and V.shape[0] <= TRANSFORM_MAX_KMAX
    )


def transform_partial_inplace_reference(V: torch.Tensor, U: torch.Tensor,
                                        m_out: int) -> torch.Tensor:
    """Plain version of the transform kernel: ``V[:m_out] ← (Uᵀ V)[:m_out]``
    in place; rows ``>= m_out`` are not touched."""
    kmax = V.shape[0]
    new = U[:, :m_out].to(V.dtype).T @ V.reshape(kmax, -1)
    V[:m_out] = new.reshape((m_out,) + tuple(V.shape[1:]))
    return V


_transform_lib = None


def _lib():
    global _transform_lib
    if _transform_lib is None:
        lib = _build.library("transform")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.kk_transform_partial.argtypes = [p, p, i, ctypes.c_longlong, i, p]
        lib.kk_transform_partial.restype = i
        _transform_lib = lib
    return _transform_lib


def transform_partial_inplace(V: torch.Tensor, U: torch.Tensor,
                              m_out: int) -> torch.Tensor:
    """``V[:m_out] ← (Uᵀ V)[:m_out]`` in place; rows ``>= m_out`` stay
    bit-identical.  Port of the TPU kernel
    ``krylovkit_tpu/ops/basis.py:_pallas_transform_inplace``.

    A CUDA tensor runs the kernel of ``csrc/transform.cu`` (float32 only);
    a CPU tensor runs :func:`transform_partial_inplace_reference`."""
    kmax = V.shape[0]
    if not (0 < m_out <= kmax) or U.shape != (kmax, kmax):
        raise ValueError(f"bad shapes: V {tuple(V.shape)}, U {tuple(U.shape)}, m_out {m_out}")
    if torch.is_complex(U):
        raise ValueError("transform_partial_inplace needs a real rotation U")
    if V.device.type == "cpu":
        return transform_partial_inplace_reference(V, U, m_out)
    if V.device.type != "cuda":
        raise ValueError(f"unsupported device {V.device}")
    if V.dtype != torch.float32:
        raise ValueError(f"the CUDA transform kernel takes float32, got {V.dtype}")
    if not V.is_contiguous() or not _leaf_ok(V):
        raise ValueError(f"the CUDA transform kernel needs a contiguous (kmax <= "
                         f"{TRANSFORM_MAX_KMAX}, R % 8 == 0, 128) basis, got {tuple(V.shape)}")
    Ut = U[:, :m_out].T.to(device=V.device, dtype=torch.float32).contiguous()
    ncols = V[0].numel()
    lib = _lib()
    status = lib.kk_transform_partial(
        V.data_ptr(), Ut.data_ptr(), kmax, ncols, m_out,
        torch.cuda.current_stream(V.device).cuda_stream,
    )
    _build.check(lib, status, "transform_partial")
    _build.launches["transform_partial"] += 1
    return V


def transform_partial(V: torch.Tensor, U: torch.Tensor, m_out: int) -> torch.Tensor:
    """``V[:m_out] ← (V @ U)[:m_out]``.  For a ``(kmax, R, 128)`` float32 or
    bfloat16 basis with ``R % 8 == 0`` and a real ``U`` (the JAX package's
    in-place kernel conditions) this runs :func:`transform_partial_inplace`
    and rows ``>= m_out`` keep their contents; any other basis gets the full
    product :func:`transform` (the JAX fallback), whose tail rows are the
    full rotation.  The two agree whenever ``U`` is the identity on the tail
    — the gated-off restart; otherwise the tail is dead by masking."""
    if _leaf_ok(V) and not torch.is_complex(U):
        return transform_partial_inplace(V, U, m_out)
    return transform(V, U)


def gram(X: torch.Tensor, Y: torch.Tensor, space: VectorSpace = STANDARD) -> torch.Tensor:
    """``G[i, j] = <X[i], Y[j]>`` between two stacked bases."""
    if space.inner_fn is not None:
        return torch.stack([torch.stack([space.inner(x, y) for y in Y]) for x in X])
    dt = torch.promote_types(X.dtype, Y.dtype)
    g = X.reshape(X.shape[0], -1).to(dt).conj() @ Y.reshape(Y.shape[0], -1).to(dt).T
    return torch.real(g) if space.real_inner else g


def batch_inner(X: torch.Tensor, Y: torch.Tensor,
                space: VectorSpace = STANDARD) -> torch.Tensor:
    """``c[i] = <X[i], Y[i]>`` row-wise between two stacked bases."""
    if space.inner_fn is not None:
        return torch.stack([space.inner(x, y) for x, y in zip(X, Y)])
    dt = torch.promote_types(X.dtype, Y.dtype)
    c = (X.reshape(X.shape[0], -1).to(dt).conj() * Y.reshape(Y.shape[0], -1).to(dt)).sum(1)
    return torch.real(c) if space.real_inner else c
