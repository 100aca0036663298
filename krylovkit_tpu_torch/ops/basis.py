"""Stacked Krylov basis (counterpart of ``krylovkit_tpu/ops/basis.py``).

The basis of a tensor vector is one tensor ``V`` of shape ``(kmax,) +
vector.shape``; on the main path ``(kmax, R, 128)`` float32.  The basis of a
pytree vector is the same pytree with every leaf stacked so, and every
operation here runs leaf by leaf (the contractions sum their per-leaf
parts).  The active length ``k`` is a host ``int``.  Unlike the JAX package, updates are in place (``set`` writes
``V[j]``; :func:`transform_partial` rotates the leading rows in place), which
keeps one basis buffer alive per solve.

:func:`transform_partial_inplace` is the wrapper of the hand-written CUDA
kernel ``csrc/transform.cu`` (the port of the TPU kernel
``krylovkit_tpu/ops/basis.py:_pallas_transform_inplace``); its plain version
:func:`transform_partial_inplace_reference` sits beside it and serves CPU
tensors.  :func:`transform_partial` decides per leaf: an eligible leaf
runs the kernel, any other the plain product.
:func:`transform_partial_inplace_batched` rotates ``P`` bases ``(P, kmax,
R, 128)``, each by its own ``U``, in one launch (the TPU kernel under
``jax.vmap``); its plain version loops the one-problem one.

With the module flag :data:`use_pallas_projections` on, :func:`project` and
:func:`unproject` (given ``k``) send an eligible basis to the live-row
kernels of ``ops/projections.py``; any other basis, a pytree basis
included, keeps the ``@`` path.  :func:`project_batched` and
:func:`unproject_batched` do the same for the problems of a batched solve:
one batched launch where the flag is on and every problem's basis is
eligible, else each problem through :func:`project` / :func:`unproject`.
:func:`project_batched`, :func:`gram_batched` and
:func:`batch_inner_batched` finish the local partials of all their
problems at once: on a sharded space one all-reduce of the stack, each
problem's slab the local product of its one-problem function, so over two
ranks each keeps that function's bits.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from .. import _build
from . import projections as pb
from .vector import STANDARD, VectorSpace, psum, tree_leaves, tree_map

__all__ = [
    "alloc",
    "capacity",
    "get",
    "set",
    "prefix",
    "buckets_for",
    "bucket_for",
    "project",
    "project_bucketed",
    "unproject",
    "unproject_bucketed",
    "project_batched",
    "unproject_batched",
    "transform",
    "transform_partial",
    "transform_rung",
    "transform_partial_inplace",
    "transform_partial_inplace_reference",
    "transform_partial_inplace_batched",
    "transform_partial_inplace_batched_reference",
    "append_scaled",
    "mask_coeffs",
    "gram",
    "gram_batched",
    "batch_inner",
    "batch_inner_batched",
]

LANES = 128
# widest basis the transform kernel keeps in registers (csrc/transform.cu)
TRANSFORM_MAX_KMAX = 128
# (kreg, float32 cols, bfloat16 cols) rungs of csrc/transform.cu, by kmax <= kreg
TRANSFORM_RUNGS = ((16, 2, 4), (32, 1, 2), (64, 1, 2), (128, 1, 1))

# Toggle for the live-row projection kernels (ops/projections.py).  Off by
# default, as the JAX package's flag of the same name is; PERF.md holds the
# card's times for both settings.  The flag is process-global: it reaches
# every unfused cgs-family sweep (ops/orthonormal.py).
use_pallas_projections = False


def _pallas_basis(V) -> bool:
    """True if the flag is on and ``V`` is a single-tensor basis the
    projection kernels take (``projections.supported_leaf``, contiguous) on
    a CUDA device (the kernels) or on the CPU (their plain versions)."""
    return (
        use_pallas_projections
        and isinstance(V, torch.Tensor)
        and V.device.type in ("cuda", "cpu")
        and pb.supported_leaf(V)
        and V.is_contiguous()
    )


def _pallas_proj_leaf(V, x, space: VectorSpace) -> bool:
    """True if the project kernel applies to ``(V, x)``: an eligible basis
    (:func:`_pallas_basis`, one leaf only, as the JAX package's
    ``_pallas_proj_leaf``), the standard inner product, and ``x`` one tensor,
    a row of ``V`` in shape, dtype and device."""
    if space.inner_fn is not None or not _pallas_basis(V) or not isinstance(x, torch.Tensor):
        return False
    return x.dtype == V.dtype and x.shape == V.shape[1:] and x.device == V.device


def alloc(template, kmax: int, dtype=None):
    """A zeroed basis of capacity ``kmax`` shaped like ``template``."""
    return tree_map(
        lambda l: torch.zeros((kmax,) + tuple(l.shape), dtype=dtype or l.dtype, device=l.device),
        template,
    )


def capacity(V) -> int:
    """``kmax``: the leading size of the basis' leaves."""
    return tree_leaves(V)[0].shape[0]


def get(V, j: int):
    """Basis vector ``V[j]`` (a view of each leaf)."""
    return tree_map(lambda l: l[j], V)


def set(V, j: int, v):
    """``V[j] = v`` in place; returns ``V``."""
    if isinstance(V, torch.Tensor):
        V[j] = v.to(V.dtype)
        return V
    for lV, lv in zip(tree_leaves(V), tree_leaves(v)):
        lV[j] = lv.to(lV.dtype)
    return V


def prefix(V, B: int):
    """The first ``B`` rows of the basis (views)."""
    return tree_map(lambda l: l[:B], V)


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


def _project_leaf(V: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    dt = torch.promote_types(V.dtype, x.dtype)
    return V.reshape(V.shape[0], -1).to(dt).conj() @ x.reshape(-1).to(dt)


def mask_coeffs(c: torch.Tensor, k: int) -> torch.Tensor:
    """``c`` with its entries ``j >= k`` zeroed (a new tensor)."""
    idx = torch.arange(c.shape[0], device=c.device)
    return torch.where(idx < k, c, torch.zeros((), dtype=c.dtype, device=c.device))


def project(V, x, k: int, space: VectorSpace = STANDARD) -> torch.Tensor:
    """``c[j] = <V[j], x>`` for ``j < k``, zero beyond — the ``Vᴴx`` kernel
    (reference ``project!!``, ``src/orthonormal.jl:88-118``); a pytree sums
    its per-leaf contractions.  On a sharded space one all-reduce finishes
    the batch of local partials, on the kernel's route too (the JAX
    package's kernel route returns before its ``psum``)."""
    kb = capacity(V)
    if space.inner_fn is None:
        if _pallas_proj_leaf(V, x, space):
            # the kernel masks j >= k and reads only the first k rows
            return psum(pb.project_pallas(V, x.contiguous(), k), space.psum_axis)
        if isinstance(V, torch.Tensor):
            c = _project_leaf(V, x)
        else:
            parts = [_project_leaf(lV, lx) for lV, lx in zip(tree_leaves(V), tree_leaves(x))]
            c = sum(parts[1:], parts[0])
        c = psum(c, space.psum_axis)
        if space.real_inner:
            c = torch.real(c)
    else:
        c = torch.stack([space.inner(get(V, j), x) for j in range(kb)])
    return mask_coeffs(c, k)


def project_bucketed(V, x, k: int, space: VectorSpace = STANDARD) -> torch.Tensor:
    """:func:`project` over the smallest bucket prefix ``B >= k``, padded
    back to ``kmax`` entries."""
    kmax = capacity(V)
    if space.inner_fn is not None:
        return project(V, x, k, space)
    B = bucket_for(k, kmax)
    return torch.nn.functional.pad(project(prefix(V, B), x, k, space), (0, kmax - B))


def _unproject_leaf(V: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    dt = torch.promote_types(c.dtype, V.dtype)
    return (c.to(dt) @ V.reshape(V.shape[0], -1).to(dt)).reshape(V.shape[1:])


def unproject(V, c: torch.Tensor, k=None):
    """``y = Σ_j c[j] V[j]`` — the ``V c`` kernel (reference ``unproject!!``,
    ``src/orthonormal.jl:132-196``), leaf by leaf.  The caller masks ``c``.

    Given the active length ``k``, a real ``c`` and an eligible basis (see
    :func:`_pallas_basis`), the kernel of ``ops/projections.py`` reads only
    the first ``k`` rows."""
    if k is not None and not torch.is_complex(c) and _pallas_basis(V) and c.device == V.device:
        return pb.unproject_pallas(V, c, k)
    return tree_map(lambda l: _unproject_leaf(l, c), V)


def unproject_bucketed(V, c: torch.Tensor, k: int):
    """``V c`` over the smallest bucket prefix ``B >= k`` (``c`` must be zero
    beyond ``k``)."""
    B = bucket_for(k, capacity(V))
    return unproject(prefix(V, B), c[:B])


def _finished(C: torch.Tensor, space: VectorSpace) -> list:
    """The stacked local partials ``C`` of a batch's problems, finished in
    one all-reduce on a sharded space, as a list of fresh rows (a row of the
    stack need not start where a one-problem result does, and the card's
    products may round otherwise there)."""
    return [c.clone() for c in psum(C, space.psum_axis)]


def _local(space: VectorSpace) -> VectorSpace:
    """``space`` without its mesh axis: a rank's local partials."""
    return dataclasses.replace(space, psum_axis=None)


def project_batched(Vs, xs, ks, space: VectorSpace = STANDARD) -> list:
    """``[project(Vs[i], xs[i], ks[i], space) for i]`` for the problems of a
    batched solve (``Vs`` their bases, ``ks`` host ints).  With the flag on
    and every problem's ``(V, x)`` eligible (:func:`_pallas_proj_leaf`), one
    batched launch of the project kernel
    (``projections.project_pallas_batched``), each row the one-problem
    launch's bits; otherwise each problem's local :func:`project`.  Either
    way, on a sharded space one all-reduce of the ``(P, kmax)``
    coefficients finishes them all (:func:`project` all-reduces its own
    so)."""
    if all(_pallas_proj_leaf(V, x, space) for V, x in zip(Vs, xs)):
        return _finished(pb.project_pallas_batched(Vs, [x.contiguous() for x in xs], ks), space)
    local = _local(space)
    return _finished(torch.stack([project(V, x, k, local) for V, x, k in zip(Vs, xs, ks)]),
                     space)


def unproject_batched(Vs, cs, ks) -> list:
    """``[unproject(Vs[i], cs[i], ks[i]) for i]``: with the flag on, real
    coefficients and every basis eligible (:func:`_pallas_basis`), one
    batched launch of the unproject kernel
    (``projections.unproject_pallas_batched``), each row the one-problem
    launch's bits; otherwise problem by problem."""
    if all(not torch.is_complex(c) and _pallas_basis(V) and c.device == V.device
           for V, c in zip(Vs, cs)):
        return list(pb.unproject_pallas_batched(Vs, cs, ks))
    return [unproject(V, c, k) for V, c, k in zip(Vs, cs, ks)]


def append_scaled(y, V, c: torch.Tensor, alpha=1.0):
    """``y + alpha·(V c)`` leaf by leaf (``V c`` by :func:`unproject`)."""
    return tree_map(lambda ly, lv: ly + alpha * lv, y, unproject(V, c))


def _transform_leaf(V: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    dt = torch.promote_types(U.dtype, V.dtype)
    out = U.to(dt).T @ V.reshape(V.shape[0], -1).to(dt)
    return out.reshape(V.shape).to(V.dtype)


def transform(V, U: torch.Tensor):
    """``V @ U`` as a new basis: row ``m`` is ``Σ_j U[j, m] V[j]`` (reference
    ``basistransform!``, ``src/orthonormal.jl:291-354``), leaf by leaf."""
    return tree_map(lambda l: _transform_leaf(l, U), V)


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
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.kk_transform_partial.argtypes = [p, p, ll, ll, i, ll, i, i, p]
        lib.kk_transform_partial.restype = i
        lib.kk_transform_partial_batched.argtypes = [p, p, ll, ll, ll, i, ll, i, i, i, p, p]
        lib.kk_transform_partial_batched.restype = i
        lib.kk_transform_rung.argtypes = [i, i, ctypes.POINTER(i), ctypes.POINTER(i)]
        lib.kk_transform_rung.restype = None
        _transform_lib = lib
    return _transform_lib


def transform_rung(kmax: int, dtype: torch.dtype = torch.float32):
    """``(kreg, cols)`` of the kernel rung that serves ``kmax`` (the ladder
    of ``csrc/transform.cu``): a thread keeps ``kreg`` values of each of
    ``cols`` consecutive columns in registers, ``kreg * cols <= 128``, and a
    row of ``U`` lies in shared memory padded to ``kreg`` floats.  ``cols``
    is what one 4-byte word holds (8 bytes on the narrowest rung), so a
    bfloat16 basis has twice the columns of a float32 one."""
    if not 1 <= kmax <= TRANSFORM_MAX_KMAX:
        raise ValueError(f"kmax {kmax} outside 1..{TRANSFORM_MAX_KMAX}")
    kreg, cols32, cols16 = next(rung for rung in TRANSFORM_RUNGS if kmax <= rung[0])
    return kreg, cols16 if dtype == torch.bfloat16 else cols32


def transform_partial_inplace(V: torch.Tensor, U: torch.Tensor,
                              m_out: int) -> torch.Tensor:
    """``V[:m_out] ← (Uᵀ V)[:m_out]`` in place; rows ``>= m_out`` stay
    bit-identical.  Port of the TPU kernel
    ``krylovkit_tpu/ops/basis.py:_pallas_transform_inplace``.

    A CUDA tensor runs the kernel of ``csrc/transform.cu`` (float32, or
    bfloat16 with float32 accumulation and ``U`` rounded to bfloat16 as the
    plain version rounds it); a CPU tensor runs
    :func:`transform_partial_inplace_reference`.  ``U`` may be any view: the
    kernel reads ``U[:, :m_out]`` through its strides.  A tensor that
    requires grad or is wrapped by ``torch.func`` is refused
    (``_build.refuse_autograd``)."""
    _build.refuse_autograd("transform_partial", V, U)
    kmax = V.shape[0]
    if not (0 < m_out <= kmax) or U.shape != (kmax, kmax):
        raise ValueError(f"bad shapes: V {tuple(V.shape)}, U {tuple(U.shape)}, m_out {m_out}")
    if torch.is_complex(U):
        raise ValueError("transform_partial_inplace needs a real rotation U")
    if V.device.type == "cpu":
        return transform_partial_inplace_reference(V, U, m_out)
    if V.device.type != "cuda":
        raise ValueError(f"unsupported device {V.device}")
    if V.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the CUDA transform kernel takes float32 or bfloat16, got {V.dtype}")
    if not V.is_contiguous() or not _leaf_ok(V):
        raise ValueError(f"the CUDA transform kernel needs a contiguous (kmax <= "
                         f"{TRANSFORM_MAX_KMAX}, R % 8 == 0, 128) basis, got {tuple(V.shape)}")
    ncols = V[0].numel()
    _, cols = transform_rung(kmax, V.dtype)
    # R % 8 == 0 makes every row start 16-byte aligned, and so every group of
    # `cols` columns a thread loads as one word
    if ncols % 4 != 0 or ncols % cols != 0 or V.data_ptr() % 16 != 0:
        raise ValueError(f"the CUDA transform kernel needs 16-byte aligned rows, got ncols {ncols}")
    if V.dtype == torch.bfloat16:
        U = U.to(device=V.device, dtype=torch.bfloat16)
    if U.device != V.device or U.dtype != torch.float32:
        U = U.to(device=V.device, dtype=torch.float32)
    lib = _lib()
    status = lib.kk_transform_partial(
        V.data_ptr(), U.data_ptr(), U.stride(0), U.stride(1), kmax, ncols, m_out,
        int(V.dtype == torch.bfloat16),
        torch.cuda.current_stream(V.device).cuda_stream,
    )
    _build.check(lib, status, "transform_partial")
    _build.launches["transform_partial"] += 1
    return V


# problems one batched launch takes (csrc/transform.cu kMaxProblems); the
# wrapper launches a longer list in chunks of this many
TRANSFORM_MAX_BATCH = 64


def _batched_args(V, U, m_out: int, active):
    P, kmax = V.shape[0], V.shape[1]
    active = list(range(P)) if active is None else [int(p) for p in active]
    if V.ndim < 2 or U.shape != (P, kmax, kmax) or not 0 < m_out <= kmax:
        raise ValueError(f"bad shapes: V {tuple(V.shape)}, U {tuple(U.shape)}, m_out {m_out}")
    if not active or len({*active}) != len(active) or not all(0 <= p < P for p in active):
        raise ValueError(f"transform_partial_inplace_batched: active problems {active} of {P}")
    if torch.is_complex(U):
        raise ValueError("transform_partial_inplace_batched needs real rotations U")
    return active


def transform_partial_inplace_batched_reference(V: torch.Tensor, U: torch.Tensor, m_out: int,
                                                active=None) -> torch.Tensor:
    """Plain version of the batched rotation:
    :func:`transform_partial_inplace_reference` of ``V[p]`` by ``U[p]`` for
    each active ``p``; the other bases are not touched."""
    for p in _batched_args(V, U, m_out, active):
        transform_partial_inplace_reference(V[p], U[p], m_out)
    return V


def transform_partial_inplace_batched(V: torch.Tensor, U: torch.Tensor, m_out: int,
                                      active=None) -> torch.Tensor:
    """``V[p, :m_out] ← (U[p]ᵀ V[p])[:m_out]`` in place for each ``p`` in
    ``active`` (default: all), one launch for all (``V (P, kmax, R, 128)``,
    ``U (P, kmax, kmax)``, one ``m_out`` for all).  Each problem is rotated
    bit for bit as :func:`transform_partial_inplace` rotates it: rows ``>=
    m_out`` stay bit-identical, and so does a basis whose ``U`` is the
    identity.  The bases of inactive problems are not touched.

    A CUDA tensor runs ``kk_transform_partial_batched`` of
    ``csrc/transform.cu`` (float32 or bfloat16, :data:`TRANSFORM_MAX_BATCH`
    problems a launch); a CPU tensor runs
    :func:`transform_partial_inplace_batched_reference`."""
    _build.refuse_autograd("transform_partial_batched", V, U)
    active = _batched_args(V, U, m_out, active)
    if V.device.type == "cpu":
        return transform_partial_inplace_batched_reference(V, U, m_out, active)
    if V.device.type != "cuda":
        raise ValueError(f"unsupported device {V.device}")
    if V.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the CUDA transform kernel takes float32 or bfloat16, got {V.dtype}")
    if not V.is_contiguous() or not _leaf_ok(V[0]):
        raise ValueError(f"the CUDA transform kernel needs contiguous (P, kmax <= "
                         f"{TRANSFORM_MAX_KMAX}, R % 8 == 0, 128) bases, got {tuple(V.shape)}")
    kmax = V.shape[1]
    ncols = V[0, 0].numel()
    _, cols = transform_rung(kmax, V.dtype)
    if ncols % 4 != 0 or ncols % cols != 0 or V.data_ptr() % 16 != 0:
        raise ValueError(f"the CUDA transform kernel needs 16-byte aligned rows, got ncols {ncols}")
    if V.dtype == torch.bfloat16:
        U = U.to(device=V.device, dtype=torch.bfloat16)
    if U.device != V.device or U.dtype != torch.float32:
        U = U.to(device=V.device, dtype=torch.float32)
    lib = _lib()
    stream = torch.cuda.current_stream(V.device).cuda_stream
    for c0 in range(0, len(active), TRANSFORM_MAX_BATCH):
        part = (ctypes.c_int * len(active[c0:c0 + TRANSFORM_MAX_BATCH]))(
            *active[c0:c0 + TRANSFORM_MAX_BATCH])
        status = lib.kk_transform_partial_batched(
            V.data_ptr(), U.data_ptr(), U.stride(0), U.stride(1), U.stride(2), kmax, ncols,
            m_out, int(V.dtype == torch.bfloat16), len(part), part, stream,
        )
        _build.check(lib, status, "transform_partial_batched")
        _build.launches["transform_partial_batched"] += 1
    return V


def transform_partial(V, U: torch.Tensor, m_out: int):
    """``V[:m_out] ← (V @ U)[:m_out]``, decided leaf by leaf (the JAX
    package's ``transform_partial``).  A ``(kmax, R, 128)`` float32 or
    bfloat16 leaf with ``R % 8 == 0`` under a real ``U`` (the JAX package's
    in-place kernel conditions) runs :func:`transform_partial_inplace` and
    its rows ``>= m_out`` keep their contents; any other leaf gets the full
    product of :func:`transform` (the JAX fallback), whose tail rows are the
    full rotation.  The two agree whenever ``U`` is the identity on the tail
    — the gated-off restart; otherwise the tail is dead by masking."""
    real = not torch.is_complex(U)

    def leaf(l):
        if real and _leaf_ok(l):
            return transform_partial_inplace(l, U, m_out)
        return _transform_leaf(l, U)

    return tree_map(leaf, V)


def _gram_leaf(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    dt = torch.promote_types(X.dtype, Y.dtype)
    return X.reshape(X.shape[0], -1).to(dt).conj() @ Y.reshape(Y.shape[0], -1).to(dt).T


def gram(X, Y, space: VectorSpace = STANDARD) -> torch.Tensor:
    """``G[i, j] = <X[i], Y[j]>`` between two stacked bases (per-leaf GEMMs,
    summed; all-reduced on a sharded space)."""
    if space.inner_fn is not None:
        nx, ny = capacity(X), capacity(Y)
        return torch.stack([torch.stack([space.inner(get(X, i), get(Y, j)) for j in range(ny)])
                            for i in range(nx)])
    parts = [_gram_leaf(a, b) for a, b in zip(tree_leaves(X), tree_leaves(Y))]
    g = psum(sum(parts[1:], parts[0]), space.psum_axis)
    return torch.real(g) if space.real_inner else g


def batch_inner(X, Y, space: VectorSpace = STANDARD) -> torch.Tensor:
    """``c[i] = <X[i], Y[i]>`` row-wise between two stacked bases."""
    if space.inner_fn is not None:
        return torch.stack([space.inner(get(X, i), get(Y, i)) for i in range(capacity(X))])

    def part(a, b):
        dt = torch.promote_types(a.dtype, b.dtype)
        return (a.reshape(a.shape[0], -1).to(dt).conj() * b.reshape(b.shape[0], -1).to(dt)).sum(1)

    parts = [part(a, b) for a, b in zip(tree_leaves(X), tree_leaves(Y))]
    c = psum(sum(parts[1:], parts[0]), space.psum_axis)
    return torch.real(c) if space.real_inner else c


def gram_batched(Xs, Ys, space: VectorSpace = STANDARD) -> list:
    """``[gram(Xs[i], Ys[i], space) for i]``: each problem's local Gram
    product, stacked, and on a sharded space one all-reduce for all."""
    local = _local(space)
    return _finished(torch.stack([gram(X, Y, local) for X, Y in zip(Xs, Ys)]), space)


def batch_inner_batched(Xs, Ys, space: VectorSpace = STANDARD) -> list:
    """``[batch_inner(Xs[i], Ys[i], space) for i]``: each problem's local
    row-wise products, stacked, and on a sharded space one all-reduce for
    all."""
    local = _local(space)
    return _finished(torch.stack([batch_inner(X, Y, local) for X, Y in zip(Xs, Ys)]), space)
