"""Offset-decomposed ("generalized banded") sparse operator — the counterpart
of ``krylovkit_tpu/ops/pallas_spmv.py``, named for what it holds rather than
for the TPU kernel language:

    A = Σ_δ diag(d_δ) · S_δ          (S_δ x)[i] = x[i + δ]

with one dense diagonal plane ``d_δ`` per distinct column offset; the column
indices disappear into static metadata (``offsets``).

:func:`banded_spmv` is the wrapper of the hand-written CUDA kernel
``csrc/banded_spmv.cu`` (the port of the TPU kernel
``krylovkit_tpu/ops/pallas_spmv.py:_spmv_pallas``); its plain version
:func:`banded_spmv_reference` (the semantics of the JAX package's
``_spmv_xla``) sits beside it and serves CPU tensors.  The JAX package's
size-based choice between its kernel and XLA (``_prefer_pallas``, tuned to a
TPU's VMEM) and its tile-fit limit on the band are not ported: the CUDA
kernel reads ``x`` from global memory and takes any offset in ``(-n, n)``,
any ``n``, float32 or float64.  Complex planes or vectors are outside the
TPU kernel, and :class:`BandedOperator` applies them with the plain version
on every device, as the JAX package sends them to XLA.

:func:`banded_spmv_batched` is the product for the rows of a stack of ``P``
vectors in one launch (``kk_banded_spmv_batched``, the TPU kernel under
``jax.vmap``), with one plane set shared by every row or one per row, each
row bit-identical to a :func:`banded_spmv` launch on it; its plain version
:func:`banded_spmv_batched_reference` is the one-vector plain version's
arithmetic on the stack.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from .. import _build
from .operator import LinearOperator, _shift_flat, resolve_device

__all__ = [
    "BandedOperator",
    "banded_from_coo",
    "banded_from_dense",
    "banded_spmv",
    "banded_spmv_batched",
    "banded_spmv_batched_reference",
    "banded_spmv_reference",
    "ell_to_banded",
]

LANES = 128
# offsets the kernel takes (csrc/banded_spmv.cu kMaxOffsets), the default
# ``max_offsets`` of banded_from_coo
MAX_OFFSETS = 128
# rows one batched launch takes (csrc/banded_spmv.cu kMaxRows)
MAX_ROWS = 64


def banded_spmv_reference(x: torch.Tensor, diags: torch.Tensor, offsets, n: int) -> torch.Tensor:
    """Plain version of the banded SpMV: ``y[i] = Σ_p diags[p][i]·x[i + δ_p]``
    on the flattening of ``x``, zero outside ``[0, n)``, terms added in
    offset order; ``y`` has ``x``'s shape."""
    xf = x.reshape(n)
    planes = diags.reshape(len(offsets), -1)
    y = torch.zeros(n, dtype=torch.promote_types(diags.dtype, x.dtype), device=x.device)
    for p, d in enumerate(offsets):
        y = y + planes[p, :n] * _shift_flat(xf, d)
    return y.reshape(x.shape)


def _plane_sets(diags: torch.Tensor, nd: int, planes):
    """``diags`` as ``(sets, nd, L)``: one shared set (``planes`` None) or
    the leading axis of a per-row stack."""
    if planes is None:
        return diags.reshape(1, nd, -1)
    return diags.reshape(diags.shape[0], nd, -1)


def banded_spmv_batched_reference(X: torch.Tensor, diags: torch.Tensor, offsets, n: int,
                                  planes=None) -> torch.Tensor:
    """Plain version of the batched SpMV: :func:`banded_spmv_reference`'s
    operations on every row of ``X`` at once, so each row is bit-identical
    to it.  ``planes`` as in :func:`banded_spmv_batched`."""
    rows = X.shape[0]
    Xf = X.reshape(rows, n)
    D = _plane_sets(diags, len(offsets), planes)
    D = D[:, :, :n] if planes is None else D[torch.as_tensor(planes, device=D.device), :, :n]
    Y = torch.zeros((rows, n), dtype=torch.promote_types(diags.dtype, X.dtype), device=X.device)
    for p, d in enumerate(offsets):
        Y = Y + D[:, p] * _shift_flat(Xf, d)
    return Y.reshape(X.shape)


_spmv_lib = None


def _lib():
    global _spmv_lib
    if _spmv_lib is None:
        lib = _build.library("banded_spmv")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.kk_banded_spmv.argtypes = [p, p, p, ll, ll, i, p, i, p]
        lib.kk_banded_spmv.restype = i
        lib.kk_banded_spmv_batched.argtypes = [p, p, p, ll, ll, ll, ll, ll, i, p, i, p, i, p]
        lib.kk_banded_spmv_batched.restype = i
        _spmv_lib = lib
    return _spmv_lib


def banded_spmv(x: torch.Tensor, diags: torch.Tensor, offsets: Tuple[int, ...],
                n: int) -> torch.Tensor:
    """``y[i] = Σ_p diags[p][i]·x[i + δ_p]`` with ``x`` read as zero outside
    ``[0, n)``; ``y`` has ``x``'s shape.  ``diags`` holds one plane of at least
    ``n`` entries per offset (``(nδ, R, 128)`` in :class:`BandedOperator`).

    A CUDA tensor runs the kernel of ``csrc/banded_spmv.cu`` (``x`` and
    ``diags`` both float32 or both float64); a CPU tensor runs
    :func:`banded_spmv_reference`, and a ``meta`` one (a dtype probe) gets an
    empty ``meta`` result of the promoted type, whatever device ``diags``
    lies on.  A tensor
    that requires grad or is wrapped by ``torch.func`` is refused
    (``_build.refuse_autograd``): :class:`BandedOperator` differentiates its
    planes through the plain version (``with_tensors(..., plain=True)``)."""
    _build.refuse_autograd("banded_spmv", x, diags)
    offsets = tuple(int(d) for d in offsets)
    if x.numel() != n:
        raise ValueError(f"vector of {x.numel()} entries for an n={n} banded operator")
    if x.device.type == "meta":
        return torch.empty(x.shape, dtype=torch.promote_types(diags.dtype, x.dtype), device="meta")
    if x.device.type == "cpu":
        return banded_spmv_reference(x, diags, offsets, n)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if torch.is_complex(x) or torch.is_complex(diags):
        raise ValueError("the CUDA banded SpMV takes real float32/float64 planes; "
                         "BandedOperator applies complex ones with banded_spmv_reference")
    if x.dtype not in (torch.float32, torch.float64) or diags.dtype != x.dtype:
        raise ValueError(f"the CUDA banded SpMV needs x and diags both float32 or both "
                         f"float64, got {x.dtype} and {diags.dtype}")
    nd = len(offsets)
    ld = math.prod(diags.shape[1:])
    vec = 16 // x.element_size()
    if (diags.device != x.device or diags.shape[0] != nd or not diags.is_contiguous()
            or ld < n or ld % vec or diags.data_ptr() % 16 or nd > MAX_OFFSETS):
        raise ValueError(
            f"the CUDA banded SpMV needs contiguous, 16-byte aligned planes on {x.device}, "
            f"one per offset (at most {MAX_OFFSETS}), each of at least n entries and a "
            f"multiple of {vec}; got {tuple(diags.shape)} for {nd} offsets, n={n}"
        )
    xf = x.reshape(n)
    if not xf.is_contiguous() or xf.data_ptr() % 16:
        xf = xf.clone(memory_format=torch.contiguous_format)
    y = torch.empty(n, dtype=x.dtype, device=x.device)
    # the launch copies the offsets into its kernel argument
    offs = np.asarray(offsets, np.int32)
    lib = _lib()
    status = lib.kk_banded_spmv(
        xf.data_ptr(), diags.data_ptr(), y.data_ptr(), n, ld, nd,
        offs.ctypes.data, int(x.dtype == torch.float64),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, status, "banded_spmv")
    _build.launches["banded_spmv"] += 1
    return y.reshape(x.shape)


def banded_spmv_batched(X: torch.Tensor, diags: torch.Tensor, offsets: Tuple[int, ...],
                        n: int, planes=None) -> torch.Tensor:
    """:func:`banded_spmv` of each row of the stack ``X`` (``(rows, ...)``,
    ``n`` entries a row); the result has ``X``'s shape.  ``planes`` None:
    ``diags`` is one plane set (as :func:`banded_spmv` takes it) shared by
    every row.  Else ``diags`` stacks plane sets along a leading axis
    (``(sets, nδ, R, 128)``) and row ``r`` takes set ``planes[r]``.

    A CUDA tensor runs ``kk_banded_spmv_batched`` of ``csrc/banded_spmv.cu``
    (real float32 or float64, :data:`MAX_ROWS` rows a launch), each row
    bit-identical to a :func:`banded_spmv` launch on it; a CPU tensor runs
    :func:`banded_spmv_batched_reference`, a ``meta`` one gets an empty
    result.  Refuses what :func:`banded_spmv` refuses."""
    _build.refuse_autograd("banded_spmv_batched", X, diags)
    offsets = tuple(int(d) for d in offsets)
    rows, nd = X.shape[0], len(offsets)
    if X.numel() != rows * n:
        raise ValueError(f"rows of {X.numel() // max(rows, 1)} entries for an n={n} banded "
                         "operator")
    if planes is not None and len(planes) != rows:
        raise ValueError(f"{len(planes)} plane sets named for {rows} rows")
    if X.device.type == "meta":
        return torch.empty(X.shape, dtype=torch.promote_types(diags.dtype, X.dtype), device="meta")
    if X.device.type == "cpu":
        return banded_spmv_batched_reference(X, diags, offsets, n, planes)
    if X.device.type != "cuda":
        raise ValueError(f"unsupported device {X.device}")
    if torch.is_complex(X) or torch.is_complex(diags):
        raise ValueError("the CUDA banded SpMV takes real float32/float64 planes; "
                         "BandedOperator applies complex ones with banded_spmv_reference")
    if X.dtype not in (torch.float32, torch.float64) or diags.dtype != X.dtype:
        raise ValueError(f"the CUDA banded SpMV needs X and diags both float32 or both "
                         f"float64, got {X.dtype} and {diags.dtype}")
    D = _plane_sets(diags, nd, planes)
    ld = D.shape[2]
    vec = 16 // X.element_size()
    if (diags.device != X.device or not diags.is_contiguous() or ld < n or ld % vec
            or diags.data_ptr() % 16 or nd > MAX_OFFSETS
            or (planes is not None and not all(0 <= s < D.shape[0] for s in planes))):
        raise ValueError(
            f"the CUDA banded SpMV needs contiguous, 16-byte aligned planes on {X.device}, "
            f"one per offset (at most {MAX_OFFSETS}), each of at least n entries and a "
            f"multiple of {vec}; got {tuple(diags.shape)} for {nd} offsets, n={n}"
        )
    Xf = X.reshape(rows, n)
    if Xf.stride(1) != 1:
        Xf = Xf.contiguous()
    ldy = -(-n // vec) * vec
    Y = torch.empty((rows, ldy), dtype=X.dtype, device=X.device)
    offs = np.asarray(offsets, np.int32)
    ldp = 0 if planes is None else nd * ld
    lib = _lib()
    stream = torch.cuda.current_stream(X.device).cuda_stream
    for r0 in range(0, rows, MAX_ROWS):
        r1 = min(rows, r0 + MAX_ROWS)
        sets = None if planes is None else np.asarray(planes[r0:r1], np.int32)
        status = lib.kk_banded_spmv_batched(
            Xf[r0].data_ptr(), diags.data_ptr(), Y[r0].data_ptr(), n, Xf.stride(0), ldy, ld,
            ldp, r1 - r0, None if sets is None else sets.ctypes.data, nd, offs.ctypes.data,
            int(X.dtype == torch.float64), stream,
        )
        _build.check(lib, status, "banded_spmv_batched")
        _build.launches["banded_spmv_batched"] += 1
    return Y[:, :n].reshape(X.shape)


@dataclasses.dataclass(frozen=True)
class BandedOperator(LinearOperator):
    """Square sparse operator in offset-decomposed form.

    ``diags`` has shape ``(nδ, R, 128)`` with ``R = ceil(n/128)`` and
    ``diags[p]`` flattened over rows: ``diags[p][i] = A[i, i + offsets[p]]``
    (zero where absent or out of range).  ``adj`` is ``Aᴴ`` as a second
    banded operator (or ``None``).  ``nnz`` counts the nonzero plane entries,
    once, at construction (or is given).  ``plain`` applies the plain
    version on every device: the differentiable form that
    :meth:`with_tensors` builds for a gradient of the planes."""

    offsets: Tuple[int, ...] = ()
    diags: torch.Tensor = None
    n: int = 0
    adj: Optional["BandedOperator"] = None
    nnz: int = 0
    plain: bool = False

    def __init__(self, offsets, diags: torch.Tensor, n: int, adj=None, nnz=None,
                 plain: bool = False):
        offsets = tuple(int(d) for d in offsets)
        if diags.shape[0] != len(offsets) or math.prod(diags.shape[1:]) < n:
            raise ValueError(
                f"diags {tuple(diags.shape)} must hold one plane of >= n={n} entries "
                f"per offset ({len(offsets)})"
            )
        object.__setattr__(self, "offsets", offsets)
        object.__setattr__(self, "diags", diags)
        object.__setattr__(self, "n", int(n))
        object.__setattr__(self, "adj", adj)
        object.__setattr__(self, "nnz", int(torch.count_nonzero(diags)) if nnz is None else nnz)
        object.__setattr__(self, "plain", bool(plain))
        object.__setattr__(self, "normal", self._matvec)
        object.__setattr__(self, "adjoint", adj._matvec if adj is not None else None)

    @property
    def shape(self):
        return (self.n, self.n)

    def tensors(self) -> tuple:
        """The planes, then the adjoint's planes (the JAX package's pytree
        leaves)."""
        return (self.diags,) + ((self.adj.diags,) if self.adj is not None else ())

    def with_tensors(self, tensors, plain: bool = False) -> "BandedOperator":
        adj = None
        if self.adj is not None:
            adj = BandedOperator(self.adj.offsets, tensors[1], self.n, nnz=self.adj.nnz,
                                 plain=plain)
        return BandedOperator(self.offsets, tensors[0], self.n, adj=adj, nnz=self.nnz,
                              plain=plain)

    def _matvec(self, x: torch.Tensor) -> torch.Tensor:
        # mixed precisions compute in the wider type, as the plain version does
        dt = torch.promote_types(self.diags.dtype, x.dtype)
        if x.device.type == "meta":
            # a dtype probe: no planes are read, wherever they lie
            return torch.empty(x.shape, dtype=dt, device="meta")
        if dt.is_complex or self.plain:
            # the TPU kernel takes no complex planes: the JAX package applies
            # them by XLA's shift-and-add (``_pallas_ok`` is false), whose
            # semantics the plain version has
            if x.numel() != self.n:
                raise ValueError(f"vector of {x.numel()} entries for an n={self.n} banded operator")
            return banded_spmv_reference(x.to(dt), self.diags.to(dt), self.offsets, self.n)
        return banded_spmv(x.to(dt), self.diags.to(dt), self.offsets, self.n)


def _plan(rows, cols, vals, n):
    """COO → (offsets, planes (nδ, n)) with duplicate entries summed."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals)
    deltas = cols - rows
    offs = np.unique(deltas)
    p = np.searchsorted(offs, deltas)
    planes = np.zeros((len(offs), n), vals.dtype)
    np.add.at(planes, (p, rows), vals)
    return tuple(int(d) for d in offs), planes


def banded_from_coo(rows, cols, vals, n: int, max_offsets: Optional[int] = MAX_OFFSETS,
                    with_adjoint: bool = True, device="cuda") -> BandedOperator:
    """A :class:`BandedOperator` on ``device`` from COO triplets of a square
    ``n×n`` matrix; the planes keep ``vals``' dtype.  With ``with_adjoint``
    the adjoint is the banded operator of the transposed, conjugated COO.

    Raises ``ValueError`` if the matrix has more than ``max_offsets``
    distinct column offsets (it is then not banded-like)."""
    dev = resolve_device(device)
    offs, planes = _plan(rows, cols, vals, n)
    if max_offsets is not None and len(offs) > max_offsets:
        raise ValueError(
            f"{len(offs)} distinct offsets exceed max_offsets={max_offsets}; "
            "matrix is not banded-like — use ELLOperator instead"
        )
    R = -(-n // LANES)
    planes3 = np.pad(planes, ((0, 0), (0, R * LANES - n))).reshape(len(offs), R, LANES)
    adj = None
    if with_adjoint:
        adj = banded_from_coo(
            np.asarray(cols), np.asarray(rows), np.conj(np.asarray(vals)), n,
            max_offsets=None, with_adjoint=False, device=dev,
        )
    return BandedOperator(offs, torch.as_tensor(planes3, device=dev), n, adj=adj)


def banded_from_dense(A, tol: float = 0.0, **kw) -> BandedOperator:
    """A :class:`BandedOperator` of the entries of the square matrix ``A``
    with ``|a| > tol`` (keywords go to :func:`banded_from_coo`)."""
    A = np.asarray(A)
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise ValueError("BandedOperator requires a square matrix")
    rows, cols = np.nonzero(np.abs(A) > tol)
    return banded_from_coo(rows, cols, A[rows, cols], A.shape[0], **kw)


def ell_to_banded(op, max_offsets: Optional[int] = MAX_OFFSETS) -> BandedOperator:
    """The :class:`BandedOperator` of a square ELL operator
    (``ops/sparse.py``), on the ELL operator's device; its stored zeros are
    dropped.  Raises ``ValueError`` for a rectangular operator or one with
    more than ``max_offsets`` distinct column offsets."""
    n_rows, n_cols = op.shape
    if n_rows != n_cols:
        raise ValueError("offset decomposition requires a square matrix")
    cols = op.cols.cpu().numpy()
    vals = op.vals.cpu().numpy()
    rows = np.broadcast_to(np.arange(n_rows)[:, None], cols.shape)
    mask = vals != 0
    return banded_from_coo(rows[mask], cols[mask], vals[mask], n_rows,
                           max_offsets=max_offsets, device=op.cols.device)
