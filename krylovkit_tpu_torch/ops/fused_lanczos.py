"""Fused Krylov expansion step for stencil operators — one basis stream
(counterpart of ``krylovkit_tpu/ops/pallas_fused_lanczos.py``).

One step, at live rows ``B = k + 1`` and new row ``kp1 = k + 1``:

  1. ``w' = γ·y − Σ_{j<B} g_j·V[j]``   (subtract)
  2. ``V[kp1] = w'`` in place          (append)
  3. ``y' = A w'``                     (stencil)
  4. ``raw = [<V_j, y'> (B) | <V_j, w'> (B, with_drift) | <w', y'> | ‖w'‖²]``

:func:`fused_step` is the wrapper of the hand-written CUDA kernel
``csrc/fused_lanczos.cu``; :func:`fused_step_reference` is its plain
PyTorch version, run for CPU tensors.  Unlike the TPU kernel, neither takes
halo caches: the CUDA kernel reads halo rows of ``V`` and ``y`` directly, so
the driver carries no boundary planes.  ``y`` and ``y'`` are separate
buffers.  Stored basis rows are raw residuals; their scales are carried by
the driver (``factorizations/krylov.py:FusedScales``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import _build

LANES = 128

__all__ = [
    "StencilSpec",
    "MAX_HALO",
    "spec_for",
    "adjoint_spec",
    "supported_stencil",
    "choose_tile",
    "stencil_apply_spec",
    "fused_step",
    "fused_step_reference",
]


class StencilSpec(NamedTuple):
    """Static description of a fusable stencil.

    ``taps[p] = (qrow, r, dx)``: tap ``p`` reads layout row ``+qrow`` (``+1``
    for the lanes that wrap when ``r != 0``) after a lane shift by ``r``, i.e.
    flat offset ``qrow·128 + r``; ``dx`` is the grid-column offset of the
    per-lane validity mask (grid specs only).  ``h`` is the halo depth in
    layout rows, ``mrow = gc // 128`` layout rows per grid row."""

    coeffs: Tuple[float, ...]
    taps: Tuple[Tuple[int, int, int], ...]
    h: int
    mrow: int
    gc: int  # grid columns; 0 = flat chain (no lane masking)
    gr: int = 0  # grid rows (0 for chains)


# halo rows per side the kernel will carry (csrc/fused_lanczos.cu kMaxHalo)
MAX_HALO = 32
# taps the kernel takes (csrc/fused_lanczos.cu kMaxTaps)
MAX_TAPS = 16


def _chain_spec(offsets, coeffs) -> Optional[StencilSpec]:
    taps = []
    h = 1
    for d in offsets:
        q, r = divmod(int(d), LANES)
        taps.append((q, r, 0))
        h = max(h, -q, q + (1 if r else 0))
    if h > MAX_HALO or len(taps) > MAX_TAPS:
        return None
    return StencilSpec(tuple(float(c) for c in coeffs), tuple(taps), h, 0, 0)


def _grid_spec(grid, offsets2, coeffs) -> Optional[StencilSpec]:
    gr, gc = grid
    if gc % LANES != 0:
        return None
    mrow = gc // LANES
    taps = []
    h = 1
    for dy, dx in offsets2:
        if not (-LANES < dx < LANES):
            return None
        q, r = divmod(int(dx), LANES)
        qrow = dy * mrow + q
        taps.append((qrow, r, int(dx)))
        h = max(h, -qrow, qrow + (1 if r else 0))
    if h > MAX_HALO or len(taps) > MAX_TAPS:
        return None
    return StencilSpec(tuple(float(c) for c in coeffs), tuple(taps), h, mrow, gc, gr)


def spec_for(op) -> Optional[StencilSpec]:
    """The fused-kernel spec of a real-coefficient
    :class:`~.operator.StencilOperator` or :class:`~.operator.GridStencilOperator`
    that fits the kernel's halo window, else ``None``."""
    from .operator import GridStencilOperator, StencilOperator

    if isinstance(op, (GridStencilOperator, StencilOperator)):
        if any(isinstance(c, complex) for c in op.coeffs):
            return None
    if isinstance(op, GridStencilOperator):
        return _grid_spec(op.grid, op.offsets2, op.coeffs)
    if isinstance(op, StencilOperator):
        return _chain_spec(op.offsets, op.coeffs)
    return None


def supported_stencil(offsets) -> bool:
    """Can a flat chain with these offsets fuse?"""
    return _chain_spec(offsets, (0.0,) * len(offsets)) is not None


def adjoint_spec(op) -> Optional[StencilSpec]:
    """Spec of ``Aᴴ`` for a fusable stencil operator (the reversed stencil)."""
    from .operator import GridStencilOperator, StencilOperator

    if isinstance(op, (GridStencilOperator, StencilOperator)):
        if any(isinstance(c, complex) for c in op.coeffs):
            return None
    if isinstance(op, GridStencilOperator):
        adj_off = tuple((-dy, -dx) for dy, dx in reversed(op.offsets2))
        return _grid_spec(op.grid, adj_off, tuple(reversed(op.coeffs)))
    if isinstance(op, StencilOperator):
        adj_off = tuple(-d for d in reversed(op.offsets))
        return _chain_spec(adj_off, tuple(reversed(op.coeffs)))
    return None


def choose_tile(R: int, tile_rows: int = 256, h: int = 1) -> int:
    """The JAX kernel's row tile for ``R`` rows and halo ``h``.  The port
    keeps it only as the eligibility rule of ``fused_available``, so both
    packages fuse the same problems."""
    T = tile_rows
    while T > 8 and (R % T != 0 or R // T < 2):
        T //= 2
    if R % T != 0 or R // T < 2:
        raise ValueError(f"R={R} rows do not tile (need R % T == 0, >= 2 tiles)")
    if T < h:
        raise ValueError(f"tile rows T={T} < halo depth h={h}")
    return T


def _flat_offset(tap) -> int:
    qrow, r, _ = tap
    return qrow * LANES + r


def stencil_apply_spec(x: torch.Tensor, spec: StencilSpec) -> torch.Tensor:
    """Plain apply of a spec to an ``(R, 128)`` vector in float32: each tap
    reads the row-major flattening at its flat offset, zero outside
    ``[0, n)``; grid taps with ``dx != 0`` also zero the lanes whose grid
    column ``ix + dx`` leaves ``[0, gc)``."""
    R, C = x.shape
    n = R * C
    xf = x.reshape(n).to(torch.float32)
    acc = torch.zeros(n, dtype=torch.float32, device=x.device)
    if spec.gc:
        ix = torch.arange(n, device=x.device) % spec.gc
    for coef, tap in zip(spec.coeffs, spec.taps):
        d = _flat_offset(tap)
        sh = torch.zeros_like(xf)
        if d >= 0:
            sh[: n - d] = xf[d:]
        else:
            sh[-d:] = xf[: n + d]
        dx = tap[2]
        if spec.gc and dx:
            valid = (ix + dx < spec.gc) if dx > 0 else (ix >= -dx)
            sh = torch.where(valid, sh, torch.zeros((), dtype=sh.dtype, device=sh.device))
        acc = acc + coef * sh
    return acc.reshape(R, C)


def _raw_len(B: int, with_drift: bool) -> int:
    return (2 * B if with_drift else B) + 2


def _check(V, y, g, kp1, B, with_drift):
    kmax, R, C = V.shape
    if C != LANES or y.shape != (R, C) or g.shape != (kmax + 1,):
        raise ValueError(
            f"fused_step shapes: V {tuple(V.shape)}, y {tuple(y.shape)}, g {tuple(g.shape)}"
        )
    if not (1 <= B <= kmax and 0 <= kp1 < kmax):
        raise ValueError(f"fused_step needs 1 <= B <= kmax, 0 <= kp1 < kmax; got B={B}, kp1={kp1}")
    if _raw_len(B, with_drift) > LANES:
        raise ValueError(
            f"fused_step packs {_raw_len(B, with_drift)} reductions; the "
            f"limit is {LANES} (fused_available gates this)"
        )


def fused_step_reference(V, y, g, kp1: int, B: int, spec: StencilSpec,
                         with_drift: bool = False):
    """Plain version of the fused step.  Returns ``(y_next, raw)``; writes
    ``V[kp1] = w'`` in place after the reductions (so ``raw`` never sees the
    new row, even for ``kp1 < B``) and leaves every other row untouched."""
    _check(V, y, g, kp1, B, with_drift)
    kmax = V.shape[0]
    VB = V[:B].reshape(B, -1)
    W = g[kmax] * y - (g[:B] @ VB).reshape(y.shape)
    yn = stencil_apply_spec(W, spec)
    wf, ynf = W.reshape(-1), yn.reshape(-1)
    parts = [VB @ ynf]
    if with_drift:
        parts.append(VB @ wf)
    parts += [torch.dot(wf, ynf)[None], torch.dot(wf, wf)[None]]
    V[kp1] = W
    return yn, torch.cat(parts)


_fused_lib = None
_taps_cache: dict = {}


def _lib():
    global _fused_lib
    if _fused_lib is None:
        lib = _build.library("fused_lanczos")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.kk_fused_step.argtypes = [p, p, p, p, p, p] + [i] * 9 + [p, p, p, p]
        lib.kk_fused_step.restype = i
        lib.kk_fused_step_blocks.argtypes = [i]
        lib.kk_fused_step_blocks.restype = i
        _fused_lib = lib
    return _fused_lib


def _host_taps(spec: StencilSpec):
    """Host arrays (coef, flat offset, dx) of a spec, kept alive per spec."""
    taps = _taps_cache.get(spec)
    if taps is None:
        taps = (
            np.asarray(spec.coeffs, np.float32),
            np.asarray([_flat_offset(t) for t in spec.taps], np.int32),
            np.asarray([t[2] for t in spec.taps], np.int32),
        )
        _taps_cache[spec] = taps
    return taps


def fused_step(V, y, g, kp1: int, B: int, spec: StencilSpec,
               with_drift: bool = False):
    """One fused expansion step.  Returns ``(y_next, raw)`` and writes
    ``V[kp1] = w'`` in place; every other row of ``V`` stays bit-identical.
    ``raw`` is ``[r(B) | d(B) | rp | q]`` with ``with_drift``, else
    ``[r(B) | rp | q]``.  Needs ``B <= kp1``: the new row is never read.

    A CUDA tensor runs the kernel of ``csrc/fused_lanczos.cu`` (float32,
    contiguous); a CPU tensor runs :func:`fused_step_reference`."""
    if V.device.type == "cpu":
        return fused_step_reference(V, y, g, kp1, B, spec, with_drift)
    if V.device.type != "cuda":
        raise ValueError(f"unsupported device {V.device}")
    _check(V, y, g, kp1, B, with_drift)
    if kp1 < B:
        raise ValueError(f"the CUDA fused step needs kp1 >= B (got B={B}, kp1={kp1})")
    for name, t in (("V", V), ("y", y), ("g", g)):
        if t.device != V.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"fused_step needs {name} as contiguous float32 on {V.device}")
    kmax, R, _ = V.shape
    lib = _lib()
    nslots = _raw_len(B, with_drift)
    ynext = torch.empty_like(y)
    raw = torch.empty(nslots, dtype=torch.float32, device=V.device)
    partials = torch.empty(
        lib.kk_fused_step_blocks(R) * nslots, dtype=torch.float32, device=V.device
    )
    coef, offs, dxs = _host_taps(spec)
    status = lib.kk_fused_step(
        V.data_ptr(), y.data_ptr(), ynext.data_ptr(), g.data_ptr(),
        partials.data_ptr(), raw.data_ptr(), kmax, R, B, kp1, int(with_drift),
        spec.h, spec.gc, spec.mrow, len(spec.taps),
        coef.ctypes.data, offs.ctypes.data, dxs.ctypes.data,
        torch.cuda.current_stream(V.device).cuda_stream,
    )
    _build.check(lib, status, "fused_step")
    _build.launches["fused_step"] += 1
    return ynext, raw
