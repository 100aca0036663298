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
halo caches: each block of the CUDA kernel stages the halo rows of ``V`` and
``y`` itself, so the solver loop carries no boundary planes.  A vector split
over ranks (``parallel/``) gives both the rows beyond its shard instead:
``Vext (kmax, 2, h, 128)`` for every basis row and ``yext (2, h, 128)``
(side 0 the ``h`` rows above row 0, side 1 those below row ``R - 1``, zero
at the ends of the chain), where the unsplit vector has zeros.  ``y`` and
``y'`` are separate buffers.  Stored basis rows are raw residuals; their
scales are carried by the driver (``factorizations/krylov.py:FusedScales``).

:func:`fused_step_batched` is the step of ``P`` problems at once (the TPU
kernel under ``jax.vmap``): ``V (P, kmax, R, 128)``, ``y (P, R, 128)``,
``g (P, kmax + 1)``, a ``B`` and a ``kp1`` per problem, and the list of the
problems that step; one launch of ``kk_fused_step_batched`` runs them all.
On a split vector each problem passes its own external halos, ``Vext (P,
kmax, 2, h, 128)`` and ``yext (P, 2, h, 128)``.  Its plain version
:func:`fused_step_batched_reference` loops :func:`fused_step_reference` over
them.
"""

from __future__ import annotations

import ctypes
import functools
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
    "StepPlan",
    "plan_step",
    "fused_step",
    "fused_step_reference",
    "fused_step_batched",
    "fused_step_batched_reference",
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


def stencil_apply_spec(x: torch.Tensor, spec: StencilSpec,
                       halo: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain apply of a spec to an ``(R, 128)`` vector in float32: each tap
    reads the row-major flattening at its flat offset, zero outside
    ``[0, n)`` (or, given ``halo (2, h, 128)``, the rows above and below
    there); grid taps with ``dx != 0`` also zero the lanes whose grid
    column ``ix + dx`` leaves ``[0, gc)``."""
    R, C = x.shape
    n = R * C
    xf = x.reshape(n).to(torch.float32)
    acc = torch.zeros(n, dtype=torch.float32, device=x.device)
    if halo is not None:
        hn = halo.shape[1] * C
        strip = torch.cat([halo[0].reshape(-1).to(torch.float32), xf,
                           halo[1].reshape(-1).to(torch.float32)])
    if spec.gc:
        ix = torch.arange(n, device=x.device) % spec.gc
    for coef, tap in zip(spec.coeffs, spec.taps):
        d = _flat_offset(tap)
        if halo is not None:
            sh = strip[hn + d: hn + d + n]
        else:
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


def _check(V, y, g, kp1, B, with_drift, spec=None, Vext=None, yext=None):
    kmax, R, C = V.shape
    if C != LANES or y.shape != (R, C) or g.shape != (kmax + 1,):
        raise ValueError(
            f"fused_step shapes: V {tuple(V.shape)}, y {tuple(y.shape)}, g {tuple(g.shape)}"
        )
    if (Vext is None) != (yext is None):
        raise ValueError("fused_step takes both external halos (Vext, yext) or neither")
    if Vext is not None and (Vext.shape != (kmax, 2, spec.h, C)
                             or yext.shape != (2, spec.h, C)):
        raise ValueError(
            f"fused_step halos: Vext {tuple(Vext.shape)}, yext {tuple(yext.shape)}; "
            f"want ({kmax}, 2, {spec.h}, {C}) and (2, {spec.h}, {C})"
        )
    if not (0 <= B <= kmax and 0 <= kp1 < kmax):
        raise ValueError(f"fused_step needs 0 <= B <= kmax, 0 <= kp1 < kmax; got B={B}, kp1={kp1}")
    if _raw_len(B, with_drift) > LANES:
        raise ValueError(
            f"fused_step packs {_raw_len(B, with_drift)} reductions; the "
            f"limit is {LANES} (fused_available gates this)"
        )


def fused_step_reference(V, y, g, kp1: int, B: int, spec: StencilSpec,
                         with_drift: bool = False, Vext=None, yext=None):
    """Plain version of the fused step.  Returns ``(y_next, raw)``; writes
    ``V[kp1] = w'`` in place after the reductions (so ``raw`` never sees the
    new row, even for ``kp1 < B``) and leaves every other row untouched.
    With no live row (``B = 0``) ``w' = γ·y`` and ``raw = [rp | q]``.  Given
    the external halos, ``w'`` of the rows beyond the shard is the same
    combination of ``yext`` and ``Vext[:B]``, and the stencil reads it there;
    the reductions cover the shard's own rows."""
    _check(V, y, g, kp1, B, with_drift, spec, Vext, yext)
    kmax = V.shape[0]
    VB = V[:B].reshape(B, y.numel())
    W = g[kmax] * y - (g[:B] @ VB).reshape(y.shape)
    halo = None
    if Vext is not None:
        halo = g[kmax] * yext - (g[:B] @ Vext[:B].reshape(B, yext.numel())).reshape(yext.shape)
    yn = stencil_apply_spec(W, spec, halo)
    wf, ynf = W.reshape(-1), yn.reshape(-1)
    parts = [VB @ ynf]
    if with_drift:
        parts.append(VB @ wf)
    parts += [torch.dot(wf, ynf)[None], torch.dot(wf, wf)[None]]
    V[kp1] = W
    return yn, torch.cat(parts)


# Shared-memory planning of the CUDA kernel (csrc/fused_lanczos.cu)
SMEM_LIMIT = 232448         # dynamic shared memory one block may take on an H100
SMEM_LIMIT_TWO = 115712     # ... where two blocks share an SM
STEP_THREADS = 256
TILE_ROWS = (8, 4, 2, 1)    # T: rows a tile may have; a thread owns max(1, T/2) lanes
TILE_CAP = 80 * 1024        # a tile of more than one row stays under this
PAIR_TILE_ROWS = 4          # the tile of the two-blocks-per-SM plan
PAIR_MAX_B = 32             # ... which needs the 32-slot kernels (<= 128 registers)
MAX_IN_FLIGHT = 2           # tiles of copies in flight: more measured no faster


class StepPlan(NamedTuple):
    """Sizes of one launch of the fused-step kernel.

    A block walks ``run`` layout rows plus ``h`` halo rows on either side in
    tiles of ``T`` rows, with ``P`` tiles of copies in flight.  The ring of
    staged rows (``y`` and ``V[:B]`` of a row, ``(B + 1)·512`` bytes) has
    ``NSR`` rows, the ring of ``w'`` rows ``NR``.  With ``reread`` a staged
    row is released before its reductions, which then read ``V`` from global
    memory; otherwise it stays for the ``h`` rows the reductions lag."""

    T: int
    P: int
    NSR: int
    NR: int
    reread: bool
    run: int
    nblocks: int
    smem_bytes: int


def _step_smem(B: int, NSR: int, NR: int) -> int:
    # staged rows, w' ring, g (128 floats), warp sums (8 warps x 128 slots),
    # the last-block flag (16 bytes)
    return 4 * (NSR * (B + 1) * LANES + NR * LANES + LANES + (STEP_THREADS // 32) * LANES + 4)


@functools.lru_cache(maxsize=4096)
def plan_step(R: int, B: int, h: int, with_drift: bool, sms: int) -> StepPlan:
    """Plan the kernel for ``R`` layout rows, ``B`` live basis rows, halo
    ``h`` on a card with ``sms`` multiprocessors.

    The time of a tile is mostly the latency of its two passes, so the plan
    first tries what hides it: two blocks on every SM, each with tiles of
    ``PAIR_TILE_ROWS`` rows, where both fit the SM's shared memory
    (``B <= 22`` at ``h = 1``).  Else one block per SM with the tallest tile
    that fits with the ``h``-row lag; ``reread`` only where none does.  The
    runs have at least ``max(8, 4h)`` rows and cover ``[0, R)`` once."""
    if not (R >= 1 and 1 <= h <= MAX_HALO and B >= 0 and _raw_len(B, with_drift) <= LANES):
        raise ValueError(f"plan_step: R={R}, B={B}, h={h}, with_drift={with_drift}")
    row = (B + 1) * 4 * LANES
    # (tile rows, rows of lag kept staged, shared-memory limit, blocks per SM)
    candidates = [(PAIR_TILE_ROWS, h, SMEM_LIMIT_TWO, 2)] if B <= PAIR_MAX_B else []
    candidates += [(T, lag, SMEM_LIMIT, 1) for lag in (h, 0) for T in TILE_ROWS
                   if T == 1 or (T * row <= TILE_CAP and (T == 2 or B <= 32))]
    for T, lag, limit, per_sm in candidates:
        P = next((P for P in range(MAX_IN_FLIGHT, 0, -1)
                  if _step_smem(B, (P + 1) * T + lag, T + 2 * h) <= limit), 0)
        if P:
            break
    else:
        raise ValueError(f"plan_step: no tile fits shared memory at B={B}, h={h}")
    NSR, NR = (P + 1) * T + lag, T + 2 * h
    nblocks = max(1, min(sms * per_sm, R // max(8, 4 * h)))
    run = -(-R // nblocks)
    nblocks = -(-R // run)
    return StepPlan(T, P, NSR, NR, lag == 0, run, nblocks, _step_smem(B, NSR, NR))


_fused_lib = None
_taps_cache: dict = {}
_scratch: dict = {}
_batch_scratch: dict = {}
# problems one batched launch takes (csrc/fused_lanczos.cu kMaxProblems); the
# wrapper launches a longer list in chunks of this many
MAX_BATCH = 64


def _lib():
    global _fused_lib
    if _fused_lib is None:
        lib = _build.library("fused_lanczos")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.kk_fused_step.argtypes = [p] * 9 + [i] * 9 + [p, p, p] + [i] * 8 + [p]
        lib.kk_fused_step.restype = i
        lib.kk_fused_step_batched.argtypes = (
            [p] * 9 + [i] * 3 + [p] * 3 + [i] * 7 + [p] * 3 + [i] * 8 + [p])
        lib.kk_fused_step_batched.restype = i
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


def _device_scratch(device: torch.device):
    """Per device: the multiprocessor count, the per-block partials and the
    arrival counter of the kernel's last-block reduction (zeroed once; every
    launch leaves it zero).  One stream at a time may use them."""
    entry = _scratch.get(device)
    if entry is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        entry = (
            sms,
            torch.empty(2 * sms * LANES, dtype=torch.float32, device=device),
            torch.zeros(1, dtype=torch.int32, device=device),
        )
        _scratch[device] = entry
    return entry


def fused_step(V, y, g, kp1: int, B: int, spec: StencilSpec,
               with_drift: bool = False, Vext=None, yext=None):
    """One fused expansion step.  Returns ``(y_next, raw)`` and writes
    ``V[kp1] = w'`` in place; every other row of ``V`` stays bit-identical.
    ``raw`` is ``[r(B) | d(B) | rp | q]`` with ``with_drift``, else
    ``[r(B) | rp | q]``.  Needs ``B <= kp1``: the new row is never read.
    ``B = 0`` (no live row: the first domain half-step of a fused GKL solve)
    stages ``y`` alone and gives ``w' = γ·y``, ``raw = [rp | q]``.  A shard
    of a split vector passes its external halos ``Vext``/``yext`` (module
    docstring); ``raw`` then holds this shard's partial sums.

    A CUDA tensor runs the kernel of ``csrc/fused_lanczos.cu`` (float32,
    contiguous) with the sizes of :func:`plan_step`; its scratch is kept per
    device, so calls for one device go to one stream at a time.  A CPU
    tensor runs :func:`fused_step_reference`.  A tensor that requires grad or
    is wrapped by ``torch.func`` is refused (``_build.refuse_autograd``)."""
    _build.refuse_autograd("fused_step", V, y, g, Vext, yext)
    if V.device.type == "cpu":
        return fused_step_reference(V, y, g, kp1, B, spec, with_drift, Vext, yext)
    if V.device.type != "cuda":
        raise ValueError(f"unsupported device {V.device}")
    _check(V, y, g, kp1, B, with_drift, spec, Vext, yext)
    if kp1 < B:
        raise ValueError(f"the CUDA fused step needs kp1 >= B (got B={B}, kp1={kp1})")
    named = [("V", V), ("y", y), ("g", g)]
    if Vext is not None:
        named += [("Vext", Vext), ("yext", yext)]
    for name, t in named:
        if t.device != V.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"fused_step needs {name} as contiguous float32 on {V.device}")
    if any(t.data_ptr() % 16 for _, t in named if t is not g):
        raise ValueError("fused_step needs V, y and the halos on 16-byte boundaries")
    kmax, R, _ = V.shape
    lib = _lib()
    sms, partials, counter = _device_scratch(V.device)
    plan = plan_step(R, B, spec.h, bool(with_drift), sms)
    ynext = torch.empty_like(y)
    raw = torch.empty(_raw_len(B, with_drift), dtype=torch.float32, device=V.device)
    coef, offs, dxs = _host_taps(spec)
    status = lib.kk_fused_step(
        V.data_ptr(), y.data_ptr(), ynext.data_ptr(), g.data_ptr(),
        partials.data_ptr(), raw.data_ptr(), counter.data_ptr(),
        Vext.data_ptr() if Vext is not None else None,
        yext.data_ptr() if yext is not None else None,
        kmax, R, B, kp1, int(with_drift),
        spec.h, spec.gc, spec.mrow, len(spec.taps),
        coef.ctypes.data, offs.ctypes.data, dxs.ctypes.data,
        plan.T, plan.P, plan.NSR, plan.NR, int(plan.reread), plan.run,
        plan.nblocks, plan.smem_bytes,
        torch.cuda.current_stream(V.device).cuda_stream,
    )
    _build.check(lib, status, "fused_step")
    _build.launches["fused_step"] += 1
    return ynext, raw


def _batch_args(V, y, g, kp1, B, active):
    """Problem count, per-problem ``kp1``/``B`` lists and the active list
    of a batched step; ints broadcast over the problems."""
    P = V.shape[0]
    kp1 = [int(kp1)] * P if isinstance(kp1, int) else [int(v) for v in kp1]
    B = [int(B)] * P if isinstance(B, int) else [int(v) for v in B]
    active = list(range(P)) if active is None else [int(p) for p in active]
    if (V.ndim != 4 or y.shape != (P,) + tuple(V.shape[2:]) or g.shape != (P, V.shape[1] + 1)
            or len(kp1) != P or len(B) != P):
        raise ValueError(
            f"fused_step_batched shapes: V {tuple(V.shape)}, y {tuple(y.shape)}, "
            f"g {tuple(g.shape)}, {len(kp1)} kp1 and {len(B)} B for {P} problems"
        )
    if not active or len(set(active)) != len(active) or not all(0 <= p < P for p in active):
        raise ValueError(f"fused_step_batched: active problems {active} of {P}")
    return P, kp1, B, active


def _batch_halos(V, spec, Vext, yext):
    """Check a batched step's external halos: both or neither, ``Vext (P,
    kmax, 2, h, 128)`` and ``yext (P, 2, h, 128)``."""
    if (Vext is None) != (yext is None):
        raise ValueError("fused_step_batched takes both external halos (Vext, yext) or neither")
    if Vext is None:
        return
    P, kmax = V.shape[0], V.shape[1]
    want_V, want_y = (P, kmax, 2, spec.h, LANES), (P, 2, spec.h, LANES)
    if tuple(Vext.shape) != want_V or tuple(yext.shape) != want_y:
        raise ValueError(f"fused_step_batched halos: Vext {tuple(Vext.shape)}, yext "
                         f"{tuple(yext.shape)}; want {want_V} and {want_y}")


def fused_step_batched_reference(V, y, g, kp1, B, spec: StencilSpec,
                                 with_drift: bool = False, active=None, ynext=None,
                                 Vext=None, yext=None):
    """Plain version of the batched step: :func:`fused_step_reference` on
    each active problem ``p`` (``V[p]``, ``y[p]``, ``g[p]``, ``kp1[p]``,
    ``B[p]``, and given the halos ``Vext[p]``, ``yext[p]``).  Returns
    ``(y_next (P, R, 128), raw (P, width))`` with ``width`` the longest
    ``raw`` of the active problems; a problem's row is zero beyond its own
    ``raw`` and every row of an inactive problem is zero (of ``y_next`` too,
    unless ``ynext`` is given: then the active rows are written into it and
    the others keep theirs), and its basis is not touched."""
    P, kp1, B, active = _batch_args(V, y, g, kp1, B, active)
    _batch_halos(V, spec, Vext, yext)
    width = max(_raw_len(B[p], with_drift) for p in active)
    ynext = torch.zeros_like(y) if ynext is None else ynext
    raw = torch.zeros((P, width), dtype=torch.float32, device=V.device)
    for p in active:
        halos = {} if Vext is None else {"Vext": Vext[p], "yext": yext[p]}
        yn, r = fused_step_reference(V[p], y[p], g[p], kp1[p], B[p], spec, with_drift, **halos)
        ynext[p] = yn
        raw[p, :r.numel()] = r
    return ynext, raw


def _batch_scratch_for(device: torch.device, floats: int):
    """Per device: partials of a batched launch (grown to ``floats``) and
    :data:`MAX_BATCH` arrival counters (zeroed once; every launch leaves
    them zero).  One stream at a time may use them."""
    entry = _batch_scratch.get(device)
    if entry is None or entry[0].numel() < floats:
        counters = (entry[1] if entry is not None
                    else torch.zeros(MAX_BATCH, dtype=torch.int32, device=device))
        entry = (torch.empty(floats, dtype=torch.float32, device=device), counters)
        _batch_scratch[device] = entry
    return entry


def fused_step_batched(V, y, g, kp1, B, spec: StencilSpec, with_drift: bool = False,
                       active=None, ynext=None, Vext=None, yext=None):
    """The fused step of the problems in ``active`` (default: all) in one
    launch.  ``V (P, kmax, R, 128)``, ``y (P, R, 128)``, ``g (P, kmax + 1)``;
    ``kp1`` and ``B`` are an int each per problem (or one int for all).
    Writes ``V[p, kp1[p]] = w'_p`` in place for each active ``p`` and
    returns ``(y_next (P, R, 128), raw (P, width))``: problem ``p``'s
    entries are :func:`fused_step`'s at ``(kp1[p], B[p])``, ``raw`` padded
    with zeros to the longest of the active problems; the entries of an
    inactive problem are undefined and its rows of ``V`` are not touched.

    A CUDA tensor runs ``kk_fused_step_batched`` of
    ``csrc/fused_lanczos.cu`` with the plan of the largest ``B`` (where all
    ``B`` are equal, each problem's results are a one-problem launch's, bit
    for bit), :data:`MAX_BATCH` problems a launch; a CPU tensor runs
    :func:`fused_step_batched_reference`.  A shard of split vectors passes
    every problem's external halos, ``Vext (P, kmax, 2, h, 128)`` and
    ``yext (P, 2, h, 128)`` (both or neither): problem ``p`` then gets
    :func:`fused_step`'s results with ``Vext[p]``/``yext[p]``, bit for bit
    where all ``B`` are equal, and its ``raw`` holds this shard's partial
    sums.  ``ynext``, where given, is the ``(P, R, 128)`` buffer the active
    rows of ``y_next`` are written into (its other rows keep theirs), so
    launches over disjoint sets of problems can fill one buffer."""
    _build.refuse_autograd("fused_step_batched", V, y, g, Vext, yext)
    if V.device.type == "cpu":
        return fused_step_batched_reference(V, y, g, kp1, B, spec, with_drift, active, ynext,
                                            Vext, yext)
    if V.device.type != "cuda":
        raise ValueError(f"unsupported device {V.device}")
    P, kp1, B, active = _batch_args(V, y, g, kp1, B, active)
    _batch_halos(V, spec, Vext, yext)
    kmax, R = V.shape[1], V.shape[2]
    for p in active:
        _check(V[p], y[p], g[p], kp1[p], B[p], with_drift, spec)
        if kp1[p] < B[p]:
            raise ValueError(f"the CUDA fused step needs kp1 >= B (problem {p}: "
                             f"B={B[p]}, kp1={kp1[p]})")
    named = [("V", V), ("y", y), ("g", g)]
    if Vext is not None:
        named += [("Vext", Vext), ("yext", yext)]
    for name, t in named:
        if t.device != V.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"fused_step_batched needs {name} as contiguous float32 on {V.device}")
    if any(t.data_ptr() % 16 for name, t in named if name != "g"):
        raise ValueError("fused_step_batched needs V, y and the halos on 16-byte boundaries")
    Bmax = max(B[p] for p in active)
    width = max(_raw_len(B[p], with_drift) for p in active)
    lib = _lib()
    sms = _device_scratch(V.device)[0]
    plan = plan_step(R, Bmax, spec.h, bool(with_drift), sms)
    chunk = min(len(active), MAX_BATCH)
    partials, counters = _batch_scratch_for(V.device, chunk * plan.nblocks * width)
    if ynext is None:
        ynext = torch.empty_like(y)
    elif (ynext.shape != y.shape or ynext.dtype != torch.float32 or ynext.device != V.device
          or not ynext.is_contiguous() or ynext.data_ptr() % 16):
        raise ValueError("fused_step_batched needs ynext like y: contiguous float32, 16-byte "
                         "aligned")
    raw = torch.empty((P, width), dtype=torch.float32, device=V.device)
    coef, offs, dxs = _host_taps(spec)
    stream = torch.cuda.current_stream(V.device).cuda_stream
    for c0 in range(0, len(active), MAX_BATCH):
        part = active[c0:c0 + MAX_BATCH]
        ps = np.asarray(part, np.int32)
        Bs = np.asarray([B[p] for p in part], np.int32)
        ks = np.asarray([kp1[p] for p in part], np.int32)
        status = lib.kk_fused_step_batched(
            V.data_ptr(), y.data_ptr(), ynext.data_ptr(), g.data_ptr(),
            partials.data_ptr(), raw.data_ptr(), counters.data_ptr(),
            Vext.data_ptr() if Vext is not None else None,
            yext.data_ptr() if yext is not None else None, kmax, R, len(part),
            ps.ctypes.data, Bs.ctypes.data, ks.ctypes.data, Bmax, width, int(with_drift),
            spec.h, spec.gc, spec.mrow, len(spec.taps),
            coef.ctypes.data, offs.ctypes.data, dxs.ctypes.data,
            plan.T, plan.P, plan.NSR, plan.NR, int(plan.reread), plan.run,
            plan.nblocks, plan.smem_bytes, stream,
        )
        _build.check(lib, status, "fused_step_batched")
        _build.launches["fused_step_batched"] += 1
    return ynext, raw
