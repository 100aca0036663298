#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``krylovkit_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, each printing one JSON line; any failure raises and exits non-zero
without the final ``ok`` line:

1. device  — torch and CUDA versions, the card's name and power limit
   (``nvidia-smi``), the TF32 flags (must be off);
2. build   — compiles every kernel of ``krylovkit_tpu_torch/csrc`` with
   ``nvcc`` (one process per source, in parallel);
3. kernels — each kernel against its plain PyTorch version on the card at
   the shapes of the paths below, with its tolerance or bit-identity
   contract, its time (CUDA events), the plain version's time, a yardstick
   PyTorch call where one computes the same function, and its bound on the
   card;
4. small   — the port's eigsolve on a small Laplacian, on the card against
   the same solve on the CPU (plain versions);
5. main    — the port's Lanczos eigsolve at the bench configuration
   (``laplacian_1d(2**21)``, 4 eigenpairs "LM", krylovdim 30, maxiter 10,
   f32 ``(n/128, 128)`` vectors, default cgs2): launch counts of one solve,
   then 3 timed solves and the nnz/s metric of ``bench.py``;
6. small_linsolve — each linear solver on small banded Poisson systems in
   float64 (and fused GMRES in float32), on the card against the same solve
   on the CPU;
7. config2 — the linear solvers at the config-2 size (``poisson_2d(1024,
   1024)``, f32 ``(8192, 128)`` vectors; ``benchmarks/run_all.py``'s three
   solves, two of them again on the same matrix as a ``BandedOperator``, and
   BiCGStab on ``laplacian_1d_pallas(2**21)``): per solve, launch counts of
   one solve, then 3 timed solves, one JSON line each;
8. profile (only with ``--profile``) — one more main-path solve under
   ``torch.profiler``: device busy time and idle share, device ops, host
   reads of device scalars, device time by kernel name.

Each path (phases 5 and 7, one solve at a time) is driven with the launch
counts set to 0 just before it and read just after.  Then the kernel
summary line, the ``nvidia-smi`` name/power line, and as the last line
``{"ok": true, "device": {...}}``.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, float32 and float64
# (non-tensor-core) rates
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
F64_FLOP_PER_S = 34e12
SLEEP_CYCLES = 20_000_000  # busy-wait queued ahead of timed launches


def emit(obj):
    print(json.dumps(obj), flush=True)


def require(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def device_ms(torch, fn, reps=10, batches=3):
    """Median per-launch device time of ``fn`` over ``batches`` runs of
    ``reps`` launches.  A busy-wait kernel is queued first so the host
    enqueues the launches before the card reaches them: the events then
    time the kernels, not the host's launch overhead."""
    times = []
    for _ in range(batches):
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def cold_device_ms(torch, fn, flush):
    """Per-launch device time of ``fn`` with the 50 MB L2 cache flushed
    before each launch (``flush`` is a 128 MB buffer written in between),
    less the flush's own time.  Back-to-back launches of a kernel whose
    working set fits L2 find their inputs there; this finds them in HBM."""
    return device_ms(torch, lambda: (flush.zero_(), fn())) - device_ms(torch, flush.zero_)


def bound(nbytes, flops, flop_rate=F32_FLOP_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_flops(n, B, ntaps, with_drift):
    # subtract (B FMAs + 2), stencil (ntaps FMAs), reductions (B or 2B FMAs + 2)
    return n * (2 * B + 2 + 2 * ntaps + (4 * B if with_drift else 2 * B) + 4)


def check_fused_step(torch, fl, op, R, kmax, B, kp1, with_drift, gen):
    """K1 against its plain version on the card; returns the case record."""
    dev = "cuda"
    spec = fl.spec_for(op)
    V = torch.randn((kmax, R, 128), generator=gen, device=dev)
    y = torch.randn((R, 128), generator=gen, device=dev)
    g = torch.randn(kmax + 1, generator=gen, device=dev)
    Vk = V.clone()
    yk, rawk = fl.fused_step(Vk, y, g, kp1, B, spec, with_drift)
    Vr = V.clone()
    yr, rawr = fl.fused_step_reference(Vr, y, g, kp1, B, spec, with_drift)
    torch.cuda.synchronize()
    others = torch.equal(Vk[:kp1], V[:kp1]) and torch.equal(Vk[kp1 + 1:], V[kp1 + 1:])
    require(others, f"fused_step B={B}: rows other than kp1 bit-identical")
    sc = float(torch.max(torch.abs(yr)))
    err_w = float(torch.max(torch.abs(Vk[kp1] - Vr[kp1])))
    err_y = float(torch.max(torch.abs(yk - yr)))
    # each reduction against the product of the norms it contracts
    nV = torch.linalg.vector_norm(V[:B].reshape(B, -1), dim=1)
    nw, ny = torch.linalg.vector_norm(Vr[kp1]), torch.linalg.vector_norm(yr)
    scales = [nV * ny] + ([nV * nw] if with_drift else []) + [(nw * ny)[None], (nw * nw)[None]]
    rel_raw = float(torch.max(torch.abs(rawk - rawr) / torch.cat(scales)))
    # one dropped layout row (128 products) moves a slot by ~sqrt(128)/n of its
    # norm product, 5e-6 at n = 2^21; float32 summation gives ~1e-7
    tol, tol_raw = 2e-4, 1e-6
    require(err_w <= tol * sc and err_y <= tol * sc, f"fused_step B={B}: w', y' within {tol}*scale")
    require(rel_raw <= tol_raw, f"fused_step B={B}: raw within {tol_raw} of the norm products")
    n = R * 128
    t_bound, by = bound((B + 3) * n * 4, k1_flops(n, B, len(spec.taps), with_drift))
    case = {
        "op": "grid" if spec.gc else "chain", "n": n, "kmax": kmax, "B": B, "kp1": kp1,
        "h": spec.h, "with_drift": with_drift,
        "max_abs_err": max(err_w, err_y), "scale": sc, "raw_rel_err": rel_raw,
        "tolerance": f"{tol}*scale (w', y'); {tol_raw}*norm products (raw)",
        "rows_other_than_kp1_bit_identical": others,
        "ms": device_ms(torch, lambda: fl.fused_step(Vk, y, g, kp1, B, spec, with_drift)),
        "plain_ms": device_ms(
            torch, lambda: fl.fused_step_reference(Vr, y, g, kp1, B, spec, with_drift), reps=3
        ),
        "bound_ms": t_bound, "bound_by": by,
    }
    return case


def check_transform(torch, bs, kmax, R, m_out, gen):
    """K2 against its plain version on the card; returns the case record."""
    V = torch.randn((kmax, R, 128), generator=gen, device="cuda")
    U = torch.randn((kmax, kmax), generator=gen, device="cuda") / kmax ** 0.5
    Vk = bs.transform_partial_inplace(V.clone(), U, m_out)
    Vr = bs.transform_partial_inplace_reference(V.clone(), U, m_out)
    torch.cuda.synchronize()
    tail = torch.equal(Vk[m_out:], V[m_out:])
    require(tail, f"transform m_out={m_out}: rows >= m_out bit-identical")
    ident = torch.equal(bs.transform_partial_inplace(V.clone(), torch.eye(kmax, device="cuda"), m_out), V)
    require(ident, f"transform m_out={m_out}: identity rotation bit-identical")
    sc = float(torch.max(torch.abs(Vr[:m_out])))
    err = float(torch.max(torch.abs(Vk[:m_out] - Vr[:m_out])))
    tol = 1e-5
    require(err <= tol * sc, f"transform m_out={m_out}: rows < m_out within {tol}*scale")
    n = R * 128
    t_bound, by = bound((kmax + m_out) * n * 4, 2 * kmax * m_out * n)
    Vf = V.reshape(kmax, -1)
    return {
        "kmax": kmax, "n": n, "m_out": m_out, "max_abs_err": err, "scale": sc,
        "tolerance": f"{tol}*scale", "tail_bit_identical": tail,
        "identity_bit_identical": ident,
        "ms": device_ms(torch, lambda: bs.transform_partial_inplace(Vk, U, m_out)),
        "plain_ms": device_ms(torch, lambda: bs.transform_partial_inplace_reference(Vr, U, m_out)),
        "library_ms": device_ms(torch, lambda: torch.matmul(U[:, :m_out].T, Vf)),
        "bound_ms": t_bound, "bound_by": by,
    }


def poisson_coo(np, nx, dtype):
    """COO triplets of the 5-point Poisson matrix on an ``nx × nx`` grid,
    offsets (-nx, -1, 0, 1, nx), no ±1 couplings across grid rows:
    ``nnz = 5n − 4·nx``."""
    i = np.arange(nx * nx)
    iy, ix = i // nx, i % nx
    rows, cols, vals = [i], [i], [np.full(i.size, 4.0, dtype)]
    for mask, d in ((iy > 0, -nx), (ix > 0, -1), (ix < nx - 1, 1), (iy < nx - 1, nx)):
        rows.append(i[mask])
        cols.append(i[mask] + d)
        vals.append(np.full(int(mask.sum()), -1.0, dtype))
    return tuple(np.concatenate(a) for a in (rows, cols, vals))


def banded_csr(torch, D, offsets, n):
    """The banded matrix as a ``torch.sparse_csr_tensor`` of its nonzero
    entries: the cuSPARSE yardstick, never called by the port."""
    i = torch.arange(n, device=D.device)
    cols = i[:, None] + torch.tensor(offsets, device=D.device)[None, :]
    vals = D.reshape(len(offsets), -1)[:, :n].T
    keep = (cols >= 0) & (cols < n) & (vals != 0)
    crow = torch.zeros(n + 1, dtype=torch.int64, device=D.device)
    crow[1:] = torch.cumsum(keep.sum(1), 0)
    return torch.sparse_csr_tensor(crow, cols[keep], vals[keep], (n, n))


def check_banded(torch, bd, label, x, D, offsets, n, flush):
    """K3 against its plain version on the card; returns the case record.
    The error is measured against ``Σ_p |d_p[i]|·|x[i+δ_p]|``: float32 FMAs
    against separate products and sums, both in offset order."""
    y = bd.banded_spmv(x, D, offsets, n)
    yr = bd.banded_spmv_reference(x, D, offsets, n)
    scale = bd.banded_spmv_reference(x.abs(), D.abs(), offsets, n).clamp_min(torch.finfo(x.dtype).tiny)
    torch.cuda.synchronize()
    rel = float(((y - yr).abs() / scale).max())
    tol = 1e-6 if x.dtype == torch.float32 else 1e-15
    require(rel <= tol, f"banded_spmv {label}: within {tol}*sum|d||x|")
    A = banded_csr(torch, D, offsets, n)
    xf = x.reshape(n)
    lib_rel = float(((torch.mv(A, xf).reshape(yr.shape) - yr).abs() / scale).max())
    require(lib_rel <= 10 * tol, f"banded_spmv {label}: the cuSPARSE yardstick computes the same product")
    nd, itemsize = len(offsets), x.element_size()
    rate = F32_FLOP_PER_S if x.dtype == torch.float32 else F64_FLOP_PER_S
    t_bound, by = bound((nd + 2) * n * itemsize, 2 * nd * n, rate)
    return {
        "case": label, "n": n, "offsets": len(offsets), "dtype": str(x.dtype),
        "max_abs_err": float((y - yr).abs().max()), "max_rel_err": rel,
        "tolerance": f"{tol}*sum_p|d_p||x|", "library_rel_err": lib_rel,
        "ms": device_ms(torch, lambda: bd.banded_spmv(x, D, offsets, n)),
        "cold_ms": cold_device_ms(torch, lambda: bd.banded_spmv(x, D, offsets, n), flush),
        "plain_ms": device_ms(torch, lambda: bd.banded_spmv_reference(x, D, offsets, n), reps=3),
        "library_ms": device_ms(torch, lambda: torch.mv(A, xf)),
        "library": "torch.mv(sparse_csr_tensor, x) (cuSPARSE)",
        "bound_ms": t_bound, "bound_by": by,
    }


def check_laplacian(torch, s1, n, dtype, gen, flush):
    """K4 against its plain version on the card (the same operations in the
    same order); returns the case record."""
    x = torch.randn((n // 128, 128), generator=gen, device="cuda", dtype=dtype)
    y = s1.laplacian_1d_flat(x)
    yr = s1.laplacian_1d_flat_reference(x)
    w = torch.tensor([-1.0, 2.0, -1.0], dtype=dtype, device="cuda").view(1, 1, 3)

    def conv():
        return torch.nn.functional.conv1d(x.view(1, 1, n), w, padding=1)

    torch.cuda.synchronize()
    require(tuple(y.shape) == (n,), "laplacian_1d: flat (n,) result")
    sc = float(yr.abs().max())
    err = float((y - yr).abs().max())
    tol = 1e-6 if dtype == torch.float32 else 1e-15
    require(err <= tol * sc, f"laplacian_1d {dtype}: within {tol}*scale")
    lib_err = float((conv().view(n) - yr).abs().max())
    require(lib_err <= 4 * tol * sc, f"laplacian_1d {dtype}: the conv1d yardstick computes the same map")
    rate = F32_FLOP_PER_S if dtype == torch.float32 else F64_FLOP_PER_S
    t_bound, by = bound(2 * n * x.element_size(), 3 * n, rate)
    return {
        "n": n, "dtype": str(dtype), "max_abs_err": err, "scale": sc,
        "tolerance": f"{tol}*scale", "bit_equal": bool(torch.equal(y, yr)),
        "ms": device_ms(torch, lambda: s1.laplacian_1d_flat(x)),
        "cold_ms": cold_device_ms(torch, lambda: s1.laplacian_1d_flat(x), flush),
        "plain_ms": device_ms(torch, lambda: s1.laplacian_1d_flat_reference(x), reps=3),
        "library_ms": device_ms(torch, conv), "library": "torch.nn.functional.conv1d (cuDNN, TF32 off)",
        "bound_ms": t_bound, "bound_by": by,
    }


def drive_solve(torch, kt, _build, fl, op, b, a0, alg, reps=3, **kw):
    """One ``kt.linsolve`` with the launch counts set to 0 just before it
    and read just after (the B of each fused step is recorded too), then
    ``reps`` timed solves.  Returns ``(x, info, launches, Bs, first_ms,
    ms_per_solve)``."""
    Bs = []
    fused_step = fl.fused_step

    def recording(V, y, g, kp1, B, spec, with_drift=False):
        Bs.append((B, with_drift))
        return fused_step(V, y, g, kp1, B, spec, with_drift)

    fl.fused_step = recording
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, info = kt.linsolve(op, b, a0=a0, alg=alg, **kw)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(_build.launches)
    fl.fused_step = fused_step
    t0 = time.perf_counter()
    for _ in range(reps):
        x, info = kt.linsolve(op, b, a0=a0, alg=alg, **kw)
    torch.cuda.synchronize()
    return x, info, launches, Bs, first_ms, (time.perf_counter() - t0) / reps * 1e3


def profile_solve(torch, kt, op, x0, alg):
    """One main-path solve under ``torch.profiler`` (after the timed ones)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        kt.eigsolve_lanczos(op, x0, 4, "LM", alg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, launches, syncs = {}, 0, 0
    for evt in prof.events():
        dev_us = getattr(evt, "device_time", None)
        if dev_us is None:
            dev_us = getattr(evt, "cuda_time", 0.0)
        if str(getattr(evt, "device_type", "")).endswith("CUDA"):
            launches += 1
            kernels[evt.name] = kernels.get(evt.name, 0.0) + dev_us / 1e3
        elif evt.name == "aten::_local_scalar_dense":
            syncs += 1
    busy_ms = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    return {
        "phase": "profile", "wall_ms_profiled": wall_ms,
        "device_busy_ms": busy_ms if launches else "not measured",
        "device_idle_share": (1 - busy_ms / wall_ms) if launches else "not measured",
        "device_ops": launches, "host_scalar_reads": syncs,
        "device_ms_by_kernel": {name[:80]: ms for name, ms in top},
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one main-path solve (phase 8)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    import krylovkit_tpu_torch as kt
    from krylovkit_tpu_torch import _build
    from krylovkit_tpu_torch.ops import banded as bd
    from krylovkit_tpu_torch.ops import basis as bs
    from krylovkit_tpu_torch.ops import fused_lanczos as fl
    from krylovkit_tpu_torch.ops import stencil_1d as s1

    # 1. device
    smi = nvidia_smi_line()
    print(smi, flush=True)
    tf32 = {
        "matmul": torch.backends.cuda.matmul.allow_tf32,
        "cudnn": torch.backends.cudnn.allow_tf32,
    }
    emit({"phase": "device", "torch": torch.__version__, "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0), "nvidia_smi": smi, "tf32": tf32})
    require(not any(tf32.values()), "TF32 is off")

    # 2. build
    secs = _build.build()
    report = {}
    for name in _build.SOURCES:
        log = (_build.BUILD_DIR / f"{name}.log")
        lines = log.read_text().splitlines() if log.exists() else []
        report[name] = [ln.strip() for ln in lines if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": secs, "ptxas": report})

    # 3. kernels at the shapes of the paths below
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    n, kmax = 1 << 21, 31
    R = n // 128
    chain = kt.laplacian_1d(n)
    k1_cases = [check_fused_step(torch, fl, chain, R, kmax, B, B, True, gen) for B in (4, 16, 30)]
    k1_cases.append(check_fused_step(torch, fl, chain, R, kmax, 16, 16, False, gen))
    grid = kt.poisson_2d(1024, 1024)
    k1_cases.append(check_fused_step(torch, fl, grid, (1024 * 1024) // 128, kmax, 16, 16, True, gen))
    k2_cases = [check_transform(torch, bs, kmax, R, m, gen) for m in (20, 4)]
    # K3: the config-2 matrix as a banded operator (built from numpy COO),
    # halfband 8 at n = 2^21, float64, and a ragged n
    nx = 1024
    n2 = nx * nx
    coo = poisson_coo(np, nx, np.float32)
    banded = kt.banded_from_coo(*coo, n2)
    require(banded.offsets == (-nx, -1, 0, 1, nx) and banded.nnz == 5 * n2 - 4 * nx,
            f"banded Poisson: offsets {banded.offsets}, nnz {banded.nnz}")
    half8 = tuple(range(-8, 9))
    xb = torch.randn((n2 // 128, 128), generator=gen, device="cuda")
    xh8 = torch.randn(n, generator=gen, device="cuda")
    D8 = torch.randn((len(half8), R, 128), generator=gen, device="cuda")
    D300 = torch.randn((3, 3, 128), generator=gen, device="cuda")
    x300 = torch.randn(300, generator=gen, device="cuda")
    flush = torch.empty(32 << 20, device="cuda")  # 128 MB, written to clear L2
    k3_cases = [
        check_banded(torch, bd, "poisson_2d banded f32", xb, banded.diags, banded.offsets, n2, flush),
        check_banded(torch, bd, "halfband 8 f32", xh8, D8, half8, n, flush),
        check_banded(torch, bd, "poisson_2d banded f64", xb.double(), banded.diags.double(),
                     banded.offsets, n2, flush),
        check_banded(torch, bd, "ragged n=300 f32", x300, D300, (-2, 0, 5), 300, flush),
    ]
    del xh8, D8
    k4_cases = [check_laplacian(torch, s1, n, dt, gen, flush) for dt in (torch.float32, torch.float64)]
    del flush
    emit({"phase": "kernels", "fused_step": k1_cases, "transform_partial": k2_cases,
          "banded_spmv": k3_cases, "laplacian_1d": k4_cases,
          "fused_step_library": "none: no single PyTorch call computes the fused step"})

    # per-launch times over the main path's schedule: the first cycle appends
    # rows 1..29 (B = 1..29), the 9 restarted cycles rows 19..29 (B = 19..29)
    m = 30
    schedule = list(range(1, m)) + 9 * list(range(19, m))
    spec = fl.spec_for(chain)
    V = torch.randn((kmax, R, 128), generator=gen, device="cuda")
    y = torch.randn((R, 128), generator=gen, device="cuda")
    g = torch.randn(kmax + 1, generator=gen, device="cuda")
    per_B = {}
    for B in sorted(set(schedule)):
        t_bound, _ = bound((B + 3) * n * 4, k1_flops(n, B, 3, True))
        per_B[B] = {
            "ms": device_ms(torch, lambda: fl.fused_step(V, y, g, B, B, spec, True), reps=5),
            "plain_ms": device_ms(
                torch, lambda: fl.fused_step_reference(V, y, g, B, B, spec, True), reps=2, batches=1
            ),
            "bound_ms": t_bound,
        }
    del V, y, g
    t2 = {c["m_out"]: c for c in k2_cases}
    k2_schedule = [20] * 10 + [4]

    # 4. small solve: card vs CPU (plain versions)
    xs = torch.randn((32, 128), generator=torch.Generator().manual_seed(1))
    alg_s = kt.Lanczos(krylovdim=30, maxiter=6, verbosity=kt.SILENT)
    vc, _, ic = kt.eigsolve_lanczos(kt.laplacian_1d(4096), xs.cuda(), 4, "LM", alg_s)
    vh, _, ih = kt.eigsolve_lanczos(kt.laplacian_1d(4096, device="cpu"), xs, 4, "LM", alg_s)
    small_err = float(torch.max(torch.abs(vc.cpu() - vh) / torch.abs(vh)))
    emit({"phase": "small", "n": 4096, "vals_cuda": vc.tolist(), "vals_cpu": vh.tolist(),
          "max_rel_err": small_err, "tolerance": 2e-4,
          "numops": [ic.numops, ih.numops], "numiter": [ic.numiter, ih.numiter]})
    require(small_err <= 2e-4, "small solve: card vs CPU values rtol 2e-4")
    require(ic.numops == ih.numops and ic.numiter == ih.numiter, "small solve: counts equal")

    # 5. main path at the bench configuration
    op = kt.laplacian_1d(n)
    x0 = torch.ones((R, 128), dtype=torch.float32, device="cuda")
    alg = kt.Lanczos(krylovdim=m, maxiter=10, tol=1e-30, verbosity=kt.SILENT)
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vals, vecs, info = kt.eigsolve_lanczos(op, x0, 4, "LM", alg)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(_build.launches)
    require(launches.get("fused_step", 0) > 0, "main path launched fused_step")
    require(launches.get("transform_partial", 0) > 0, "main path launched transform_partial")
    reps = 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        vals, vecs, info = kt.eigsolve_lanczos(op, x0, 4, "LM", alg)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / reps
    vals_h = vals.cpu()
    require(bool(torch.all(torch.abs(vals_h - 4.0) <= 2e-2)), f"vals ~ 4 (atol 2e-2): {vals_h.tolist()}")
    require(tuple(vecs.shape) == (4, R, 128) and bool(torch.isfinite(vecs).all()), "finite vecs")
    vnorm = torch.linalg.vector_norm(vecs.reshape(4, -1), dim=1).cpu()
    require(bool(torch.all(torch.abs(vnorm - 1) < 1e-3)), f"unit eigenvectors: {vnorm.tolist()}")
    require(info.numops == 138, f"numops 138 (got {info.numops})")
    require(launches == {"fused_step": len(schedule), "transform_partial": len(k2_schedule)},
            f"launches {launches}")
    k1_ms = sum(per_B[B]["ms"] for B in schedule)
    k2_ms = sum(t2[mo]["ms"] for mo in k2_schedule)
    value = info.numops * 3 * n / dt
    emit({
        "metric": "lanczos_eigsolve_spmv_orthog_throughput", "value": value, "unit": "nnz/s",
        "numops": info.numops, "numiter": info.numiter, "ms_per_solve": dt * 1e3,
        "first_solve_ms": first_s * 1e3, "vals": vals_h.tolist(),
        "normres": info.normres.cpu().tolist(), "launches_per_solve": launches,
        "kernel_ms_per_solve": {"fused_step": k1_ms, "transform_partial": k2_ms},
        "outside_kernels_ms_per_solve": dt * 1e3 - k1_ms - k2_ms,
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
    })

    # 6. small linear solves: card vs CPU (plain versions).  MINRES runs on
    # the 32x32 grid, where a0 = -0.1 lies inside the Laplacian's spectrum
    # [0.018, 7.98]; on larger indefinite grids its Lanczos vectors lose
    # orthogonality over ~300 iterations and differently rounded runs end a
    # few iterations apart.  The CPU run converges in 74 applies.
    quiet = {"verbosity": kt.SILENT}
    small_ls = []
    for name, gx, a0, alg_ls in [
        ("cg", 64, 0.5, kt.CG(tol=1e-8, maxiter=300, **quiet)),
        ("gmres30", 64, 0.5, kt.GMRES(krylovdim=30, tol=1e-8, maxiter=50, **quiet)),
        ("bicgstab", 64, 0.5, kt.BiCGStab(tol=1e-8, maxiter=300, **quiet)),
        ("minres", 32, -0.1, kt.MINRES(tol=1e-8, maxiter=300, **quiet)),
    ]:
        coo_s = poisson_coo(np, gx, np.float64)
        bh = torch.ones((gx * gx // 128, 128), dtype=torch.float64)
        _build.reset_launches()
        xc, ic = kt.linsolve(kt.banded_from_coo(*coo_s, gx * gx), bh.cuda(), a0=a0, alg=alg_ls)
        spmv = _build.launches["banded_spmv"]
        xh, ih = kt.linsolve(kt.banded_from_coo(*coo_s, gx * gx, device="cpu"), bh, a0=a0,
                             alg=alg_ls)
        rel = float((xc.cpu() - xh).abs().max() / xh.abs().max())
        small_ls.append({"solver": name, "grid": f"{gx}x{gx}", "a0": a0, "dtype": "float64",
                         "numops": [ic.numops, ih.numops], "numiter": [ic.numiter, ih.numiter],
                         "converged": [ic.converged, ih.converged], "x_max_rel_err": rel,
                         "tolerance": 1e-8, "banded_spmv_launches": spmv})
        require(ic.converged == ih.converged == 1, f"small {name}: converged on card and CPU")
        require((ic.numops, ic.numiter) == (ih.numops, ih.numiter), f"small {name}: counts equal")
        require(rel <= 1e-8, f"small {name}: x card vs CPU within rtol 1e-8")
        require(spmv == ic.numops, f"small {name}: one banded_spmv launch per operator apply")
    # fused GMRES in float32 on a grid of 128 columns (the fused path's
    # condition); tol 1e-3 is 1.1e-5 of |b|, and float32 noise of such a
    # solve is ~1e-6 of max|x|
    bf = torch.ones((64, 128))
    alg_f = kt.GMRES(krylovdim=30, tol=1e-3, maxiter=20, **quiet)
    _build.reset_launches()
    xc, ic = kt.linsolve(kt.poisson_2d(64, 128), bf.cuda(), a0=0.5, alg=alg_f)
    k1_small = _build.launches["fused_step"]
    xh, ih = kt.linsolve(kt.poisson_2d(64, 128, device="cpu"), bf, a0=0.5, alg=alg_f)
    rel = float((xc.cpu() - xh).abs().max() / xh.abs().max())
    small_ls.append({"solver": "gmres30 fused", "grid": "64x128", "a0": 0.5, "dtype": "float32",
                     "numops": [ic.numops, ih.numops], "numiter": [ic.numiter, ih.numiter],
                     "converged": [ic.converged, ih.converged], "x_max_rel_err": rel,
                     "tolerance": 2e-5, "fused_step_launches": k1_small})
    emit({"phase": "small_linsolve", "solves": small_ls})
    require(ic.converged == ih.converged == 1 and ic.numiter == ih.numiter,
            "small fused GMRES: converged on both, numiter equal")
    require(rel <= 2e-5 and k1_small > 0, "small fused GMRES: x within 2e-5, fused_step launched")

    # 7. config 2 at full size
    grid_spec = fl.spec_for(grid)
    n1 = 1 << 21
    b2 = torch.ones((n2 // 128, 128), device="cuda")
    b1 = torch.ones(n1, device="cuda")
    lap = kt.laplacian_1d_pallas(n1)
    k3_main, k4_main = k3_cases[0], k4_cases[0]
    solves = [
        # (metric, operator, b, a0, algorithm, linsolve keywords, nnz per apply, must converge)
        ("cg_poisson_2d", grid, b2, 0.5, kt.CG(tol=5e-5, maxiter=400, **quiet),
         {"ishermitian": True, "isposdef": True}, 5 * n2, True),
        ("gmres30_poisson_2d", grid, b2, 0.0,
         kt.GMRES(krylovdim=30, tol=1e-4, maxiter=14, **quiet), {}, 5 * n2, False),
        ("gmres30_poisson_2d_shifted_convergent", grid, b2, 0.5,
         kt.GMRES(krylovdim=30, tol=5e-5, maxiter=20, **quiet), {}, 5 * n2, True),
        ("cg_poisson_2d_banded", banded, b2, 0.5, kt.CG(tol=5e-5, maxiter=400, **quiet),
         {"ishermitian": True, "isposdef": True}, 5 * n2, True),
        ("gmres30_poisson_2d_banded_shifted_convergent", banded, b2, 0.5,
         kt.GMRES(krylovdim=30, tol=5e-5, maxiter=20, **quiet), {}, 5 * n2, True),
        # tol 1e-3 = 6.9e-7 of |b|: the same solve on the CPU (plain versions)
        # converges in 9 iterations to a true residual of 4.2e-4
        ("bicgstab_laplacian_1d_pallas", lap, b1, 0.5, kt.BiCGStab(tol=1e-3, maxiter=100, **quiet),
         {}, 3 * n1, True),
    ]
    Vg = torch.randn((kmax, n2 // 128, 128), generator=gen, device="cuda")
    yg = torch.randn((n2 // 128, 128), generator=gen, device="cuda")
    gg = torch.randn(kmax + 1, generator=gen, device="cuda")
    grid_ms = {}
    config2_launches = {}
    xs_by_metric = {}
    for metric, op2, b, a0, alg2, kw, nnz, must_converge in solves:
        x, info2, launches2, Bs, first_ms, ms = drive_solve(torch, kt, _build, fl, op2, b, a0,
                                                            alg2, **kw)
        for key, count in launches2.items():
            config2_launches[key] = config2_launches.get(key, 0) + count
        xs_by_metric[metric] = x
        true_res = float(torch.linalg.vector_norm(b - (a0 * x + op2.normal(x))))
        kernel_ms = {}
        if Bs:
            for key in set(Bs):
                if key not in grid_ms:
                    grid_ms[key] = device_ms(
                        torch, lambda: fl.fused_step(Vg, yg, gg, key[0], key[0], grid_spec, key[1]),
                        reps=5,
                    )
            kernel_ms["fused_step"] = sum(grid_ms[key] for key in Bs)
        if launches2.get("banded_spmv"):
            kernel_ms["banded_spmv"] = launches2["banded_spmv"] * k3_main["ms"]
        if launches2.get("laplacian_1d"):
            kernel_ms["laplacian_1d"] = launches2["laplacian_1d"] * k4_main["ms"]
        emit({
            "metric": metric, "value": info2.numops * nnz / ms / 1e6, "unit": "Gnnz/s",
            "formula": f"numops * {nnz // b.numel()}n / t (benchmarks/run_all.py)",
            "converged": info2.converged, "numops": info2.numops, "numiter": info2.numiter,
            "ms_per_solve": ms, "first_solve_ms": first_ms, "tol": alg2.tol,
            "normres": float(info2.normres), "true_residual": true_res,
            "launches_per_solve": launches2, "fused_step_B_mean": (sum(B for B, _ in Bs) / len(Bs)
                                                                  if Bs else None),
            "kernel_ms_per_solve": kernel_ms,
            "outside_kernels_ms_per_solve": ms - sum(kernel_ms.values()),
            "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        })
        require(launches2.get("fused_step", 0) == len(Bs), f"{metric}: fused steps recorded")
        if must_converge:
            require(info2.converged == 1 and true_res <= alg2.tol,
                    f"{metric}: converged, true residual {true_res} within tol {alg2.tol}")
        if op2 is banded:
            require(launches2.get("banded_spmv", 0) == info2.numops,
                    f"{metric}: banded_spmv launches == numops")
    require(config2_launches.get("fused_step", 0) > 0, "gmres30_poisson_2d launched fused_step")
    require(config2_launches.get("laplacian_1d", 0) > 0, "bicgstab launched laplacian_1d")
    for banded_metric, stencil_metric in (
        ("cg_poisson_2d_banded", "cg_poisson_2d"),
        ("gmres30_poisson_2d_banded_shifted_convergent", "gmres30_poisson_2d_shifted_convergent"),
    ):
        xa, xs_ = xs_by_metric[banded_metric], xs_by_metric[stencil_metric]
        rel = float((xa - xs_).abs().max() / xs_.abs().max())
        emit({"phase": "config2_agreement", "banded": banded_metric, "stencil": stencil_metric,
              "x_max_rel_err": rel, "tolerance": 1e-4})
        require(rel <= 1e-4, f"{banded_metric}: x agrees with {stencil_metric} to 1e-4")
    del Vg, yg, gg

    if args.profile:
        emit(profile_solve(torch, kt, op, x0, alg))

    def mean(xs):
        return sum(xs) / len(xs)

    emit({"kernels": [
        {
            "name": "fused_step", "route": "cuda",
            "source": "krylovkit_tpu_torch/csrc/fused_lanczos.cu",
            "replaces": "krylovkit_tpu/ops/pallas_fused_lanczos.py:253",
            "launches": launches["fused_step"],
            "max_abs_err": max(c["max_abs_err"] for c in k1_cases),
            "ms": mean([per_B[B]["ms"] for B in schedule]),
            "plain_ms": mean([per_B[B]["plain_ms"] for B in schedule]),
            "bound_ms": mean([per_B[B]["bound_ms"] for B in schedule]),
            "bound_by": "bytes", "library_ms": None,
            "shapes": "mean per launch over the main path's 128 steps, B = 1..29",
            "launches_config2": config2_launches.get("fused_step", 0),
        },
        {
            "name": "transform_partial", "route": "cuda",
            "source": "krylovkit_tpu_torch/csrc/transform.cu",
            "replaces": "krylovkit_tpu/ops/basis.py:289",
            "launches": launches["transform_partial"],
            "max_abs_err": max(c["max_abs_err"] for c in k2_cases),
            "ms": mean([t2[mo]["ms"] for mo in k2_schedule]),
            "plain_ms": mean([t2[mo]["plain_ms"] for mo in k2_schedule]),
            "bound_ms": mean([t2[mo]["bound_ms"] for mo in k2_schedule]),
            "bound_by": t2[20]["bound_by"],
            "library_ms": mean([t2[mo]["library_ms"] for mo in k2_schedule]),
            "shapes": "mean per launch over the main path's 11 calls: m_out 20 x10, 4 x1",
        },
        {
            "name": "banded_spmv", "route": "cuda",
            "source": "krylovkit_tpu_torch/csrc/banded_spmv.cu",
            "replaces": "krylovkit_tpu/ops/pallas_spmv.py:44",
            "launches": config2_launches.get("banded_spmv", 0),
            "max_abs_err": max(c["max_abs_err"] for c in k3_cases),
            "ms": k3_main["ms"], "cold_ms": k3_main["cold_ms"], "plain_ms": k3_main["plain_ms"],
            "bound_ms": k3_main["bound_ms"], "bound_by": k3_main["bound_by"],
            "library_ms": k3_main["library_ms"],
            "shapes": "banded poisson_2d(1024, 1024) f32, n = 2^20, 5 offsets; launches "
                      "over the two banded config-2 solves",
        },
        {
            "name": "laplacian_1d", "route": "cuda",
            "source": "krylovkit_tpu_torch/csrc/laplacian_1d.cu",
            "replaces": "krylovkit_tpu/ops/pallas_stencil.py:31",
            "launches": config2_launches.get("laplacian_1d", 0),
            "max_abs_err": max(c["max_abs_err"] for c in k4_cases),
            "ms": k4_main["ms"], "cold_ms": k4_main["cold_ms"], "plain_ms": k4_main["plain_ms"],
            "bound_ms": k4_main["bound_ms"], "bound_by": k4_main["bound_by"],
            "library_ms": k4_main["library_ms"],
            "shapes": "n = 2^21 f32; launches over the config-2 BiCGStab solve",
        },
    ]})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
