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
   the main path's shapes, with its bit-identity contract, its time (CUDA
   events), the plain version's time, a yardstick PyTorch call where one
   computes the same function, and its bound on the card;
4. small   — the port's eigsolve on a small Laplacian, on the card against
   the same solve on the CPU (plain versions);
5. main    — the port's Lanczos eigsolve at the bench configuration
   (``laplacian_1d(2**21)``, 4 eigenpairs "LM", krylovdim 30, maxiter 10,
   f32 ``(n/128, 128)`` vectors, default cgs2): launch counts of one solve,
   then 3 timed solves and the nnz/s metric of ``bench.py``;
6. profile (only with ``--profile``) — one more main-path solve under
   ``torch.profiler``: device busy time and idle share, device ops, host
   reads of device scalars, device time by kernel name.

Then the kernel summary line, the ``nvidia-smi`` name/power line, and as the
last line ``{"ok": true, "device": {...}}``.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and float32 (non-tensor-core) rate
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
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


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
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
                    help="also profile one main-path solve (phase 6)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import krylovkit_tpu_torch as kt
    from krylovkit_tpu_torch import _build
    from krylovkit_tpu_torch.ops import basis as bs
    from krylovkit_tpu_torch.ops import fused_lanczos as fl

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

    # 3. kernels at the main path's shapes
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
    emit({"phase": "kernels", "fused_step": k1_cases, "transform_partial": k2_cases,
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
    ]})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
