#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one GPU.

  python3 chip_smoke.py          # from the root of a checkout

1. Prints the card's name and power limit (nvidia-smi) and switches TF32
   off for matmuls and cuDNN.
2. Builds the port's CUDA kernel from the checkout and prints the build
   seconds and the ptxas report.
3. Kernel phase: holds the kernel's wrapper (``ops.lloyd_step``, the
   call the main path makes) against its plain PyTorch version on the
   card, at the main path's shape and at the other shapes listed in
   KERNEL_SHAPES, and times both (median of 20 runs, CUDA events).
4. Main path: sets every launch count to 0, runs the port's
   ``--mode paper`` with the reference defaults (100 clients, 10
   clusters, 12,000-image pool, the CNN-MNIST, seed 0) for 3 rounds on
   cuda, reads the counts, and checks them and the round logs; each
   round must pick the clients the JAX package picks with these
   defaults (REFERENCE_WINNERS).
5. Agreement: the same main path on the CPU, where every kernel is its
   plain version (the path the CPU tests hold against the JAX package),
   must select the same clients every round, with the same round metrics.

It prints one JSON line with the kernels' numbers and, last, the JSON
status line.  ``--profile`` adds a torch.profiler pass before them:
device time by kernel for the fleet-shape Lloyd step and for one more
main-path run, and that run's device-busy share of its wall time (it
adds minutes, so the plain smoke run leaves it out).  Without a CUDA
device, or run outside a checkout, it exits non-zero and prints no
result.  Any failed check raises.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): float32
# outside the tensor cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

# (label, N, F, K, R, dtype, seed); "main" is the shape stage 1 of the
# main path gives the kernel (100 clients, 256 projected features,
# 10 clusters, 4 restarts)
KERNEL_SHAPES = (
    ("main", 100, 256, 10, 4, torch.float32, 0),
    ("ragged", 257, 100, 7, 1, torch.float32, 1),
    ("bf16", 4096, 256, 16, 1, torch.bfloat16, 2),
    ("fleet", 100_000, 256, 10, 4, torch.float32, 3),
)
MAIN_ARGS = ["--rounds", "3", "--quiet"]          # reference defaults else
# The clients the JAX package (python -m repro.launch.train --mode paper
# --rounds 3) selects in rounds 0-2; the s_min sample threshold and the
# energy gate leave some of the 10 clusters without an eligible bidder.
# tests/test_torch_slice.py::test_cli_defaults_match_jax_cli holds the
# port's CPU run and the JAX run to the same sets.
REFERENCE_WINNERS = [[1, 35, 40], [12, 35, 36, 41, 49, 58, 60, 63],
                     [0, 1, 3, 19, 35, 36, 44, 58, 62]]


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def median_ms(fn, reps: int = 20, host_ahead: bool = True) -> float:
    """Median over ``reps`` runs of one call's CUDA-event time.  With
    ``host_ahead`` a ~1 ms spin kernel is queued first, so the host has
    enqueued the call before the start event fires and the time is the
    device's alone; without it the time includes the host's enqueue work
    (what one call costs the main path when the device is idle)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        if host_ahead:
            torch.cuda._sleep(2_000_000)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def lloyd_bound(n, f, k, r, x_bytes):
    """Least time for one fused step on an H100 SXM: x, c read once and
    every output written once, against the fp32 FMA work."""
    moved = (n * f * x_bytes + r * k * f * 4            # x, c
             + r * n * 8 + r * k * f * 4 + r * k * 4)   # outputs
    ops = (2 * n * k * f * r                              # distances
           + 2 * n * f + 2 * r * k * f                    # norms
           + n * f * r)                                   # update sums
    t_bytes, t_ops = moved / PEAK_HBM_BYTES, ops / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_lloyd(OPS, dev, label, n, f, k, r, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, f, device=dev, generator=g).to(dtype)
    c = torch.randn(r, k, f, device=dev, generator=g)
    before = OPS.lloyd_step.launches
    lab, dist, sums, counts = OPS.lloyd_step(x, c)
    torch.cuda.synchronize()
    require(OPS.lloyd_step.launches == before + 1,
            f"{label}: the wrapper did not count exactly one launch")
    lab_p, dist_p, _, _ = OPS._lloyd_step_torch(x, c)
    d = OPS.distances(x, c)                         # plain (R, N, K)
    torch.cuda.synchronize()
    best2 = d.topk(2, dim=2, largest=False).values
    clear = (best2[..., 1] - best2[..., 0]) > 1e-4 * best2[..., 0].abs()
    require(torch.equal(lab[clear], lab_p[clear]),
            f"{label}: labels differ off near-ties")
    picked = torch.gather(d, 2, lab.long()[..., None])[..., 0]
    require(bool((picked - best2[..., 0]
                  <= 1e-4 * best2[..., 0].abs() + 1e-4).all()),
            f"{label}: a near-tie label is not nearest by distance")
    dist_err = (dist - dist_p).abs()
    require(bool((dist_err <= 1e-4 * dist_p.abs().clamp_min(1.0)).all()),
            f"{label}: dist beyond 1e-4 relative")
    onehot = torch.nn.functional.one_hot(lab.long(), k).float()
    xf = x.float()
    ref_sums = onehot.transpose(1, 2) @ xf
    scale = onehot.transpose(1, 2) @ xf.abs()
    sums_err = (sums - ref_sums).abs()
    require(bool((sums_err <= 1e-4 * scale + 1e-6).all()),
            f"{label}: sums differ from onehot^T x beyond 1e-4 relative")
    require(torch.equal(counts, onehot.sum(1)), f"{label}: counts differ")
    require(bool((counts.sum(1) == n).all()), f"{label}: counts != N")
    again = OPS.lloyd_step(x, c)
    require(all(torch.equal(a, b) for a, b in
                zip((lab, dist, sums, counts), again)),
            f"{label}: two runs differ")
    ms = median_ms(lambda: OPS.lloyd_step(x, c))
    call_ms = median_ms(lambda: OPS.lloyd_step(x, c), host_ahead=False)
    plain_ms = median_ms(lambda: OPS._lloyd_step_torch(x, c))
    bound_ms, bound_by = lloyd_bound(n, f, k, r, x.element_size())
    err = max(float(dist_err.max()), float(sums_err.max()))
    print(f"lloyd_step[{label}] N={n} F={f} K={k} R={r} "
          f"{str(dtype).removeprefix('torch.')}: ms={ms!r} call_ms={call_ms!r} "
          f"plain_ms={plain_ms!r} bound_ms={bound_ms!r} ({bound_by}) "
          f"max_abs_err={err!r} near_tie_rows={int((~clear).sum())}",
          flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": err}


def profile_pass(OPS, TRAIN) -> None:
    """Device time by kernel (torch.profiler, CUPTI) for the fleet-shape
    Lloyd step and for a main-path run; the busy share is the summed
    kernel time over the run's wall time (with the profiler's own host
    overhead in the wall time)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    cuda_t = torch.autograd.DeviceType.CUDA

    def kernel_rows(prof):
        return sorted((e for e in prof.key_averages()
                       if e.device_type == cuda_t),
                      key=lambda e: -e.self_device_time_total)

    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(100_000, 256, device="cuda", generator=g)
    c = torch.randn(4, 10, 256, device="cuda", generator=g)
    OPS.lloyd_step(x, c)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        for _ in range(10):
            OPS.lloyd_step(x, c)
        torch.cuda.synchronize()
    for e in kernel_rows(prof):
        print(f"profile fleet lloyd_step: {e.key[:60]} count={e.count} "
              f"device_us_per_call={e.self_device_time_total / e.count!r}",
              flush=True)
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        TRAIN.main(MAIN_ARGS)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = kernel_rows(prof)
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    print(f"profile main path: wall_s={wall!r} device_busy_s={busy!r} "
          f"busy_share={busy / wall!r} kernels={len(rows)}", flush=True)
    for e in rows[:12]:
        print(f"  {e.key[:60]} count={e.count} "
              f"device_ms={e.self_device_time_total / 1e3!r}", flush=True)


def phase(name: str, t0: float) -> None:
    print(f"[{time.perf_counter() - t0:.1f} s] {name}", flush=True)


def main() -> int:
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import obs
    from repro_torch.kernels import kmeans as KM
    from repro_torch.kernels import ops as OPS
    from repro_torch.launch import train as TRAIN

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    TRAIN.set_float32_precision()

    secs = KM.build()
    print(f"built {KM.SOURCE.name} in {secs:.1f} s", flush=True)
    print(KM.BUILD_LOG.strip(), flush=True)

    # ---- kernel phase --------------------------------------------------
    phase("kernel phase", t0)
    cuda = torch.device("cuda")
    shapes = {label: check_lloyd(OPS, cuda, label, n, f, k, r, dt, seed)
              for label, n, f, k, r, dt, seed in KERNEL_SHAPES}

    # ---- main path -----------------------------------------------------
    phase("main path", t0)
    OPS.lloyd_step.launches = 0
    obs.SPANS.clear()
    result = TRAIN.main(MAIN_ARGS)
    torch.cuda.synchronize()
    launches = OPS.lloyd_step.launches
    stage1_s = obs.SPANS["run/cluster"]
    print(f"main path: stage1_s={stage1_s!r} "
          f"rounds_s={result['wall_s'] - stage1_s!r} "
          f"lloyd_step launches={launches}", flush=True)
    print("  host spans (s): " + " ".join(
        f"{k}={v!r}" for k, v in sorted(obs.SPANS.items())), flush=True)
    for t, row in enumerate(zip(result["num_selected"],
                                result["energy_std"], result["mean_bid"],
                                result["vds_gap"], result["test_acc"])):
        print("  round {} selected={} energy_std={!r} mean_bid={!r} "
              "vds_gap={!r} test_acc={!r}".format(t, *row), flush=True)
    require(launches == 26, f"stage 1 made {launches} lloyd_step launches, "
            "expected 26 (25 Lloyd iterations + 1 final assignment)")
    require(result["selected"] == REFERENCE_WINNERS,
            f"rounds selected {result['selected']}, the JAX package "
            f"selects {REFERENCE_WINNERS}")
    require(result["params_finite"], "non-finite params")
    require(all(math.isfinite(a) for a in result["test_acc"]),
            "non-finite accuracy")

    # ---- agreement with the plain path on the CPU ----------------------
    phase("agreement on the CPU", t0)
    plain = TRAIN.main(MAIN_ARGS + ["--device", "cpu"])
    require(result["selected"] == plain["selected"],
            f"cuda and cpu runs selected different clients: "
            f"{result['selected']} vs {plain['selected']}")
    for key, tol in (("energy_std", 1e-5), ("mean_bid", 1e-5),
                     ("vds_gap", 1e-5), ("test_loss", 1e-3),
                     ("test_acc", 2e-3)):
        require(all(math.isclose(a, b, rel_tol=tol, abs_tol=tol)
                    for a, b in zip(result[key], plain[key])),
                f"cuda and cpu {key} differ: {result[key]} vs {plain[key]}")
    print(f"agreement: cuda and cpu select {result['selected']}; cpu "
          f"test_loss={plain['test_loss']!r} wall_s={plain['wall_s']!r}",
          flush=True)

    if "--profile" in sys.argv[1:]:
        phase("profile", t0)
        profile_pass(OPS, TRAIN)

    phase("done", t0)
    main_shape = shapes["main"]
    print(json.dumps({"kernels": [{
        "name": "lloyd_step", "route": "cuda",
        "source": "src/repro_torch/csrc/kmeans.cu",
        "replaces": "src/repro/kernels/kmeans.py:144",
        "launches": launches, "max_abs_err": main_shape["max_abs_err"],
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"], "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
