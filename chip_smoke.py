#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one GPU.

  python3 chip_smoke.py          # from the root of a checkout

1. Prints the card's name and power limit (nvidia-smi) and switches TF32
   off for matmuls and cuDNN.
2. Builds the port's two CUDA sources from the checkout (one nvcc each,
   started together) and prints the build seconds, the ptxas report
   (registers and spills per kernel) and, by cuobjdump, the
   HMMA (tensor-core) instructions of each flash-attention kernel; each
   bf16 instantiation must have some.  cuobjdump and cu++filt are taken
   from the directory of the nvcc that built the kernels.
3. Kernel phases: holds each kernel's wrapper (``ops.lloyd_step``,
   ``ops.kmeans_assign``, ``ops.flash_attention``, the calls the paths
   make) against its plain PyTorch version on the card, at the paths'
   shapes and at the other shapes listed in KERNEL_SHAPES and
   FLASH_SHAPES, and times both (median of 20 runs, CUDA events; the
   k-means kernels also with the host's enqueue work, ``call_ms``), and
   flash attention also against ``scaled_dot_product_attention`` (the
   library yardstick; the port never calls it), with its achieved
   TFLOP/s (the useful operations over its time), SDPA's share of the
   same error bound and, for bf16, the share of the plain version with p
   rounded once to bf16 before P.V (a single bf16 P, which the kernel
   avoids by carrying p as two bf16 terms).
4. Paper path: sets every launch count to 0, runs the port's
   ``--mode paper`` with the reference defaults (100 clients, 10
   clusters, 12,000-image pool, the CNN-MNIST, seed 0) for 3 rounds on
   cuda, reads the counts, and checks them and the round logs; each
   round must pick the clients the JAX package picks with these
   defaults (REFERENCE_WINNERS).
5. Agreement: the same path on the CPU, where every kernel is its plain
   version (the path the CPU tests hold against the JAX package), must
   select the same clients every round, with the same round metrics.
6. Stage-1 assign path: the same run with k-means' ``assign_fn`` hook
   set to ``ops.kmeans_assign`` (as ``FederatedServer(assign_fn=...)``
   takes it), counts reset before and read after; it must pick the
   same winners.
7. Cohort runtimes path: the paper path of 4. again with ``--runtime
   vectorized`` and ``--runtime device`` (the batched engine: one vmapped
   stage-1 gradient pass, batched local training with fused FedAvg), each
   with the counts reset before and read after (26 ``lloyd_step``
   launches), held to REFERENCE_WINNERS and to the sequential cuda run's
   final params (max |d| < 1e-4, tests/test_sim.py's bound); the device
   runtime must meet no new shape after its warm-up.  Prints stage-1,
   feature, k-means, warm-up and per-round seconds for all three
   runtimes, and times the feature pass over the whole client axis
   against 4-wide chunks.
8. Scheme comparison path: the paper's four ``--scheme`` values
   (``gradient_cluster_auction`` and its baselines
   ``gradient_cluster_random``, ``weights_cluster_random`` and
   ``random``) at the reference defaults for the paper's 30 rounds on
   ``--runtime vectorized``, counts reset before and read after each (26
   ``lloyd_step`` launches for a clustered scheme, none for ``random``),
   each round held to the JAX package's winners (SCHEME_WINNERS); then
   ``weights_cluster_random`` for 3 rounds on ``--runtime sequential``
   (the per-client weight-delta loop), which must give the batched
   pass's clusters; then ``--scheme-select fedcs`` and
   ``longterm_auction`` for 3 rounds (SELECT_WINNERS).  Prints each
   scheme's stage-1 seconds, seconds per round, final accuracy,
   ``energy_std`` and mean ``vds_gap`` (the numbers behind the paper's
   figures 3, 4 and 9).
9. Selection path: ``--mode selection --clients 1000000 --rounds 100``
   for each ``--scheme-select`` value (warm and cold rounds/s); then, for
   those four and the three baseline ``--scheme`` values,
   ``simulate_rounds`` at N = 1,000,000 and T = 10 with ``record_wins``
   under ``torch.cuda.set_sync_debug_mode("error")`` (a host
   synchronisation in the loop raises) held bit for bit to
   ``simulate_rounds_reference`` (winners, residual, history, metrics),
   and a warm 100-round ``simulate_rounds`` of each ``--scheme-select``
   under the same mode.
10. Serving path at full width: qwen2-0.5b (24 layers, bf16, weights
   from ``init_params(cfg, PRNGKey(0))``) with ``attn_impl="pallas"``:
   ``logits_fn`` prefill of 4,096 tokens, counts reset before and read
   after (24 flash_attention launches), held against the plain
   ``attn_impl="naive"`` path; teacher-forced ``decode_step`` over 1,536
   tokens held against the kernel prefill; and ``serve`` of 4 x 32
   tokens, whose ids must be the argmax of the logits that made them.

It prints one JSON line with the kernels' numbers and, last, the JSON
status line.  ``--profile`` adds a torch.profiler pass before them:
device time by kernel for the fleet-shape Lloyd step, for one more
paper-path run on the sequential and on the vectorized runtime, for 20
rounds of the selection loop at a million clients under each
``--scheme-select``, for a warm prefill and for 32 decode steps, and each
run's device-busy share of its wall time (it adds minutes, so the plain
smoke run leaves it out).  Without a CUDA device, or run outside a
checkout, it exits non-zero and prints no result.  Any failed check
raises.
"""
from __future__ import annotations

import importlib
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): float32
# outside the tensor cores, bf16 on the tensor cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
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
# The clients the JAX package selects at the reference defaults for the
# paper's 30 rounds under each --scheme, and for 3 rounds under the
# registry's fedcs (at its default deadline of 1.5 fleet-mean round
# times, where no client is predicted to make it, and at 2.5) and
# longterm_auction, each run as python -m repro.launch.train --mode
# paper --runtime sequential --scheme <s> (or --rounds 3 --scheme-select
# <key>) on the CPU.  Winners depend on the clusters, energy, history
# and scheme state, never on the trained params, so they hold on any
# runtime and device.
SCHEME_WINNERS = {
    "gradient_cluster_auction": (
        [[1, 35, 40], [12, 35, 36, 41, 49, 58, 60, 63], [0, 1, 3, 19, 35,
        36, 44, 58, 62], [24, 31, 53, 57, 72, 79, 80, 85, 86, 98], [18,
        21, 35, 36, 39, 52, 64, 67, 83, 90], [6, 11, 20, 23, 28, 32, 75,
        84, 97, 99], [6, 9, 21, 25, 37, 40, 43, 64, 78, 92], [2, 5, 11,
        27, 29, 48, 54, 56, 70, 93], [3, 5, 12, 26, 41, 44, 49, 57, 80,
        88], [17, 30, 34, 38, 46, 65, 71, 73, 82, 89], [7, 15, 20, 22, 24,
        51, 53, 68, 79, 96], [23, 31, 42, 60, 66, 67, 84, 85, 98, 99], [9,
        28, 34, 45, 47, 51, 63, 70, 82, 86], [16, 18, 50, 55, 61, 62, 69,
        74, 83, 87], [8, 10, 13, 14, 29, 72, 76, 77, 91, 95], [4, 22, 33,
        46, 48, 50, 59, 75, 81, 97], [15, 19, 27, 30, 31, 42, 54, 56, 78,
        93], [17, 21, 24, 25, 32, 39, 43, 66, 88, 90], [0, 1, 38, 47, 52,
        64, 73, 85, 89, 96], [3, 4, 7, 26, 40, 49, 65, 68, 71, 92], [2,
        11, 45, 53, 69, 80, 86, 87, 94, 98], [8, 10, 12, 14, 16, 33, 37,
        61, 79, 95], [13, 20, 28, 55, 74, 76, 77, 82, 91, 99], [9, 18, 23,
        44, 46, 57, 60, 62, 71, 75], [5, 6, 29, 50, 51, 58, 63, 67, 72,
        84], [19, 25, 27, 32, 41, 48, 54, 56, 70, 83], [22, 30, 31, 34,
        39, 65, 66, 78, 93, 97], [13, 15, 17, 42, 69, 76, 81, 88, 90, 94],
        [0, 38, 43, 45, 47, 52, 61, 74, 89, 96], [7, 21, 24, 26, 40, 49,
        68, 73, 85, 92]]),
    "gradient_cluster_random": (
        [[4, 12, 18, 43, 51, 65, 70, 77, 79, 86], [3, 5, 11, 20, 26, 37,
        39, 52, 54, 58], [18, 35, 36, 41, 42, 49, 54, 60, 83, 87], [7, 23,
        26, 30, 39, 41, 52, 54, 75, 88], [1, 26, 53, 57, 70, 72, 79, 84,
        85, 88], [18, 21, 25, 27, 40, 43, 56, 62, 64, 99], [9, 18, 21, 25,
        36, 37, 43, 44, 52, 60], [35, 36, 39, 40, 41, 43, 44, 58, 67, 92],
        [12, 21, 28, 35, 37, 39, 40, 53, 54, 56], [14, 22, 35, 36, 40, 41,
        49, 68, 73, 87], [19, 35, 36, 40, 41, 44, 58, 62, 63, 97], [3, 18,
        25, 26, 39, 51, 52, 54, 67, 90], [11, 12, 36, 37, 60, 64, 65, 68,
        93, 99], [5, 6, 7, 11, 20, 29, 38, 72, 83, 84], [3, 19, 24, 26,
        31, 32, 35, 40, 48, 67], [12, 19, 35, 36, 41, 57, 60, 68, 73, 94],
        [2, 6, 21, 35, 39, 40, 63, 64, 67, 98], [0, 3, 6, 12, 18, 25, 41,
        44, 49, 67], [2, 11, 20, 26, 35, 37, 49, 54, 78, 83], [2, 21, 25,
        27, 38, 40, 44, 49, 63, 96], [0, 5, 7, 19, 41, 53, 56, 58, 84,
        92], [21, 35, 36, 39, 58, 60, 62, 63, 64, 67], [7, 35, 36, 38, 41,
        59, 60, 63, 64, 92], [0, 12, 35, 36, 41, 49, 64, 67, 83, 98], [1,
        4, 27, 35, 36, 40, 43, 49, 62, 88], [6, 9, 25, 37, 40, 41, 44, 52,
        63, 98], [2, 6, 9, 11, 35, 53, 58, 67, 70, 84], [11, 15, 19, 32,
        37, 56, 63, 70, 78, 84], [21, 29, 43, 46, 47, 48, 54, 60, 72, 75],
        [1, 5, 20, 32, 37, 38, 49, 54, 56, 83]]),
    "weights_cluster_random": (
        [[8, 12, 18, 19, 24, 35, 41, 43, 86, 97], [1, 3, 35, 36, 37, 39,
        52, 54, 58, 59], [3, 11, 18, 32, 35, 36, 37, 41, 49, 54], [35, 36,
        39, 41, 43, 47, 54, 62, 88, 91], [4, 19, 57, 66, 70, 72, 83, 84,
        85, 88], [11, 18, 21, 25, 27, 43, 49, 56, 62, 64], [9, 25, 27, 28,
        36, 43, 52, 54, 60, 99], [6, 13, 35, 39, 40, 43, 44, 58, 67, 92],
        [12, 18, 21, 35, 37, 39, 53, 54, 56, 83], [0, 3, 25, 32, 36, 37,
        49, 58, 64, 73], [13, 19, 24, 28, 35, 36, 40, 62, 63, 97], [12,
        35, 36, 39, 40, 43, 54, 58, 67, 74], [5, 11, 12, 36, 37, 43, 49,
        60, 64, 98], [19, 35, 36, 38, 60, 61, 72, 83, 84, 97], [3, 19, 35,
        36, 40, 42, 44, 58, 62, 67], [5, 6, 12, 24, 39, 57, 60, 73, 78,
        83], [2, 14, 19, 27, 35, 36, 40, 63, 64, 88], [3, 12, 14, 35, 36,
        41, 44, 47, 49, 58], [2, 20, 35, 45, 49, 54, 78, 83, 86, 97], [2,
        35, 36, 40, 44, 49, 58, 63, 67, 76], [0, 3, 5, 7, 15, 19, 24, 56,
        58, 92], [35, 36, 38, 39, 54, 60, 62, 63, 67, 73], [6, 18, 35, 37,
        39, 45, 60, 63, 64, 92], [0, 12, 35, 36, 44, 47, 49, 58, 83, 94],
        [1, 5, 6, 43, 44, 49, 52, 65, 67, 98], [6, 9, 25, 37, 41, 44, 52,
        53, 63, 98], [2, 19, 21, 35, 36, 58, 63, 64, 67, 74], [0, 15, 19,
        35, 36, 43, 47, 62, 78, 84], [5, 19, 37, 43, 54, 56, 58, 60, 72,
        99], [5, 20, 32, 37, 49, 53, 54, 56, 83, 98]]),
    "random": (
        [[3, 4, 11, 16, 22, 33, 55, 68, 79, 89], [26, 30, 42, 52, 61, 81,
        89, 90, 94, 97], [27, 38, 45, 49, 52, 63, 75, 79, 86, 88], [21,
        25, 26, 38, 54, 65, 72, 80, 90, 99], [6, 7, 12, 14, 27, 30, 45,
        49, 52, 99], [7, 23, 47, 53, 69, 73, 82, 85, 93, 94], [6, 22, 24,
        27, 30, 40, 45, 53, 71, 91], [9, 14, 26, 28, 54, 68, 69, 77, 85,
        92], [7, 16, 17, 22, 28, 44, 61, 64, 65, 94], [2, 7, 8, 19, 34,
        48, 61, 68, 80, 87], [10, 45, 46, 59, 61, 63, 70, 71, 80, 93], [1,
        24, 37, 53, 69, 91, 92, 94, 97, 98], [20, 30, 32, 63, 64, 71, 81,
        83, 87, 95], [3, 32, 39, 58, 62, 74, 78, 79, 92, 93], [8, 15, 29,
        44, 50, 51, 54, 80, 86, 91], [2, 22, 26, 29, 58, 65, 67, 70, 72,
        85], [21, 26, 42, 58, 73, 83, 84, 85, 96, 98], [6, 25, 27, 46, 53,
        57, 74, 88, 91, 93], [17, 19, 20, 29, 36, 56, 57, 61, 65, 67],
        [16, 17, 26, 37, 68, 71, 75, 84, 89, 98], [6, 12, 18, 23, 61, 75,
        86, 93, 96, 98], [10, 17, 21, 25, 46, 49, 75, 87, 97, 99], [12,
        22, 27, 28, 37, 51, 55, 68, 87, 94], [7, 9, 17, 39, 41, 46, 55,
        83, 85, 93], [5, 10, 14, 25, 29, 54, 57, 61, 69, 75], [3, 9, 10,
        17, 18, 71, 74, 78, 86, 92], [13, 16, 23, 30, 31, 34, 35, 40, 62,
        76], [1, 9, 20, 32, 47, 63, 74, 86, 95, 98], [13, 14, 17, 20, 26,
        48, 57, 69, 71, 73], [15, 17, 29, 51, 53, 56, 62, 63, 79, 86]]),
}
SELECT_WINNERS = {
    "fedcs": (
        [[], [], []]),
    "fedcs --fedcs-deadline 2.5": (
        [[35, 40], [12, 35, 40, 49, 58, 83], [3, 35, 44, 49, 58, 60, 62]]),
    "longterm_auction": (
        [[1, 35, 40], [12, 35, 36, 41, 49, 58, 60, 63], [0, 1, 3, 19, 35,
        36, 44, 58, 62]]),
}
PAPER_SCHEMES = tuple(SCHEME_WINNERS)
# the selection path: --mode selection at a million clients
SELECTION_CLIENTS = 1_000_000
SELECTION_ARGS = ["--mode", "selection", "--clients", str(SELECTION_CLIENTS),
                  "--rounds", "100", "--quiet"]
SELECTION_CHECK_ROUNDS = 10
# (label, B, S, H, hd, dtype, causal, window); "qwen2" is the shape
# qwen2-0.5b's prefill of 4,096 tokens gives the kernel (14 heads after
# the GQA expansion), "window" starcoder2-3b's sliding window at 8,192
# tokens, "phi3v" phi-3-vision's head_dim 96 (32 heads) at 4,096 tokens,
# "ragged" a length off the 64-key tiles with head_dim 96 in fp32 (the
# CUDA-core instantiation), "hd28" qwen2-0.5b's smoke config (4 heads of
# head_dim 28, which the wrapper zero-pads to 32) at 2,048 tokens
FLASH_SHAPES = (
    ("qwen2", 1, 4096, 14, 64, torch.bfloat16, True, 0),
    ("window", 1, 8192, 24, 128, torch.bfloat16, True, 4096),
    ("phi3v", 1, 4096, 32, 96, torch.bfloat16, True, 0),
    ("ragged", 2, 1100, 3, 96, torch.float32, False, 0),
    ("hd28", 1, 2048, 4, 28, torch.bfloat16, True, 0),
)
# per-element bound against the plain version, |out - want| <= atol +
# rtol * |want|.  Both compute in fp32 and differ only in the order of
# the fp32 sums (about 1e-6 here, under atol = 1e-4); a bf16 output then
# rounds the two fp32 values to at most one bf16 unit apart, and one unit
# is at most 2^-7 of the value (7 stored mantissa bits), so rtol = 2^-7.
# Outputs are averages of unit-variance values over up to 8,192 keys
# (typically 0.02-0.05), so a key dropped from a row or a window edge one
# key off moves some element by more than this bound.
FLASH_TOL = {torch.bfloat16: (2.0 ** -7, 1e-4), torch.float32: (0.0, 1e-4)}
ARCH = "qwen2-0.5b"
PREFILL_LEN = 4096
DECODE_LEN = 1536          # > 1024, so logits_fn runs the kernel
# the bound tests/test_models.py holds decode to against the forward pass
LOGITS_REL_TOL = 2e-2
# the bound tests/test_sim.py holds every runtime's params to against the
# sequential runtime's
PARAMS_TOL = 1e-4
BATCHED_RUNTIMES = ("vectorized", "device")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def reset_counts(OPS) -> None:
    """Set every kernel wrapper's launch count to 0."""
    for name in ("lloyd_step", "kmeans_assign", "flash_attention"):
        getattr(OPS, name).launches = 0


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


def assign_bound(n, f, k, x_bytes):
    """Least time for one assign step: x and c read once, labels and
    distances written once, against the fp32 FMA work."""
    moved = n * f * x_bytes + k * f * 4 + n * 8
    ops = 2 * n * k * f + 2 * n * f + 2 * k * f
    t_bytes, t_ops = moved / PEAK_HBM_BYTES, ops / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_assign(OPS, dev, label, n, f, k, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, f, device=dev, generator=g).to(dtype)
    c = torch.randn(k, f, device=dev, generator=g)
    before = OPS.kmeans_assign.launches
    lab, dist = OPS.kmeans_assign(x, c)
    torch.cuda.synchronize()
    require(OPS.kmeans_assign.launches == before + 1,
            f"assign {label}: the wrapper did not count exactly one launch")
    lab_p, dist_p = OPS._kmeans_assign_torch(x, c)
    # the plain version's distances, from the same (bf16) x
    d = OPS.distances(x, c[None])[0]
    torch.cuda.synchronize()
    dist_err = (dist - dist_p).abs()
    require(bool((dist_err <= 1e-4 * dist_p.abs().clamp_min(1.0)).all()),
            f"assign {label}: dist beyond 1e-4 relative")
    best2 = d.topk(2, dim=1, largest=False).values
    clear = (best2[:, 1] - best2[:, 0]) > 1e-4 * best2[:, 0].abs()
    if dtype == torch.float32:
        require(torch.equal(lab[clear], lab_p[clear]),
                f"assign {label}: labels differ off near-ties")
        picked = torch.gather(d, 1, lab.long()[:, None])[:, 0]
        require(bool((picked - best2[:, 0]
                      <= 1e-4 * best2[:, 0].abs() + 1e-4).all()),
                f"assign {label}: a near-tie label is not nearest")
    again = OPS.kmeans_assign(x, c)
    require(torch.equal(lab, again[0]) and torch.equal(dist, again[1]),
            f"assign {label}: two runs differ")
    ms = median_ms(lambda: OPS.kmeans_assign(x, c))
    call_ms = median_ms(lambda: OPS.kmeans_assign(x, c), host_ahead=False)
    plain_ms = median_ms(lambda: OPS._kmeans_assign_torch(x, c))
    bound_ms, bound_by = assign_bound(n, f, k, x.element_size())
    err = float(dist_err.max())
    print(f"kmeans_assign[{label}] N={n} F={f} K={k} "
          f"{str(dtype).removeprefix('torch.')}: ms={ms!r} call_ms={call_ms!r} "
          f"plain_ms={plain_ms!r} bound_ms={bound_ms!r} ({bound_by}) "
          f"max_abs_err={err!r} near_tie_rows={int((~clear).sum())} "
          f"label_mismatches={int((lab != lab_p).sum())}", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": err}


def flash_pairs(sq, sk, causal, window):
    """(query, key) pairs the masks leave, which is the work this run's
    inputs need."""
    q = torch.arange(sq, dtype=torch.float64)
    hi = torch.clamp(q + 1, max=sk) if causal else torch.full_like(q, sk)
    lo = torch.clamp(q - window + 1, min=0) if window > 0 \
        else torch.zeros_like(q)
    return int(torch.clamp(hi - lo, min=0).sum())


def flash_ops(b, s, h, hd, causal, window):
    """The useful work: 4*hd flops per unmasked (query, key) pair per head
    (two products)."""
    return 4 * hd * b * h * flash_pairs(s, s, causal, window)


def flash_bound(b, s, h, hd, dtype, causal, window):
    """Least time: q, k, v read once and o written once, against
    4*hd flops per unmasked (query, key) pair per head (two products),
    on the bf16 tensor cores for bf16 and the fp32 CUDA cores for fp32."""
    esize = torch.tensor([], dtype=dtype).element_size()
    moved = 4 * b * s * h * hd * esize
    ops = flash_ops(b, s, h, hd, causal, window)
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    t_bytes, t_ops = moved / PEAK_HBM_BYTES, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def single_bf16_p(q, k, v, causal, window):
    """The plain version with p rounded once to bf16 before P.V (l summed
    from the fp32 p), in q's type: what a kernel with a single bf16 P
    computes, up to the order of its sums."""
    from repro_torch.kernels import ref as REF
    sq, sk, hd = q.shape[1], k.shape[1], q.shape[3]
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / hd ** 0.5
    mask = REF.attention_mask(torch.arange(sq, device=q.device),
                              torch.arange(sk, device=q.device),
                              causal=causal, window=window)
    sc = sc.masked_fill(~mask, -1e30)
    p = torch.exp(sc - sc.amax(-1, keepdim=True))
    l = p.sum(-1).transpose(1, 2)[..., None]
    p = p.bfloat16().float()
    return (torch.einsum("bhqk,bkhd->bqhd", p, v.float()) / l).to(q.dtype)


def check_flash(OPS, dev, label, b, s, h, hd, dtype, causal, window, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(b, s, h, hd, device=dev, generator=g).to(dtype)
               for _ in range(3))
    before = OPS.flash_attention.launches
    out = OPS.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    require(OPS.flash_attention.launches == before + 1,
            f"flash {label}: the wrapper did not count exactly one launch")
    want = OPS._flash_attention_torch(q, k, v, causal=causal, window=window)
    require(out.dtype == dtype and out.shape == q.shape,
            f"flash {label}: output {out.dtype} {tuple(out.shape)}")
    diff = (out.float() - want.float()).abs()
    err = float(diff.max())
    rtol, atol = FLASH_TOL[dtype]
    share = float((diff / (atol + rtol * want.float().abs())).max())
    require(share <= 1.0,
            f"flash {label}: error {err} (max abs) exceeds atol {atol} + "
            f"rtol {rtol} * |want| by a factor {share}")
    again = OPS.flash_attention(q, k, v, causal=causal, window=window)
    require(torch.equal(out, again), f"flash {label}: two runs differ")
    # the library yardstick, in its (B, H, S, hd) layout; the window
    # shape passes its mask as an explicit boolean attn_mask
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if window > 0:
        pos = torch.arange(s, device=dev)
        mask = (pos[None, :] <= pos[:, None]) & \
            (pos[None, :] > pos[:, None] - window)
        lib = lambda: sdpa(qt, kt, vt, attn_mask=mask)
    else:
        lib = lambda: sdpa(qt, kt, vt, is_causal=causal)
    # SDPA rounds p to bf16 once before P.V: its share of the same bound
    lib_diff = (lib().transpose(1, 2).float() - want.float()).abs()
    lib_err = float(lib_diff.max())
    lib_share = float((lib_diff / (atol + rtol * want.float().abs())).max())
    single = ""
    if dtype == torch.bfloat16:
        one_p = (single_bf16_p(q, k, v, causal, window).float()
                 - want.float()).abs()
        one_p_share = float((one_p / (atol + rtol * want.float().abs()))
                            .max())
        single = f" single_bf16_p_share_of_bound={one_p_share!r}"
        del one_p
    ms = median_ms(lambda: OPS.flash_attention(q, k, v, causal=causal,
                                               window=window))
    plain_ms = median_ms(lambda: OPS._flash_attention_torch(
        q, k, v, causal=causal, window=window))
    library_ms = median_ms(lib)
    bound_ms, bound_by = flash_bound(b, s, h, hd, dtype, causal, window)
    tflop_s = flash_ops(b, s, h, hd, causal, window) / (ms * 1e-3) / 1e12
    print(f"flash_attention[{label}] B={b} S={s} H={h} hd={hd} "
          f"{str(dtype).removeprefix('torch.')} causal={causal} "
          f"window={window}: ms={ms!r} plain_ms={plain_ms!r} "
          f"library_ms={library_ms!r} bound_ms={bound_ms!r} ({bound_by}) "
          f"tflop_s={tflop_s!r} max_abs_err={err!r} share_of_bound={share!r} "
          f"library_max_abs_err={lib_err!r} "
          f"library_share_of_bound={lib_share!r}{single}", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err}


def serving_path(OPS, cuda) -> int:
    """qwen2-0.5b at full width on the card: prefill through the kernel
    against the plain path, decode against the kernel prefill, serve.
    Returns the prefill's flash_attention launches."""
    from repro_torch import rng
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import model as MD

    cfg = get_config(ARCH).replace(attn_impl="pallas")
    t = time.perf_counter()
    params = MD.init_params(cfg, rng.PRNGKey(0), cuda)
    torch.cuda.synchronize()
    print(f"serving: {cfg.name} {cfg.num_layers} layers d_model="
          f"{cfg.d_model} {cfg.dtype}: init_params "
          f"{time.perf_counter() - t!r} s", flush=True)

    # ---- prefill: logits_fn through the kernel, counts reset ----------
    toks = rng.randint(rng.PRNGKey(1), (1, PREFILL_LEN), 0, cfg.vocab_size,
                       cuda)
    reset_counts(OPS)
    t = time.perf_counter()
    logits = MD.logits_fn(cfg, params, toks)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    launches = OPS.flash_attention.launches
    require(launches == cfg.num_layers,
            f"prefill made {launches} flash_attention launches, expected "
            f"{cfg.num_layers}")
    require(OPS.lloyd_step.launches == OPS.kmeans_assign.launches == 0,
            "prefill launched a k-means kernel")
    t = time.perf_counter()
    MD.logits_fn(cfg, params, toks)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t
    require(tuple(logits.shape) == (1, PREFILL_LEN, cfg.vocab_size)
            and bool(torch.isfinite(logits).all()),
            "prefill logits not finite or of the wrong shape")
    plain = MD.logits_fn(cfg.replace(attn_impl="naive"), params, toks)
    scale = plain.float().abs().max()
    rel = float((logits.float() - plain.float()).abs().max() / scale)
    # yardstick: the two plain paths differ by their fp32 sum order alone
    chunked = MD.logits_fn(cfg.replace(attn_impl="chunked"), params, toks)
    rel_chunked = float((chunked.float() - plain.float()).abs().max()
                        / scale)
    rel_k_chunked = float((logits.float() - chunked.float()).abs().max()
                          / scale)
    print(f"prefill: S={PREFILL_LEN} flash_attention launches={launches} "
          f"wall_s first={first_s!r} warm={warm_s!r} tokens_per_s="
          f"{PREFILL_LEN / warm_s!r} rel_err_vs_naive={rel!r} "
          f"(chunked vs naive: {rel_chunked!r}, kernel vs chunked: "
          f"{rel_k_chunked!r})", flush=True)
    require(rel < LOGITS_REL_TOL,
            f"kernel prefill vs naive: {rel} >= {LOGITS_REL_TOL}")
    del logits, plain, chunked

    # ---- teacher-forced decode against the kernel prefill -------------
    toks = rng.randint(rng.PRNGKey(2), (1, DECODE_LEN), 0, cfg.vocab_size,
                       cuda)
    before = OPS.flash_attention.launches
    full = MD.logits_fn(cfg, params, toks)[0].float()       # (S, V)
    require(OPS.flash_attention.launches == before + cfg.num_layers,
            "the decode reference prefill did not run the kernel")
    state = MD.init_decode_state(cfg, 1, DECODE_LEN, cuda)
    dmax = torch.zeros((), device=cuda)
    t = time.perf_counter()
    for p in range(DECODE_LEN):
        lg, state = MD.decode_step(cfg, params, state, toks[:, p], p)
        dmax = torch.maximum(dmax, (lg[0] - full[p]).abs().max())
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t
    rel = float(dmax / full.abs().max())
    print(f"decode: {DECODE_LEN} teacher-forced steps in {dec_s!r} s "
          f"({DECODE_LEN / dec_s!r} steps/s), rel_err_vs_kernel_prefill="
          f"{rel!r}", flush=True)
    require(rel < LOGITS_REL_TOL,
            f"decode vs kernel prefill: {rel} >= {LOGITS_REL_TOL}")
    del full, state

    # ---- serve 4 x 32 tokens; replay to check the ids -----------------
    batch, prompt_len, gen = 4, 16, 32
    out = serve(cfg, params, batch, prompt_len, gen, cuda)
    ids = out["tokens"]
    require(tuple(ids.shape) == (batch, gen), f"served {tuple(ids.shape)}")
    seq = torch.cat([out["prompts"], ids.long()], dim=1)
    state = MD.init_decode_state(cfg, batch, prompt_len + gen, cuda)
    for p in range(prompt_len + gen - 1):
        lg, state = MD.decode_step(cfg, params, state, seq[:, p], p)
        if p >= prompt_len - 1:
            got = lg.gather(1, seq[:, p + 1:p + 2])[:, 0]
            require(bool((got == lg.max(dim=1).values).all()),
                    f"served id at position {p + 1} is not the argmax of "
                    "its logits")
    print(f"serve: batch={batch} prompt_len={prompt_len} gen={gen} "
          f"prefill_s={out['prefill_s']!r} decode_s={out['decode_s']!r} "
          f"tokens_per_s={batch * gen / out['decode_s']!r} "
          f"ids[0,:16]={ids[0, :16].tolist()}", flush=True)
    return launches


def _kernel_rows(prof):
    cuda_t = torch.autograd.DeviceType.CUDA
    return sorted((e for e in prof.key_averages()
                   if e.device_type == cuda_t),
                  key=lambda e: -e.self_device_time_total)


def profile_serving(cuda) -> None:
    """Device time by kernel and the busy share of the wall time for one
    warm prefill of PREFILL_LEN tokens and for 32 decode steps of a
    batch of 4 (torch.profiler, CUPTI)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import rng
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import model as MD

    cfg = get_config(ARCH).replace(attn_impl="pallas")
    params = MD.init_params(cfg, rng.PRNGKey(0), cuda)
    toks = rng.randint(rng.PRNGKey(1), (1, PREFILL_LEN), 0, cfg.vocab_size,
                       cuda)
    step = make_serve_step(cfg)
    MD.logits_fn(cfg, params, toks)

    def decode():
        state = MD.init_decode_state(cfg, 4, 48, cuda)
        tok = toks[0, :4]
        for p in range(32):
            tok, state = step(params, state, tok, p)

    decode()
    for name, fn in (("prefill", lambda: MD.logits_fn(cfg, params, toks)),
                     ("decode x32", decode)):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t
        rows = _kernel_rows(prof)
        busy = sum(e.self_device_time_total for e in rows) / 1e6
        print(f"profile serving {name}: wall_s={wall!r} "
              f"device_busy_s={busy!r} busy_share={busy / wall!r} "
              f"kernel_launches={sum(e.count for e in rows)}", flush=True)
        for e in rows[:8]:
            print(f"  {e.key[:60]} count={e.count} "
                  f"device_ms={e.self_device_time_total / 1e3!r}",
                  flush=True)


def profile_selection() -> None:
    """Device time by kernel, kernel launches a round and the busy share
    of 20 warm rounds of the selection loop at SELECTION_CLIENTS under
    each --scheme-select (torch.profiler, CUPTI)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import rng
    from repro_torch.configs.base import FLConfig
    from repro_torch.core import rounds as RND

    for select in ("paper", "random", "fedcs", "longterm_auction"):
        cfg = FLConfig(num_clients=SELECTION_CLIENTS, scheme_select=select,
                       init_energy_mode="normal")
        state = RND.synthetic_fleet(cfg, rng.PRNGKey(0), device="cuda")
        RND.simulate_rounds(state, cfg, rng.PRNGKey(1), 5)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            RND.simulate_rounds(state, cfg, rng.PRNGKey(1), 20)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rows = _kernel_rows(prof)
        busy = sum(e.self_device_time_total for e in rows) / 1e6
        print(f"profile selection {select} N={SELECTION_CLIENTS} 20 rounds: "
              f"wall_s={wall!r} device_busy_s={busy!r} "
              f"busy_share={busy / wall!r} launches_per_round="
              f"{sum(e.count for e in rows) / 20!r}", flush=True)
        for e in rows[:6]:
            print(f"  {e.key[:60]} count={e.count} "
                  f"device_ms={e.self_device_time_total / 1e3!r}",
                  flush=True)


def profile_pass(OPS, TRAIN) -> None:
    """Device time by kernel (torch.profiler, CUPTI) for the fleet-shape
    Lloyd step and for a main-path run; the busy share is the summed
    kernel time over the run's wall time (with the profiler's own host
    overhead in the wall time)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(100_000, 256, device="cuda", generator=g)
    c = torch.randn(4, 10, 256, device="cuda", generator=g)
    OPS.lloyd_step(x, c)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        for _ in range(10):
            OPS.lloyd_step(x, c)
        torch.cuda.synchronize()
    for e in _kernel_rows(prof):
        print(f"profile fleet lloyd_step: {e.key[:60]} count={e.count} "
              f"device_us_per_call={e.self_device_time_total / e.count!r}",
              flush=True)
    for runtime in ("sequential", "vectorized"):
        t0 = time.perf_counter()
        with profile(activities=acts) as prof:
            TRAIN.main(MAIN_ARGS + ["--runtime", runtime])
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rows = _kernel_rows(prof)
        busy = sum(e.self_device_time_total for e in rows) / 1e6
        print(f"profile main path ({runtime}): wall_s={wall!r} "
              f"device_busy_s={busy!r} busy_share={busy / wall!r} "
              f"kernels={len(rows)}", flush=True)
        for e in rows[:12]:
            print(f"  {e.key[:60]} count={e.count} "
                  f"device_ms={e.self_device_time_total / 1e3!r}",
                  flush=True)


def record_servers(TRAIN):
    """Make ``TRAIN.main`` keep every FederatedServer it builds (for the
    final params and the runtime's engine); returns the list."""
    servers = []

    class Recording(TRAIN.FederatedServer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            servers.append(self)

    TRAIN.FederatedServer = Recording
    return servers


def runtime_seconds(name, result, spans):
    """The paper path's end-to-end seconds of one run from its spans."""
    stage1 = spans["run/cluster"]
    warmup = spans.get("run/warmup", 0.0)
    rounds = len(result["rounds"])
    print(f"runtime {name}: stage1_s={stage1!r} "
          f"features_s={spans['cluster/features']!r} "
          f"project_s={spans['cluster/project']!r} "
          f"kmeans_s={spans['cluster/kmeans']!r} warmup_s={warmup!r} "
          f"s_per_round={(result['wall_s'] - stage1 - warmup) / rounds!r} "
          f"round_train_s={spans['round/train']!r}", flush=True)


def max_param_diff(a, b) -> float:
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


def cohort_runtimes_path(OPS, TRAIN, obs, servers, seq_params):
    """The paper path on the batched runtimes, each held to the winners
    and to the sequential cuda run's final params.  Returns the
    vectorized run's server."""
    # torch.func.grad imports torch._dynamo at its first call, once a
    # process: timed here on its own, so the runs' spans hold their work
    t = time.perf_counter()
    importlib.import_module("torch._dynamo")
    print(f"first-use import of torch._dynamo (torch.func.grad): "
          f"{time.perf_counter() - t!r} s", flush=True)
    got = {}
    for runtime in BATCHED_RUNTIMES:
        reset_counts(OPS)
        obs.SPANS.clear()
        result = TRAIN.main(MAIN_ARGS + ["--runtime", runtime])
        torch.cuda.synchronize()
        launches = OPS.lloyd_step.launches
        srv = servers[-1]
        require(srv.runtime.name == runtime,
                f"--runtime {runtime} built a {srv.runtime.name} runtime")
        require(launches == 26, f"{runtime}: stage 1 made {launches} "
                "lloyd_step launches, expected 26")
        require(OPS.kmeans_assign.launches == OPS.flash_attention.launches
                == 0, f"{runtime}: launched a kernel it does not use")
        require(result["selected"] == REFERENCE_WINNERS,
                f"{runtime}: rounds selected {result['selected']}, the JAX "
                f"package selects {REFERENCE_WINNERS}")
        require(result["params_finite"], f"{runtime}: non-finite params")
        diff = max_param_diff(srv.params, seq_params)
        require(diff < PARAMS_TOL, f"{runtime}: final params differ from "
                f"the sequential run's by {diff} >= {PARAMS_TOL}")
        stats = srv.runtime.engine.stats
        extra = ""
        if runtime == "device":
            # warm-up notes one miss per (class, tier); the rounds none
            shapes = sum(len(c.tiers) for c in srv.runtime.store.classes)
            require(stats["shape_misses"] == shapes,
                    f"device: {stats['shape_misses']} shape misses, the "
                    f"warm-up met {shapes} shapes: the rounds met new ones")
            extra = (f" classes={len(srv.runtime.store.classes)} "
                     f"warmup_shapes={shapes}")
        print(f"cohort runtime {runtime}: lloyd_step launches={launches} "
              f"selected=REFERENCE_WINNERS max_abs_dparams_vs_sequential="
              f"{diff!r} shape_hits={stats['shape_hits']} "
              f"shape_misses={stats['shape_misses']}{extra}", flush=True)
        got[runtime] = (result, dict(obs.SPANS), srv)
    for runtime, (result, spans, _) in got.items():
        runtime_seconds(runtime, result, spans)
    return got["vectorized"][2]


def feature_pass_widths(runtime, params) -> None:
    """The stage-1 gradient pass over the whole client axis at once (the
    port's design) against ``cohort_vmap_width``-wide chunks (the JAX
    engine's CPU layout): both times with the host's enqueue work, the
    whole-axis peak memory, and their agreement."""
    from repro_torch import rng
    xb, yb = runtime._gather_gradient_windows(rng.PRNGKey(0))
    eng, w = runtime.engine, runtime.cfg.cohort_vmap_width

    def whole():
        return eng.gradient_features(params, xb, yb)

    def chunked():
        return torch.cat([eng.gradient_features(params, xb[i:i + w],
                                                yb[i:i + w])
                          for i in range(0, xb.shape[0], w)])

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    full = whole()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    diff = float((full - chunked()).abs().max())
    require(diff < PARAMS_TOL, f"feature pass: chunks differ by {diff}")
    ms_whole = median_ms(whole, reps=10, host_ahead=False)
    ms_chunked = median_ms(chunked, reps=10, host_ahead=False)
    print(f"feature pass N={xb.shape[0]} T0={xb.shape[1]} "
          f"window={xb.shape[2]}: whole_axis_ms={ms_whole!r} "
          f"chunks_of_{w}_ms={ms_chunked!r} whole_axis_peak_bytes={peak} "
          f"max_abs_diff={diff!r}", flush=True)


def scheme_comparison_path(OPS, TRAIN, obs, servers) -> None:
    """The paper's four schemes for 30 rounds on the vectorized runtime,
    the sequential weight-feature loop against the batched pass, and the
    registry's fedcs and longterm_auction, each held to the JAX
    package's winners."""
    require(SCHEME_WINNERS["gradient_cluster_auction"][:3]
            == REFERENCE_WINNERS, "SCHEME_WINNERS disagrees with "
            "REFERENCE_WINNERS")
    clusters = {}
    for scheme in PAPER_SCHEMES:
        reset_counts(OPS)
        obs.SPANS.clear()
        result = TRAIN.main(["--quiet", "--runtime", "vectorized",
                             "--scheme", scheme])
        torch.cuda.synchronize()
        launches = OPS.lloyd_step.launches
        want = 0 if scheme == "random" else 26
        require(launches == want, f"{scheme}: stage 1 made {launches} "
                f"lloyd_step launches, expected {want}")
        require(OPS.kmeans_assign.launches == OPS.flash_attention.launches
                == 0, f"{scheme}: launched a kernel it does not use")
        require(len(result["selected"]) == 30, f"{scheme}: not 30 rounds")
        bad = [t for t, (a, b) in enumerate(zip(result["selected"],
                                                SCHEME_WINNERS[scheme]))
               if a != b]
        require(not bad, f"{scheme}: rounds {bad} select "
                f"{[result['selected'][t] for t in bad[:3]]}, the JAX "
                f"package selects "
                f"{[SCHEME_WINNERS[scheme][t] for t in bad[:3]]}")
        require(result["params_finite"] and all(
            math.isfinite(a) for a in result["test_acc"]),
            f"{scheme}: non-finite params or accuracy")
        clusters[scheme] = servers[-1].state.clusters.clone()
        stage1 = obs.SPANS["run/cluster"]
        feats = obs.SPANS.get("cluster/features", 0.0)
        print(f"scheme {scheme} (vectorized, 30 rounds): lloyd_step "
              f"launches={launches} selected=SCHEME_WINNERS "
              f"stage1_s={stage1!r} features_s={feats!r} "
              f"s_per_round={(result['wall_s'] - stage1) / 30!r} "
              f"final_test_acc={result['test_acc'][-1]!r} "
              f"final_energy_std={result['energy_std'][-1]!r} "
              f"mean_vds_gap={statistics.fmean(result['vds_gap'])!r}",
              flush=True)
    # the per-client weight-delta loop against the batched pass
    reset_counts(OPS)
    obs.SPANS.clear()
    result = TRAIN.main(["--quiet", "--rounds", "3", "--scheme",
                         "weights_cluster_random"])
    torch.cuda.synchronize()
    srv = servers[-1]
    require(srv.runtime.name == "sequential", "not the sequential runtime")
    require(OPS.lloyd_step.launches == 26,
            f"sequential weights: {OPS.lloyd_step.launches} launches")
    require(torch.equal(srv.state.clusters,
                        clusters["weights_cluster_random"]),
            "the sequential weight-feature loop and the batched pass give "
            "other clusters")
    require(result["selected"] == SCHEME_WINNERS["weights_cluster_random"]
            [:3], f"sequential weights: selected {result['selected']}")
    print(f"scheme weights_cluster_random (sequential, 3 rounds): "
          f"clusters equal the batched pass's, stage1_s="
          f"{obs.SPANS['run/cluster']!r} features_s="
          f"{obs.SPANS['cluster/features']!r}", flush=True)
    for select, want in SELECT_WINNERS.items():
        reset_counts(OPS)
        obs.SPANS.clear()
        result = TRAIN.main(["--quiet", "--rounds", "3", "--runtime",
                             "vectorized", "--scheme-select",
                             *select.split()])
        torch.cuda.synchronize()
        require(OPS.lloyd_step.launches == 26,
                f"{select}: {OPS.lloyd_step.launches} launches")
        require(result["selected"] == want, f"--scheme-select {select}: "
                f"selected {result['selected']}, the JAX package {want}")
        metrics = servers[-1].logs[-1].scheme_metrics
        print(f"scheme-select {select} (vectorized, 3 rounds): selected="
              f"SELECT_WINNERS s_per_round="
              f"{(result['wall_s'] - obs.SPANS['run/cluster']) / 3!r} "
              f"last round {metrics}", flush=True)


def selection_path(OPS, TRAIN, cuda) -> None:
    """``--mode selection`` at a million clients for every scheme: the
    CLI's rates, the loop bit for bit against its per-round reference,
    and the loop with no host synchronisation."""
    import numpy as np

    from repro_torch import rng
    from repro_torch.configs.base import FLConfig
    from repro_torch.core import rounds as RND

    cases = [("gradient_cluster_auction", s) for s in
             ("paper", "random", "fedcs", "longterm_auction")]
    cases += [(s, "paper") for s in PAPER_SCHEMES[1:]]
    for scheme, select in cases:
        cli = scheme == "gradient_cluster_auction"
        if cli:
            reset_counts(OPS)
            out = TRAIN.main(SELECTION_ARGS + ["--scheme-select", select])
            require(OPS.lloyd_step.launches == OPS.kmeans_assign.launches
                    == OPS.flash_attention.launches == 0,
                    "the selection path launched a kernel")
            require(len(out["num_winners"]) == 100
                    and all(math.isfinite(v) for v in out["energy_std"])
                    and sum(out["num_winners"]) > 0,
                    f"selection {select}: bad output")
        cfg = FLConfig(num_clients=SELECTION_CLIENTS, scheme=scheme,
                       scheme_select=select, init_energy_mode="normal")
        key = rng.PRNGKey(0)
        state = RND.synthetic_fleet(cfg, key, device=cuda)
        kr = rng.fold_in(key, 1)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fs, m, wins = RND.simulate_rounds(state, cfg, kr,
                                              SELECTION_CHECK_ROUNDS,
                                              record_wins=True)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        rf, rm, rwins = RND.simulate_rounds_reference(
            state, cfg, kr, SELECTION_CHECK_ROUNDS, record_wins=True)
        name = f"{scheme}/{select}"
        require(np.array_equal(wins.cpu().numpy(), rwins),
                f"selection {name}: winners differ from the reference")
        require(torch.equal(fs.residual, rf.residual)
                and torch.equal(fs.history, rf.history),
                f"selection {name}: residual or history differ")
        require(sorted(m) == sorted(rm) and all(
            np.array_equal(m[k].cpu().numpy(), rm[k]) for k in m),
            f"selection {name}: metrics differ from the reference")
        line = (f"selection {name} N={SELECTION_CLIENTS}: "
                f"T={SELECTION_CHECK_ROUNDS} "
                f"bit-identical to the reference, no host sync, "
                f"winners={int(wins.sum())}")
        if cli:
            torch.cuda.synchronize()
            t = time.perf_counter()
            torch.cuda.set_sync_debug_mode("error")
            try:
                RND.simulate_rounds(state, cfg, kr, 100)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            line += (f"; CLI T=100 warm rounds_per_s={out['rounds_per_s']!r}"
                     f" cold rounds_per_s={100 / out['wall_s']!r} "
                     f"compile_s={out['compile_s']!r}; 100 rounds under "
                     f"the sync check {time.perf_counter() - t!r} s "
                     f"final_energy_std={out['energy_std'][-1]!r}")
        print(line, flush=True)


def toolkit(BUILD, name: str) -> str:
    """A program of the CUDA toolkit whose nvcc builds the kernels."""
    tool = Path(BUILD._nvcc()).parent / name
    require(tool.exists(), f"{name} not found beside nvcc ({tool})")
    return str(tool)


def demangle(BUILD, names):
    """{mangled: demangled without parameter types} by cu++filt."""
    names = sorted(set(names))
    out = subprocess.run([toolkit(BUILD, "cu++filt"), "-p"],
                         input="\n".join(names) + "\n", capture_output=True,
                         text=True, timeout=60)
    require(out.returncode == 0, f"cu++filt failed: {out.stderr}")
    plain = out.stdout.splitlines()
    require(len(plain) == len(names), "cu++filt gave back another count")
    return dict(zip(names, plain))


def ptxas_summary(BUILD, log: str):
    """'kernel: R registers, spill S/L B' for each kernel of a -Xptxas -v
    report."""
    found = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            found.append(m.group(1))
    names = demangle(BUILD, found)
    rows, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spill = names[m.group(1)], ""
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spill = f"spill {m.group(1)}/{m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append(f"{name}: {m.group(1)} registers, {spill}")
            name = None
    return rows


def sass_mma_counts(BUILD, lib_path):
    """{mangled kernel name: number of HMMA (tensor-core) instructions} in
    a built library's SASS, by cuobjdump."""
    out = subprocess.run([toolkit(BUILD, "cuobjdump"), "-sass",
                          str(lib_path)], capture_output=True, text=True,
                         timeout=300)
    require(out.returncode == 0, f"cuobjdump failed: {out.stderr}")
    counts, fn = {}, None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and "HMMA" in line:
            counts[fn] += 1
    return counts


def phase(name: str, t0: float) -> None:
    print(f"[{time.perf_counter() - t0:.1f} s] {name}", flush=True)


def main() -> int:
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import obs
    from repro_torch.kernels import build as BUILD
    from repro_torch.kernels import flash_attention as FA
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

    libs = (KM.LIBRARY, FA.LIBRARY)
    t = time.perf_counter()
    BUILD.build(*libs)
    print(f"built {', '.join(lib.source.name for lib in libs)} in "
          f"{time.perf_counter() - t:.1f} s (each: "
          f"{', '.join(f'{lib.build_s:.1f} s' for lib in libs)})",
          flush=True)
    for lib in libs:         # ptxas's registers and spills per kernel
        print(f"ptxas {lib.source.name}: "
              + "; ".join(ptxas_summary(BUILD, lib.log)), flush=True)
    hmma = sass_mma_counts(BUILD, FA.LIBRARY.path())
    names = demangle(BUILD, hmma)
    print("HMMA instructions in the SASS of flash_attention.cu: "
          + "; ".join(f"{names[fn]}={n}" for fn, n in sorted(hmma.items())),
          flush=True)
    mma_fns = [fn for fn in hmma if "flash_fwd_mma" in fn]
    require(bool(mma_fns) and all(hmma[fn] > 0 for fn in mma_fns),
            f"the bf16 instantiations do not all run HMMA: {hmma}")

    cuda = torch.device("cuda")

    # ---- kernel phases -------------------------------------------------
    phase("kernel phase: lloyd_step", t0)
    shapes = {label: check_lloyd(OPS, cuda, label, n, f, k, r, dt, seed)
              for label, n, f, k, r, dt, seed in KERNEL_SHAPES}
    phase("kernel phase: kmeans_assign", t0)
    assign = {label: check_assign(OPS, cuda, label, n, f, k, dt, seed)
              for label, n, f, k, _, dt, seed in KERNEL_SHAPES}
    phase("kernel phase: flash_attention", t0)
    flash = {label: check_flash(OPS, cuda, label, *shape, seed)
             for seed, (label, *shape) in enumerate(FLASH_SHAPES)}

    # ---- main path -----------------------------------------------------
    phase("paper path", t0)
    servers = record_servers(TRAIN)
    reset_counts(OPS)
    obs.SPANS.clear()
    result = TRAIN.main(MAIN_ARGS)
    torch.cuda.synchronize()
    launches = OPS.lloyd_step.launches
    seq_spans, seq_params = dict(obs.SPANS), servers[-1].params
    require(OPS.kmeans_assign.launches == OPS.flash_attention.launches == 0,
            "the paper path launched a kernel it does not use")
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

    # ---- stage-1 assign path ------------------------------------------
    phase("stage-1 assign path", t0)
    reset_counts(OPS)
    obs.SPANS.clear()
    hooked = TRAIN.main(MAIN_ARGS,
                        assign_fn=lambda x, c: OPS.kmeans_assign(x, c)[0])
    torch.cuda.synchronize()
    assign_launches = OPS.kmeans_assign.launches
    print(f"assign path: stage1_s={obs.SPANS['run/cluster']!r} "
          f"kmeans_s={obs.SPANS['cluster/kmeans']!r} "
          f"kmeans_assign launches={assign_launches} selected="
          f"{hooked['selected']}", flush=True)
    require(assign_launches == 26 * 4,
            f"stage 1 made {assign_launches} kmeans_assign launches, "
            "expected 104 (26 per restart, 4 restarts)")
    require(OPS.lloyd_step.launches == OPS.flash_attention.launches == 0,
            "the assign path launched a kernel it does not use")
    require(hooked["selected"] == REFERENCE_WINNERS,
            f"with the assign hook the rounds selected {hooked['selected']}")

    # ---- cohort runtimes path ------------------------------------------
    phase("cohort runtimes path", t0)
    runtime_seconds("sequential", result, seq_spans)
    vec = cohort_runtimes_path(OPS, TRAIN, obs, servers, seq_params)
    feature_pass_widths(vec.runtime, vec.params)

    # ---- scheme comparison path -----------------------------------------
    phase("scheme comparison path", t0)
    scheme_comparison_path(OPS, TRAIN, obs, servers)

    # ---- selection path -------------------------------------------------
    phase("selection path", t0)
    selection_path(OPS, TRAIN, cuda)

    # ---- serving path --------------------------------------------------
    phase("serving path", t0)
    flash_launches = serving_path(OPS, cuda)

    if "--profile" in sys.argv[1:]:
        phase("profile", t0)
        profile_pass(OPS, TRAIN)
        profile_selection()
        profile_serving(cuda)

    phase("done", t0)

    def row(name, source, replaces, n, m, library_ms):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n,
                "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                "bound_by": m["bound_by"], "library_ms": library_ms}

    print(json.dumps({"kernels": [
        row("lloyd_step", "src/repro_torch/csrc/kmeans.cu",
            "src/repro/kernels/kmeans.py:144", launches, shapes["main"],
            None),
        row("kmeans_assign", "src/repro_torch/csrc/kmeans.cu",
            "src/repro/kernels/kmeans.py:109", assign_launches,
            assign["main"], None),
        row("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:81", flash_launches,
            flash["qwen2"], flash["qwen2"]["library_ms"])]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
