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
9. Dynamics path: the faulty fleets of the reference's fleet_dynamics
   benchmark (``--churn 0.1`` and ``0.3`` with ``--deadline 1.5
   --aggregation buffered``) and the same run at churn 0, at the
   reference defaults for 30 rounds on ``--runtime vectorized`` with
   ``--log-jsonl``, counts reset before and read after each (26
   ``lloyd_step`` launches): every round's winners and outcome codes
   held to the JAX package's (DYN_WINNERS), each log valid under the
   schema with 30 rounds and, faulty, at least one ``buffer/fold``;
   seconds per round at each churn.  Then 3 rounds at churn 0.25 on the
   ``sequential``, ``vectorized`` and ``device`` runtimes (the same
   selections and outcomes, params within 1e-4, round 2 under
   ``--audit-sync``); churn 0 with buffered
   aggregation (REFERENCE_WINNERS); a 6-round run checkpointed at round 3
   and a second server resumed from it, with and without dynamics
   (rounds 3-5 and params bit-identical, no ``lloyd_step`` launch in the
   resumed leg; save and restore seconds); ``--audit-sync`` (warm rounds
   under ``set_sync_debug_mode("error")``) and four more audited rounds
   with the counted transfers per round; ``--profile-dir`` (a trace).
10. Robust path: the reference benchmark's robust_agg and self_healing
   fleets (ROBUST_CELLS: 32 clients, 4 clusters, 60 rounds on ``--runtime
   device``, clean and selfheal 100; undefended and ``trimmed`` FedAvg
   under a 30 % ``scale`` attack, clean, clean with the watchdog, the
   static clip and the self-healing stack (adaptive band, priced
   reputation, watchdog) under ``sub_clip``) and a 4-round NaN storm that
   the watchdog rolls back, each built as ``FederatedServer`` with its
   launch counts reset before and read after (26 ``lloyd_step``
   launches): winners, per-round quarantine and band counts, bans,
   rollbacks and final accuracy held to the JAX package's
   (ROBUST_REFERENCE, bit for bit wherever the JAX package's own
   runtimes agree); where they drift apart (selfheal from round 12), the
   ban count and screened total held to the range of the JAX package's
   runs under float drift (ROBUST_DRIFT) and single rounds from the JAX
   package's own states held to its decisions exactly (ROBUST_ANCHORS);
   the trimmed cell's first screened steps held to the CPU's on the same
   inputs and far from undefended FedAvg's; the self-healing and
   NaN-storm logs valid under the schema, undefended FedAvg far below
   clean, selfheal within 0.05 of clean at 100 rounds; the self-healing
   run's warm rounds under ``--audit-sync`` on ``device`` (and 60 rounds
   on ``vectorized``), its resume from the round-30 snapshot
   bit-identical with no launch; the warm seconds per round with the
   counted transfers, the defended overhead against clean, and the
   screened step's device ms per defense.
11. Selection path: ``--mode selection --clients 1000000 --rounds 100``
   for each ``--scheme-select`` value (warm and cold rounds/s); then, for
   those four and the three baseline ``--scheme`` values,
   ``simulate_rounds`` at N = 1,000,000 and T = 10 with ``record_wins``
   under ``torch.cuda.set_sync_debug_mode("error")`` (a host
   synchronisation in the loop raises) held bit for bit to
   ``simulate_rounds_reference`` (winners, residual, history, metrics),
   and a warm 100-round ``simulate_rounds`` of each ``--scheme-select``
   under the same mode.
12. Serving path at full width: qwen2-0.5b (24 layers, bf16, weights
   from ``init_params(cfg, PRNGKey(0))``) with ``attn_impl="pallas"``:
   ``logits_fn`` prefill of 4,096 tokens, counts reset before and read
   after (24 flash_attention launches), held against the plain
   ``attn_impl="naive"`` path; teacher-forced ``decode_step`` over 1,536
   tokens held against the kernel prefill; and ``serve`` of 4 x 32
   tokens, whose ids must be the argmax of the logits that made them.
13. Transformer path (run before the selection path): ``--mode
   transformer`` at the CLI defaults (each arch's smoke config, 20 FL
   clients, 5 clusters, seed 0): qwen2-0.5b for 30 rounds on
   ``sequential``, ``vectorized`` and ``device``, and qwen1.5-4b,
   qwen1.5-32b, starcoder2-3b and phi-3-vision-4.2b for 3 rounds on
   ``sequential``, counts reset before and read after each run (26
   ``lloyd_step`` launches), each held to the JAX package's stage-1
   labels and winners in every round and to its test loss, accuracy and
   energy std within TF_LOSS_TOL / TF_ACC_TOL (TRANSFORMER_REFERENCE,
   written by tools/record_transformer_reference.py); stage-1 seconds,
   seconds per round and the ``cohort/train`` share per run.
14. Full-width train step (after the serving path): ``make_train_step``
   on qwen2-0.5b's full CONFIG (24 layers, bf16, remat, chunked
   attention) at B 2, S 4,096 for 3 SGD steps at lr 1e-3 on one seeded
   batch: the loss finite and falling; s a step, tokens/s,
   ``max_memory_allocated`` and the device-busy share of one profiled
   step.  Autograd through ``attn_impl="pallas"`` must raise.  Then
   ``chunked_attention``'s backward at (1, 4,096, 14, 64), causal, fp32,
   against autograd through the naive attention (ATTN_BWD_TOL), and
   ``chunked_softmax_xent``'s value and grads at (2, 4,096, 151,936)
   against the direct fp32 log-softmax (XENT_VALUE_TOL, XENT_GRAD_TOL).

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

import dataclasses
import importlib
import json
import math
import re
import shutil
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
    # stage 1 of the robust path: 32 clients, 4 clusters
    ("robust", 32, 256, 4, 4, torch.float32, 4),
    # stage 1 of --mode transformer: 20 clients, 5 clusters
    ("transformer", 20, 256, 5, 4, torch.float32, 5),
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
# The faulty fleets of the reference's fleet_dynamics benchmark
# (benchmarks/run.py: churn 0.1 and 0.3, deadline 1.5, buffered
# aggregation) at the reference defaults for the paper's 30 rounds: the
# clients the JAX package selects each round and the outcome code of each
# (1 completed, 2 late, 3 dropped): the RoundLogs' ``selected`` and the
# ``outcome_log`` of the FederatedServer that python -m
# repro.launch.train --mode paper --runtime sequential --churn <c>
# --deadline 1.5 --aggregation buffered builds, run on the CPU.  They depend on the clusters,
# energy, history, the dynamics key chain and the replacement draws,
# never on the trained params.
DYN_FLAGS = ["--deadline", "1.5", "--aggregation", "buffered"]
DYN_WINNERS = {
    ("0.1", "selected"): (
        [[1, 35, 40], [12, 35, 36, 41, 49, 58, 60, 83], [0, 1, 3,
        19, 35, 36, 44, 58, 62], [6, 24, 31, 57, 63, 72, 79, 80, 85,
        98], [18, 21, 35, 36, 39, 43, 52, 64, 67, 90], [5, 6, 9, 21,
        32, 37, 44, 53, 70, 98], [3, 5, 11, 20, 28, 56, 67, 84, 92,
        99], [2, 11, 25, 27, 29, 30, 48, 54, 56, 93], [12, 25, 37,
        40, 41, 49, 63, 64, 78], [7, 21, 24, 72, 73, 80, 85, 86, 88,
        89], [20, 23, 38, 51, 57, 62, 75, 79, 84, 96], [9, 17, 22,
        31, 34, 46, 53, 60, 65, 68], [1, 15, 18, 26, 27, 32, 54, 70,
        83, 99], [23, 45, 48, 50, 61, 66, 69, 74, 82, 97], [4, 13,
        29, 42, 47, 50, 76, 78, 91, 95], [8, 10, 14, 16, 33, 55, 59,
        71, 77, 82], [19, 22, 24, 28, 30, 51, 75, 86, 93, 97], [17,
        34, 39, 43, 46, 65, 71, 88, 90, 92], [0, 15, 31, 38, 42, 66,
        69, 73, 87, 94], [3, 11, 40, 45, 47, 52, 64, 68, 89, 96],
        [2, 5, 21, 26, 49, 53, 54, 57, 80, 98], [7, 8, 10, 12, 14,
        16, 33, 79, 81, 95], [13, 20, 28, 55, 61, 62, 74, 76, 87,
        99], [1, 9, 18, 44, 60, 63, 67, 72, 85, 86], [4, 22, 23, 29,
        46, 50, 58, 65, 71, 77], [6, 25, 27, 39, 41, 48, 52, 70, 83,
        84], [19, 24, 30, 32, 37, 51, 56, 75, 78, 93], [15, 31, 34,
        43, 66, 82, 88, 89, 90, 97], [0, 17, 38, 42, 45, 69, 73, 91,
        94, 96], [3, 7, 11, 26, 40, 49, 64, 68, 85, 92]]),
    ("0.1", "outcomes"): (
        [[2, 2, 2], [2, 2, 2, 2, 2, 2, 2, 2], [2, 2, 2, 2, 2, 2, 2,
        2, 2], [2, 3, 1, 2, 2, 1, 1, 1, 1, 2], [2, 2, 2, 2, 2, 2, 2,
        3, 2, 3], [2, 2, 2, 2, 2, 2, 2, 2, 2, 2], [2, 2, 2, 1, 2, 2,
        2, 2, 2, 2], [2, 2, 2, 3, 1, 1, 1, 2, 2, 2], [2, 2, 2, 2, 2,
        2, 2, 2, 2], [1, 3, 1, 1, 2, 2, 1, 1, 2, 2], [1, 1, 2, 1, 2,
        2, 1, 1, 3, 2], [2, 1, 1, 3, 1, 1, 2, 2, 1, 1], [2, 1, 3, 2,
        2, 2, 2, 2, 2, 2], [1, 1, 1, 1, 1, 1, 1, 1, 1, 1], [1, 1, 1,
        1, 1, 1, 3, 2, 1, 1], [1, 1, 1, 1, 1, 1, 1, 1, 1, 1], [3, 3,
        1, 1, 3, 1, 1, 1, 2, 1], [1, 1, 2, 2, 1, 1, 1, 2, 2, 2], [3,
        3, 1, 2, 1, 1, 1, 2, 1, 1], [2, 2, 2, 1, 1, 2, 2, 1, 2, 2],
        [2, 2, 2, 2, 3, 2, 2, 3, 3, 2], [3, 1, 1, 2, 1, 1, 1, 1, 3,
        1], [1, 2, 2, 1, 1, 2, 1, 1, 1, 2], [2, 2, 3, 2, 2, 2, 2, 2,
        1, 3], [1, 1, 1, 1, 1, 3, 2, 1, 1, 1], [2, 2, 2, 2, 2, 1, 2,
        2, 2, 2], [2, 1, 1, 2, 3, 1, 2, 1, 3, 2], [1, 3, 3, 2, 1, 1,
        2, 2, 2, 1], [2, 1, 2, 1, 1, 1, 2, 3, 1, 2], [2, 3, 2, 2, 2,
        2, 2, 3, 1, 2]]),
    ("0.3", "selected"): (
        [[1, 35, 40], [12, 35, 36, 41, 49, 58, 60, 83], [0, 19, 44,
        62, 63], [3, 18, 24, 31, 56, 67, 72, 79, 80, 85], [5, 20,
        21, 43, 52, 56, 57, 64, 98, 99], [5, 6, 9, 32, 40, 44, 53,
        98], [6, 27, 28, 29, 35, 41, 60, 84, 92, 93], [1, 3, 7, 12,
        25, 36, 39, 70, 84, 88], [2, 21, 24, 26, 30, 37, 48, 73, 85,
        89], [7, 11, 49, 53, 54, 72, 78, 85, 90, 96], [6, 38, 51,
        57, 62, 63, 64, 75, 79, 80], [9, 20, 25, 27, 31, 32, 54, 68,
        83, 86], [4, 18, 22, 23, 30, 45, 66, 71, 97, 99], [46, 47,
        58, 65, 69, 73, 74, 80, 82, 91], [13, 15, 19, 34, 42, 61,
        67, 76, 88, 90], [8, 10, 14, 29, 33, 77, 82, 86, 91, 95],
        [11, 22, 23, 24, 28, 39, 70, 75, 96, 97], [38, 40, 46, 51,
        55, 69, 87, 92, 93, 94], [0, 1, 5, 43, 48, 52, 56, 57, 64,
        79], [3, 21, 30, 42, 44, 47, 65, 78, 86, 89], [2, 5, 17, 26,
        31, 49, 53, 54, 68, 90], [11, 12, 20, 24, 26, 63, 67, 75,
        98, 99], [9, 15, 23, 28, 34, 50, 62, 66, 71, 87], [0, 4, 18,
        29, 37, 46, 55, 71, 82, 93], [22, 45, 51, 58, 66, 77, 80,
        83, 84, 89], [16, 17, 43, 48, 60, 65, 69, 72, 74, 91], [8,
        16, 17, 19, 23, 40, 42, 61, 94, 95], [13, 15, 27, 32, 39,
        50, 74, 76, 78, 81], [10, 12, 14, 16, 45, 61, 73, 88, 97,
        99], [6, 20, 35, 37, 41, 49, 63, 64, 92, 98]]),
    ("0.3", "outcomes"): (
        [[2, 2, 2], [2, 3, 2, 2, 3, 3, 2, 2], [2, 3, 2, 2, 2], [2,
        2, 3, 1, 2, 2, 1, 1, 1, 3], [2, 2, 2, 2, 2, 1, 1, 3, 2, 2],
        [3, 2, 2, 2, 2, 2, 2, 2], [2, 2, 3, 3, 2, 3, 2, 2, 3, 2],
        [2, 3, 1, 2, 2, 2, 3, 2, 2, 2], [2, 2, 1, 3, 1, 2, 1, 2, 1,
        2], [3, 2, 2, 2, 3, 3, 3, 1, 2, 3], [2, 2, 1, 2, 3, 2, 2, 3,
        1, 3], [3, 3, 2, 3, 3, 3, 3, 1, 2, 1], [1, 3, 1, 3, 1, 1, 1,
        1, 3, 2], [3, 3, 2, 1, 1, 3, 1, 3, 1, 1], [3, 1, 2, 1, 1, 3,
        3, 3, 2, 3], [3, 1, 1, 1, 1, 1, 1, 1, 1, 1], [2, 3, 3, 1, 1,
        2, 2, 1, 2, 3], [2, 3, 1, 2, 3, 3, 3, 2, 2, 1], [3, 2, 2, 3,
        3, 3, 2, 2, 2, 1], [2, 3, 1, 1, 3, 1, 1, 2, 1, 2], [2, 2, 1,
        2, 1, 3, 3, 2, 1, 2], [3, 2, 2, 1, 2, 2, 2, 3, 2, 2], [2, 1,
        1, 2, 3, 3, 3, 3, 1, 1], [2, 3, 3, 3, 3, 1, 1, 3, 1, 2], [1,
        1, 2, 2, 1, 3, 2, 2, 3, 3], [1, 1, 2, 3, 2, 3, 1, 2, 1, 1],
        [3, 3, 1, 3, 1, 2, 1, 3, 1, 3], [3, 1, 2, 2, 2, 1, 1, 3, 2,
        1], [1, 2, 1, 3, 3, 1, 2, 2, 1, 2], [2, 2, 3, 2, 2, 2, 3, 2,
        2, 2]]),
}
# the runtimes-agree and resume phases: a short faulty run, and the
# synchronous dynamics a resume continues bit for bit (a buffered run
# loses the late updates in flight at the snapshot, FedBuff's semantics)
AGREE_FLAGS = ["--rounds", "3", "--churn", "0.25", "--deadline", "1.2",
               "--aggregation", "buffered", "--audit-sync"]
RESUME_DYN_FLAGS = ["--churn", "0.1", "--deadline", "1.5"]
# the robust path: the reference benchmark's robust_agg and self_healing
# fleets (benchmarks/run.py bench_robust_agg and bench_self_healing: the
# CNN-MNIST, 32 clients in 4 clusters, 150 images each, 60 rounds on
# --runtime device, seed 0), built as FederatedServer directly since the
# CLI has no --sample-window, --cluster-resamples or --non-iid flags, and
# tests/test_selfheal.py's NaN storm (4 rounds, ring 3) at the same width
ROBUST_DATASET = "mnist"
ROBUST_BASE = dict(num_clients=32, num_clusters=4, select_ratio=0.3,
                   local_epochs=2, lr=0.1, non_iid_level=0.3,
                   scheme="gradient_cluster_auction", sample_window=20,
                   cluster_resamples=2, init_energy_mode="normal",
                   runtime="device", seed=0)
ROBUST_POOL = 32 * 150
ROBUST_TEST = 256
ROBUST_ROUNDS = 60
_SUB_CLIP = dict(attack="sub_clip", adversary_frac=0.3, defense="clip")
ROBUST_CELLS = {
    "robust_none": dict(attack="scale", adversary_frac=0.3,
                        defense="none", eval_every=10 ** 6),
    "robust_trimmed": dict(attack="scale", adversary_frac=0.3,
                           defense="trimmed", eval_every=10 ** 6),
    "clean": dict(eval_every=10),
    "clean_watchdog": dict(eval_every=10, watchdog="on"),
    "static_clip": dict(eval_every=10, **_SUB_CLIP),
    "selfheal": dict(eval_every=10, defense_mode="adaptive",
                     reputation_mode="price", watchdog="on", **_SUB_CLIP),
    "nan_storm": dict(eval_every=1, adversary_frac=0.3, attack="nan",
                      defense="none", watchdog="on", watchdog_ring=3),
}
# clean and selfheal run 100 rounds, whose first 60 are the benchmark's
# 60-round runs: at 60 the self-healing runs sit on their learning onset
# (near 0.1 at round 50 and 0.84-0.87 at round 60 in the JAX package's
# runs), so the benchmark's comparison is read where both have settled,
# on the mean of the last three evals
LONG_CELLS = ("clean", "selfheal")
LONG_ROUNDS = 100


# The JAX package's results for these cells, written by
# tools/record_robust_reference.py on the CPU: each cell's device run
# (every round's winners, the per-round quarantine and band counts, the
# final ban count, the watchdog's rollbacks, snapshots and rollback
# events, the final accuracy) and its spread over the JAX package's own
# runtimes (see check_robust_cell)
ROBUST_REFERENCE = ROOT / "tools" / "robust_reference.json"
# the JAX package's selfheal runs under float drift, written by
# tools/robust_drift.py: each run's initial params moved by one unit in
# the last place (the size of another float-sum order), on its device and
# sequential runtimes; per cell the range of their ban counts and
# screened totals after 60 rounds and at the end
ROBUST_DRIFT = ROOT / "tools" / "robust_drift.json"
# the JAX package's selfheal state before and after a few rounds (its
# checkpoints, written by tools/robust_drift.py anchors), from which one
# round on the card must take JAX's decisions
ROBUST_ANCHORS = ROOT / "tools" / "robust_anchors"
# the robust_trimmed cell's first screened-step calls, held on the CPU,
# to the bound tests/test_torch_gpu.py holds the card's step to
STEP_CALLS = 3
STEP_TOL = 1e-5
# the audited selfheal warm loop on vectorized: its winners and screen
# counts held through round 11, its totals after 60 rounds to ROBUST_DRIFT
VEC_AUDIT_ROUNDS = 60


def robust_rounds(name: str) -> int:
    if name in LONG_CELLS:
        return LONG_ROUNDS
    return 4 if name == "nan_storm" else ROBUST_ROUNDS
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
# the transformer path: --mode transformer at the CLI defaults (each
# arch's smoke config, 20 FL clients, 5 clusters) held to the JAX
# package's runs (tools/record_transformer_reference.py): qwen2-0.5b for
# 30 rounds on each runtime, the other dense archs for 3 on sequential
TRANSFORMER_REFERENCE = ROOT / "tools" / "transformer_reference.json"
TF_RUNTIMES = ("sequential", "vectorized", "device")
# JAX's three runtimes pick the same clusters and winners in all 30
# rounds, with test losses within 9.6e-7 of each other and accuracy and
# energy std identical: the card is held to 1e-5 on loss and energy std
# (ten times that spread) and to one scored token of the 64 x 31 on the
# accuracy (an argmax may flip on a near tie of two logits that agree to
# 1e-6)
TF_LOSS_TOL = 1e-5
TF_ACC_TOL = 1.0 / (64 * 31)
# the full-width train step: qwen2-0.5b's CONFIG (24 layers, bf16,
# remat, chunked attention) at train_4k's length, batch cut from 256 to
# 2 for one card; 3 SGD steps on one fixed batch
TRAIN_BATCH, TRAIN_LEN, TRAIN_STEPS, TRAIN_LR = 2, 4096, 3, 1e-3
# chunked attention's backward against autograd through the naive
# attention, both fp32: tests/test_kernels.py's bound for the JAX
# package's own custom VJP against autodiff (rtol, atol)
ATTN_BWD_TOL = (1e-3, 1e-4)
# chunked_softmax_xent against the direct fp32 log-softmax at (2, 4,096,
# 151,936): the loss within 1e-5 relative; each grad within 1e-4 of its
# largest magnitude (the two differ in the order of fp32 sums of up to
# 151,936 terms, about 2^-24 * sqrt(151,936) = 2.3e-5 relative)
XENT_VALUE_TOL, XENT_GRAD_TOL = 1e-5, 1e-4


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


def first_diff(got, want):
    """The first round where two per-round lists differ, as text."""
    for t, (a, b) in enumerate(zip(got, want)):
        if a != b:
            return f"round {t}: {a} against {b}"
    return f"lengths {len(got)} and {len(want)}"


def dynamics_path(OPS, TRAIN, obs, servers, smi) -> int:
    """The fleet-dynamics path (churn, deadlines, buffered aggregation),
    the event stream, checkpoints and resume, and the sync auditor, at
    the reference defaults on the card.  Returns the ``lloyd_step``
    launches of the churn-0.1 run."""
    from repro_torch.obs import schema as SCHEMA
    from repro_torch.sim import dynamics as DYN

    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)

    # ---- faulty fleets, 30 rounds, against the JAX package ------------
    s_per_round, launches = {}, {}
    for churn in ("0", "0.1", "0.3"):
        jsonl = work / f"events_churn{churn}.jsonl"
        flags = (["--churn", churn] + DYN_FLAGS if churn != "0" else [])
        reset_counts(OPS)
        obs.SPANS.clear()
        result = TRAIN.main(["--quiet", "--runtime", "vectorized",
                             "--log-jsonl", str(jsonl)] + flags)
        torch.cuda.synchronize()
        launches[churn] = OPS.lloyd_step.launches
        srv = servers[-1]
        require(launches[churn] == 26, f"churn {churn}: stage 1 made "
                f"{launches[churn]} lloyd_step launches, expected 26")
        require(OPS.kmeans_assign.launches == OPS.flash_attention.launches
                == 0, f"churn {churn}: launched a kernel it does not use")
        require(result["params_finite"] and all(
            math.isfinite(a) for a in result["test_acc"]),
            f"churn {churn}: non-finite params or accuracy")
        events = SCHEMA.load_jsonl(str(jsonl))
        errs = SCHEMA.validate_events(events, rounds=30, eval_every=1,
                                      scheme_select="paper")
        require(not errs, f"churn {churn}: the event log fails the "
                f"schema: {errs[:3]}")
        stage1 = obs.SPANS["run/cluster"]
        s_per_round[churn] = (result["wall_s"] - stage1) / 30
        line = (f"dynamics churn {churn} (vectorized, 30 rounds): "
                f"lloyd_step launches={launches[churn]} "
                f"stage1_s={stage1!r} s_per_round={s_per_round[churn]!r} "
                f"final_test_acc={result['test_acc'][-1]!r} "
                f"events={len(events)} schema ok")
        if churn == "0":
            require(result["selected"] == SCHEME_WINNERS[
                "gradient_cluster_auction"], "churn 0: not the plain "
                "run's winners")
        else:
            want = DYN_WINNERS[(churn, "selected")]
            require(result["selected"] == want, f"churn {churn}: the JAX "
                    f"package selects otherwise, "
                    f"{first_diff(result['selected'], want)}")
            got = [o.tolist() for o in srv.outcome_log]
            want = DYN_WINNERS[(churn, "outcomes")]
            require(got == want, f"churn {churn}: outcome codes differ "
                    f"from the JAX package's, {first_diff(got, want)}")
            folds = sum(e["kind"] == "dynamics"
                        and e.get("name") == "buffer/fold" for e in events)
            require(folds >= 1, f"churn {churn}: no buffer/fold event")
            d = result["dynamics"]
            line += (f" selected+outcomes=DYN_WINNERS buffer_folds={folds}"
                     f" completed={d['num_completed']} "
                     f"late={d['num_late']} dropped={d['num_dropped']}")
        print(line + f" [{smi}]", flush=True)
    print(f"dynamics overhead (s_per_round vs churn 0): churn 0.1 "
          f"{s_per_round['0.1'] / s_per_round['0']!r}x, churn 0.3 "
          f"{s_per_round['0.3'] / s_per_round['0']!r}x [{smi}]", flush=True)

    # ---- runtimes agree ----------------------------------------------
    got = {}
    for runtime in ("sequential", "vectorized", "device"):
        reset_counts(OPS)
        result = TRAIN.main(["--quiet", "--runtime", runtime] + AGREE_FLAGS)
        torch.cuda.synchronize()
        require(OPS.lloyd_step.launches == 26,
                f"{runtime}: {OPS.lloyd_step.launches} lloyd_step launches")
        srv = servers[-1]
        got[runtime] = (result["selected"],
                        [o.tolist() for o in srv.outcome_log], srv.params)
    sel, outs, params = got["sequential"]
    require(any(DYN.LATE in o for o in outs), "the short faulty run has "
            "no late winner")
    for runtime in ("vectorized", "device"):
        require(got[runtime][0] == sel and got[runtime][1] == outs,
                f"{runtime}: selections or outcomes differ from the "
                "sequential runtime's")
        diff = max_param_diff(got[runtime][2], params)
        require(diff < PARAMS_TOL, f"{runtime}: params differ from the "
                f"sequential runtime's by {diff} under dynamics")
        print(f"dynamics runtimes: {runtime} selects and classifies as "
              f"sequential, max_abs_dparams={diff!r}; round 2 of each "
              "runtime under the sync audit", flush=True)

    # ---- churn 0 with buffered aggregation is the plain run ----------
    result = TRAIN.main(MAIN_ARGS + ["--runtime", "vectorized", "--churn",
                                     "0", "--aggregation", "buffered"])
    require(result["selected"] == REFERENCE_WINNERS
            and "dynamics" not in result,
            f"churn 0 buffered: selected {result['selected']}")
    print("dynamics churn 0 --aggregation buffered: REFERENCE_WINNERS, no "
          "fault model", flush=True)

    # ---- resume, with and without dynamics ---------------------------
    for label, flags in (("plain", []), ("dynamics", RESUME_DYN_FLAGS)):
        ck = str(work / f"resume_{label}")
        argv = ["--quiet", "--runtime", "vectorized", "--rounds", "6",
                "--checkpoint-path", ck] + flags
        obs.SPANS.clear()
        full = TRAIN.main(argv + ["--checkpoint-every", "3"])
        ref = servers[-1]
        save_s = obs.SPANS["run/checkpoint"]
        reset_counts(OPS)
        tail = TRAIN.main(argv + ["--resume"])
        torch.cuda.synchronize()
        srv = servers[-1]
        require(OPS.lloyd_step.launches == 0, f"resume {label}: the "
                f"resumed leg made {OPS.lloyd_step.launches} lloyd_step "
                "launches")
        require(tail["rounds"] == [3, 4, 5]
                and tail["selected"] == full["selected"][3:]
                and tail["test_loss"] == full["test_loss"][3:],
                f"resume {label}: rounds 3-5 differ from the "
                "uninterrupted run's")
        require(all(torch.equal(ref.params[k], srv.params[k])
                    for k in ref.params),
                f"resume {label}: params are not bit-identical")
        if flags:
            require([o.tolist() for o in ref.outcome_log[3:]]
                    == [o.tolist() for o in srv.outcome_log],
                    f"resume {label}: outcomes differ")
        print(f"resume {label} (vectorized, 6 rounds, checkpoint at 3): "
              f"rounds 3-5 bit-identical, resumed lloyd_step launches=0 "
              f"save_s={save_s!r} restore_s={obs.SPANS['run/restore']!r}"
              f" [{smi}]", flush=True)

    # ---- the sync auditor, counted transfers, the profiler -----------
    base = ["--quiet", "--runtime", "vectorized", "--churn", "0.1"]
    TRAIN.main(base + DYN_FLAGS + ["--rounds", "6", "--audit-sync"])
    srv = servers[-1]
    snap = obs.torch_stats.snapshot()
    warm = 4
    torch.cuda.synchronize()
    t = time.perf_counter()
    with obs.sync_audit():
        for r in range(6, 6 + warm):
            srv._dispatch_round(r, eval_now=True)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t) / warm
    srv._flush_pending()
    moved = obs.torch_stats.delta(snap)
    print("sync audit (vectorized, dynamics): warm rounds 2-9 ran under "
          "set_sync_debug_mode('error'); per warm round: "
          + " ".join(f"{k}={moved.get(k, 0) / warm!r}" for k in
                     ("h2d_calls", "h2d_bytes", "d2h_calls", "d2h_bytes"))
          + f" s={dt!r} [{smi}]", flush=True)
    prof = work / "profile"
    TRAIN.main(base + DYN_FLAGS + ["--rounds", "2", "--profile-dir",
                                   str(prof)])
    traces = list(prof.glob("trace.*.json"))
    require(bool(traces) and traces[0].stat().st_size > 0,
            "--profile-dir wrote no trace")
    print(f"profile-dir: {traces[0].name} {traces[0].stat().st_size} "
          "bytes", flush=True)
    return launches["0.1"]


def robust_data():
    """The robust cells' fleet: the pool, its partition (the same for
    every cell: it reads only num_clients, non_iid_level and the seed)
    and the test batch."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.data.partition import partition_clients
    from repro_torch.data.synthetic import make_image_dataset
    seed = ROBUST_BASE["seed"]
    train, test = make_image_dataset(ROBUST_DATASET, n_train=ROBUST_POOL,
                                     n_test=ROBUST_TEST, seed=seed)
    clients = partition_clients(train.y, FLConfig(**ROBUST_BASE), seed=seed)
    return train, clients, {"x": test.x[:ROBUST_TEST],
                            "y": test.y[:ROBUST_TEST]}


def robust_cell(OPS, obs, data, name, runtime="device", rounds=None,
                warm=5, jsonl=None, device="cuda", setup=None, **run_kw):
    """Build one robust cell's FederatedServer on the card and run it
    through ``run``, its launch counts set to 0 just before.  Times the
    warm rounds from ``warm`` on (host clock, the card synchronised at
    both ends of the window) and counts their transfers.  ``setup(srv)``
    runs once the server is built.  Returns the server, its logs, its
    round rows and its numbers."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.core.adapters import cnn_adapter
    from repro_torch.core.server import FederatedServer
    train, clients, test = data
    cfg = FLConfig(**dict(ROBUST_BASE, runtime=runtime,
                          **ROBUST_CELLS[name]))
    rounds = robust_rounds(name) if rounds is None else rounds
    srv = FederatedServer(cfg, cnn_adapter(ROBUST_DATASET, device),
                          train.x, train.y, clients, test, device=device)
    if setup is not None:
        setup(srv)
    dispatch, mark = srv._dispatch_round, {}

    def timed(t, eval_now, final=False):
        if t == warm:
            # the window opens inside the sync audit's region on an
            # audited run: the wait for the card is this timer's own
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode(mode)
            mark["t"] = time.perf_counter()
            mark["moved"] = obs.torch_stats.snapshot()
        dispatch(t, eval_now, final=final)

    srv._dispatch_round = timed
    mem = obs.configure(memory=True, jsonl=jsonl)
    reset_counts(OPS)
    obs.SPANS.clear()
    try:
        logs = srv.run(rounds=rounds, **run_kw)
        torch.cuda.synchronize()
    finally:
        obs.OBS.close_sinks()
    info = {"launches": OPS.lloyd_step.launches,
            "stage1_s": obs.SPANS.get("run/cluster", 0.0),
            "spans": {k: v for k, v in sorted(obs.SPANS.items())
                      if k.startswith(("round/", "cohort/"))}}
    require(OPS.kmeans_assign.launches == OPS.flash_attention.launches
            == 0, f"{name}: launched a kernel it does not use")
    if "t" in mark:
        n = len(logs) - (warm - logs[0].round)
        info["warm_s_per_round"] = (time.perf_counter() - mark["t"]) / n
        moved = obs.torch_stats.delta(mark["moved"])
        info["per_round"] = {k: moved.get(k, 0) / n for k in (
            "h2d_calls", "h2d_bytes", "d2h_calls", "d2h_bytes")}
    rows = [e for e in mem.events if e["kind"] == "round"]
    return srv, logs, rows, info


def envelope(values, floor):
    """[lo - floor, hi + floor] around the JAX runs' values: where they
    agree this is their value within ``floor``.  Around a sample of runs
    under drift ``floor`` is half the sample's range: a further run falls
    outside the range of n others with chance 2/(n + 1), and half the
    width again on each side puts the bound near four standard
    deviations of a normal spread."""
    return min(values) - floor, max(values) + floor


def totals_at(rows, n):
    """A defended run's ban count at round n - 1 and screens in rounds
    0 to n - 1, from its round rows."""
    return (int(rows[n - 1]["num_banned"]),
            sum(int(r["num_screened"]) for r in rows[:n]))


def check_robust_cell(name, srv, logs, rows, want, drift=None, first=0):
    """Hold one robust run from round ``first`` on to the JAX package's
    (ROBUST_WINNERS).  Winners and per-round quarantine and band counts
    are held bit for bit in every round in which the JAX package's own
    runtimes agree with each other (``agree_through``; all rounds unless
    the cell's selection reads the trained params), and so are rollbacks
    and the ban and screened totals of a cell whose runtimes agree in
    every round.  A cell whose runs pick other clients from
    ``agree_through`` on holds its ban count and screened total after 60
    rounds and at its end to the range of the JAX package's runs of the
    same cell under float drift (``drift``, tools/robust_drift.json).
    Returns the rounds held exactly."""
    spread = want["spread"]
    horizon = spread["agree_through"]
    horizon = len(want["selected"]) if horizon is None else horizon
    got = [l.selected.tolist() for l in logs]
    held = max(0, min(first + len(got), horizon) - first)
    sel = want["selected"][first:first + held]
    require(got[:held] == sel, f"{name}: the JAX package selects "
            f"otherwise, {first_diff(got[:held], sel)}")
    for key in ("num_quarantined", "num_screened"):
        if key in want:
            g = [int(r[key]) for r in rows][:held]
            w = want[key][first:first + held]
            require(g == w, f"{name}: {key} differs from the JAX "
                    f"package's, {first_diff(g, w)}")
    if first:
        return held
    checks = []
    if len(got) == len(want["selected"]):
        checks += [("rollbacks", getattr(srv, "watchdog_totals", {}).get(
            "rollbacks", 0), spread["rollbacks"].values())]
        if srv.defended and spread["agree_through"] is None:
            checks += [("banned", srv.defense_totals["banned_final"],
                        spread["banned"].values()),
                       ("screened", srv.defense_totals["screened"],
                        spread["screened"].values())]
    if srv.defended and spread["agree_through"] is not None:
        require(drift is not None, f"{name}: no drift range recorded")
        for n in sorted({ROBUST_ROUNDS, len(got)}):
            if f"banned_{n}" not in drift:
                continue
            banned, screened = totals_at(rows, n)
            checks += [(f"banned after {n} rounds", banned,
                        drift[f"banned_{n}"]),
                       (f"screened in {n} rounds", screened,
                        drift[f"screened_{n}"])]
    for key, value, runs in checks:
        lo, hi = envelope(runs, (max(runs) - min(runs)) / 2)
        require(lo <= value <= hi, f"{name}: {key} {value}, outside "
                f"[{lo}, {hi}] around the JAX package's runs "
                f"{sorted(runs)}")
    return held


def record_screened_steps(srv, count):
    """Keep the inputs and outputs of the first ``count`` calls of the
    server's screened step (clones on the card, no host sync)."""
    calls = []
    step = srv._screen_step

    def clone(v):
        if isinstance(v, torch.Tensor):
            return v.clone()
        if isinstance(v, dict):
            return {k: clone(x) for k, x in v.items()}
        if isinstance(v, (tuple, list)):
            return type(v)(clone(x) for x in v)
        if dataclasses.is_dataclass(v):
            return dataclasses.replace(v, **{
                f.name: clone(getattr(v, f.name))
                for f in dataclasses.fields(v)})
        return v

    def recorded(*args):
        out = step(*args)
        if len(calls) < count:
            calls.append((clone(args), clone(out)))
        return out

    srv._screen_step = recorded
    return calls


def check_screened_calls(name, cfg, calls, card):
    """Each recorded call of the card's screened step against the same
    step on the CPU on the same inputs (deltas, weights, masks, strikes,
    state, key): new strikes and counts exact, the aggregate within
    STEP_TOL.  The same inputs through ``defense="none"`` give the
    undefended aggregate, which a defense that fell back to plain FedAvg
    would return: it must lie at least 100 STEP_TOL away."""
    from repro_torch.core import aggregation as AGG

    def cpu(v):
        if isinstance(v, torch.Tensor):
            return v.cpu()
        if dataclasses.is_dataclass(v):
            return dataclasses.replace(v, **{
                f.name: cpu(getattr(v, f.name))
                for f in dataclasses.fields(v)})
        return v

    step = AGG.make_screened_step(cfg)
    none = AGG.make_screened_step(dataclasses.replace(cfg, defense="none"))
    for i, (args, out) in enumerate(calls):
        args = tuple(cpu(a) for a in args)
        agg, strikes, _, rep = step(*args)
        plain = none(*args)[0]
        got = out[0].cpu()
        err = float((got - agg).abs().max())
        apart = float((got - plain).abs().max())
        require(err <= STEP_TOL, f"{name} call {i}: the card's aggregate "
                f"differs from the CPU's by {err} > {STEP_TOL}")
        require(torch.equal(out[1].cpu(), strikes),
                f"{name} call {i}: new strikes differ from the CPU's")
        for k in ("num_quarantined", "num_screened", "num_survivors"):
            require(int(out[3][k]) == int(rep[k]), f"{name} call {i}: "
                    f"{k} {int(out[3][k])}, the CPU's {int(rep[k])}")
        require(apart >= 100 * STEP_TOL, f"{name} call {i}: the aggregate "
                f"is within {apart} of undefended FedAvg's")
        print(f"  {name} screened step call {i} (round {int(args[7])}): "
              f"card vs CPU max_abs_err={err!r}, vs undefended FedAvg "
              f"max_abs_diff={apart!r}, adversary rows="
              f"{int((args[3] & args[2]).sum())} [{card}]", flush=True)


def check_resume(OPS, obs, data, ck, full_logs, want) -> None:
    """Rounds 30-59 of selfheal again from the uninterrupted run's
    snapshot at 30 (``ck``30), held to that run's logs and its snapshot
    at 60 (``ck``60) bit for bit, with no ``lloyd_step`` launch (the
    resumed leg's last round evaluates, as a final round does)."""
    from repro_torch.checkpoint import io as CKPT
    srv, logs, rows, info = robust_cell(OPS, obs, data, "selfheal", warm=35,
                                        rounds=60, checkpoint_path=f"{ck}30",
                                        resume=True)
    require(info["launches"] == 0, f"resume selfheal: the resumed leg made "
            f"{info['launches']} lloyd_step launches")

    def rows_of(ls):       # NaN-free: skipped evals are NaN by design
        return [(l.round, l.selected.tolist(), l.eval_skipped,
                 None if l.eval_skipped else (l.test_acc, l.test_loss))
                for l in ls]

    require([l.round for l in logs] == list(range(30, 60))
            and rows_of(logs[:-1]) == rows_of(full_logs[30:59])
            and logs[-1].selected.tolist()
            == full_logs[59].selected.tolist(),
            "resume selfheal: rounds 30-59 differ from the uninterrupted "
            "run's")
    saved, step = CKPT.restore(f"{ck}60", srv._ckpt_tree())
    require(step == 60 and all(torch.equal(saved["params"][k], srv.params[k])
                               for k in srv.params)
            and torch.equal(saved["state"].strikes, srv.state.strikes)
            and all(torch.equal(getattr(saved["defense_state"], f),
                                getattr(srv._defense_state, f))
                    for f in ("clip_ema", "mad_ema", "pressure", "tighten")),
            "resume selfheal: params, strikes or defense state at 60 are "
            "not bit-identical to the uninterrupted run's snapshot")
    check_robust_cell("resume selfheal", srv, logs, rows, want, first=30)
    print("resume selfheal (device, snapshot at 30): rounds 30-59, params, "
          "strikes and defense state at 60 bit-identical, resumed "
          "lloyd_step launches=0", flush=True)


def robust_anchor_rounds(OPS, obs, data, card) -> None:
    """From the JAX package's own state before round T of the selfheal
    cell (its checkpoint, ROBUST_ANCHORS), one round on the card takes
    JAX's decisions: winners, quarantine, band and ban counts exactly,
    and of the state the next round reads (the checkpoint tree) the
    strikes and integer leaves exactly and every other leaf (params,
    energy residuals, the defense EMAs) within PARAMS_TOL.  One round of
    two runtimes from the same state moves the latter by up to 5.4e-5
    (tools/robust_drift.py lockstep: the MAD's median picking the other
    of two near-equal norms); a round's own update moves each of them by
    more than PARAMS_TOL at five of the six anchors.

    A whole run drifts from JAX's once its screens read the trained
    params (check_robust_cell); these rounds hold the mechanism itself
    where whole runs no longer can, at rounds 15 to 90."""
    import numpy as np
    from repro_torch.checkpoint import io as CKPT
    meta = json.loads((ROBUST_ANCHORS / "anchors.json").read_text())
    for t_str, want in meta["anchors"].items():
        t = int(t_str)
        srv, logs, rows, info = robust_cell(
            OPS, obs, data, meta["cell"], rounds=t + 1, warm=t + 1,
            checkpoint_path=str(ROBUST_ANCHORS / f"round{t}"), resume=True)
        require(info["launches"] == 0, f"anchor {t}: the resumed round "
                f"made {info['launches']} lloyd_step launches")
        require([l.round for l in logs] == [t], f"anchor {t}: ran rounds "
                f"{[l.round for l in logs]}")
        require(logs[0].selected.tolist() == want["selected"],
                f"anchor {t}: winners {logs[0].selected.tolist()}, the "
                f"JAX package's {want['selected']}")
        for k in ("num_quarantined", "num_screened", "num_banned"):
            require(int(rows[0][k]) == want[k], f"anchor {t}: {k} "
                    f"{int(rows[0][k])}, the JAX package's {want[k]}")
        got = CKPT._flatten(srv._ckpt_tree())
        with np.load(ROBUST_ANCHORS / f"round{t + 1}.npz") as f:
            nxt = {k: f[k] for k in f.files}
        require(sorted(got) == sorted(nxt), f"anchor {t}: state keys "
                f"{sorted(got)}, the JAX package's {sorted(nxt)}")
        diff = {}
        for k in got:
            d = float(np.abs(got[k].astype(np.float64) - nxt[k]).max())
            if (np.issubdtype(nxt[k].dtype, np.floating)
                    and k != "state/.strikes"):
                diff[k] = d
                require(d < PARAMS_TOL, f"anchor {t}: {k} differs from "
                        f"the JAX package's by {d} >= {PARAMS_TOL}")
            else:
                require(d == 0.0, f"anchor {t}: {k} differs from the JAX "
                        "package's")
        worst = max(diff, key=diff.get)
        counts = {k: want[k] for k in ("num_quarantined", "num_screened",
                                        "num_banned")}
        print(f"anchor round {t} (selfheal, device, from the JAX "
              f"package's state): winners, {counts}, strikes and integer "
              f"state = JAX's, float state max_abs_diff={diff[worst]!r} "
              f"({worst}), lloyd_step launches=0 [{card}]", flush=True)


def screened_step_times(obs, card, warm_s):
    """The screened step's device ms at the robust cells' shape
    (screen_capacity rows x the CNN's 21,840 parameters) for clip,
    trimmed and median, and each one's share of a warm selfheal round."""
    from repro_torch import rng
    from repro_torch.configs.base import FLConfig
    from repro_torch.core import aggregation as AGG
    dev = torch.device("cuda")
    cfg0 = FLConfig(**dict(ROBUST_BASE, **ROBUST_CELLS["selfheal"]))
    cap, d, n = AGG.screen_capacity(cfg0), 21840, cfg0.num_clients
    g = torch.Generator(device=dev).manual_seed(7)
    deltas = torch.randn(cap, d, device=dev, generator=g)
    valid = torch.arange(cap, device=dev) < cap - 6
    w = torch.where(valid, 1.0 / float(cap - 6), 0.0)
    adv = valid & (torch.arange(cap, device=dev) % 3 == 0)
    ids = torch.where(valid, torch.arange(cap, device=dev), -1).to(
        torch.int32)
    strikes = torch.zeros(n, device=dev)
    rnd = torch.zeros((), dtype=torch.int32, device=dev)
    out = {}
    for defense in ("clip", "trimmed", "median"):
        cfg = FLConfig(**dict(ROBUST_BASE, **dict(
            ROBUST_CELLS["selfheal"], defense=defense)))
        step = AGG.make_screened_step(cfg)
        ds = AGG.init_defense_state(cfg, dev)
        ds = AGG.DefenseState(clip_ema=ds.clip_ema + 140.0,
                              mad_ema=ds.mad_ema + 1.0,
                              pressure=ds.pressure, tighten=ds.tighten)
        ms = median_ms(lambda: step(deltas, w, valid, adv, ids, strikes, ds,
                                    rnd, rng.PRNGKey(0)))
        out[defense] = ms
        print(f"screened step {defense} (adaptive, watchdog) at ({cap}, "
              f"{d}): device_ms={ms!r} share_of_warm_selfheal_round="
              f"{ms / (warm_s * 1e3)!r} [{card}]", flush=True)
    return out


def robust_path(OPS, obs, card) -> int:
    """The Byzantine-tolerant path at the reference benchmark's width,
    every cell held to the JAX package's winners, screen counts,
    rollbacks and final accuracy (ROBUST_WINNERS), the self-healing
    cell's totals to the JAX runs' drift range (ROBUST_DRIFT) and its
    rounds from JAX's own states (ROBUST_ANCHORS).  Returns the cells'
    ``lloyd_step`` launches."""
    from repro_torch.obs import schema as SCHEMA
    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    data = robust_data()
    ROBUST_WINNERS = json.loads(ROBUST_REFERENCE.read_text())
    drift = json.loads(ROBUST_DRIFT.read_text())
    launches, acc, warm, late = 0, {}, {}, {}
    ck = work / "robust_selfheal_ck"

    def keep_snapshots(srv):
        # run() writes a snapshot after rounds 29, 59 and 89 to one path:
        # a copy taken before rounds 30 and 60 keeps the first two
        dispatch = srv._dispatch_round

        def hooked(t, eval_now, final=False):
            if t in (30, 60):
                for ext in (".npz", ".json"):
                    shutil.copy(f"{ck}{ext}", f"{ck}{t}{ext}")
            dispatch(t, eval_now, final=final)
        srv._dispatch_round = hooked

    for name in ROBUST_CELLS:
        want = ROBUST_WINNERS[name]
        logged = name in ("selfheal", "nan_storm")
        jsonl = str(work / f"robust_{name}.jsonl") if logged else None
        run_kw, setup, calls = {}, None, None
        if name == "selfheal":
            run_kw = {"audit_sync": True, "checkpoint_every": 30,
                      "checkpoint_path": str(ck)}
            setup = keep_snapshots
        elif name == "robust_trimmed":
            def setup(srv):
                nonlocal calls
                calls = record_screened_steps(srv, STEP_CALLS)
        srv, logs, rows, info = robust_cell(
            OPS, obs, data, name, jsonl=jsonl, setup=setup,
            warm=1 if name == "nan_storm" else 5, **run_kw)
        launches += info["launches"]
        require(info["launches"] == 26, f"{name}: stage 1 made "
                f"{info['launches']} lloyd_step launches, expected 26")
        held = check_robust_cell(name, srv, logs, rows, want,
                                 drift.get(name))
        line = (f"robust {name} (device, {len(logs)} rounds): winners and "
                f"screen counts = ROBUST_WINNERS in rounds 0-{held - 1}")
        if srv.cfg.watchdog_enabled:
            got = (srv.watchdog_totals["rollbacks"],
                   srv.watchdog_totals["snapshots"])
            if len(set(want["spread"]["rollbacks"].values())) == 1:
                require(got == (want["rollbacks"], want["snapshots"]),
                        f"{name}: rollbacks, snapshots {got}, the JAX "
                        f"package's {want['rollbacks']}, "
                        f"{want['snapshots']}")
            line += f" rollbacks={got[0]} snapshots={got[1]}"
        if logged:
            events = SCHEMA.load_jsonl(jsonl)
            rb = [[e["round"], e["restored_round"], e["reason"]]
                  for e in events if e["kind"] == "watchdog"
                  and e.get("name") == "rollback"]
            require(rb == [list(r) for r in want["rollback_events"]],
                    f"{name}: rollback events {rb}, the JAX package's "
                    f"{want['rollback_events']}")
            errs = SCHEMA.validate_events(
                events, rounds=len(logs), eval_every=srv.cfg.eval_every,
                reputation_mode=srv.cfg.reputation_mode,
                min_rollbacks=1 if name == "nan_storm" else None)
            require(not errs, f"{name}: the event log fails the schema: "
                    f"{errs[:3]}")
            line += f" events={len(events)} schema ok"
        final = logs[-1].test_acc
        require(math.isfinite(final), f"{name}: final accuracy {final!r}")
        evals = [l.test_acc for l in logs if not l.eval_skipped][-3:]
        late[name] = sum(evals) / len(evals)
        if want["spread"]["agree_through"] is None:
            # the same clients every round in every run: the final
            # accuracy is held (a cell whose runs pick other clients after
            # agree_through is a different run from there on)
            lo, hi = envelope(want["spread"]["final_acc"].values(), 0.02)
            require(lo <= final <= hi, f"{name}: final accuracy {final!r} "
                    f"outside [{lo!r}, {hi!r}] (the JAX package's "
                    f"runtimes: {want['spread']['final_acc']})")
        if name in LONG_CELLS:
            # settled by round 80 in every run of either package: held on
            # the last three evals whether or not the selections agree
            lo, hi = envelope(want["spread"]["late_acc"].values(), 0.02)
            require(lo <= late[name] <= hi, f"{name}: last three evals "
                    f"{evals} (mean {late[name]!r}) outside [{lo!r}, "
                    f"{hi!r}] (the JAX package's runtimes: "
                    f"{want['spread']['late_acc']})")
        if name != "robust_none":
            require(all(torch.isfinite(v).all() for v in
                        srv.params.values()), f"{name}: non-finite params")
        acc[name], warm[name] = final, info.get("warm_s_per_round")
        if srv.defended:
            t = srv.defense_totals
            line += (f" quarantined={t['quarantined']} "
                     f"screened={t['screened']} "
                     f"banned={t['banned_final']}")
            if name in drift:
                ranges = {k: v for k, v in drift[name].items()
                          if k.startswith(("banned_", "screened_"))}
                line += (" banned,screened after 60 rounds="
                         f"{totals_at(rows, ROBUST_ROUNDS)} (the JAX "
                         f"runs' ranges {ranges})")
        every = {l.round: l.test_acc for l in logs if not l.eval_skipped}
        line += (f" lloyd_step launches={info['launches']} final_acc="
                 f"{final!r} jax_final_acc={want['spread']['final_acc']} "
                 f"last_three_evals={late[name]!r} evals={every} "
                 f"stage1_s={info['stage1_s']!r}")
        if name != "nan_storm":
            line += f" warm_s_per_round={warm[name]!r} " + " ".join(
                f"{k}={v!r}" for k, v in info["per_round"].items())
        print(line + f" [{card}]", flush=True)
        print("  host s by span: " + " ".join(
            f"{k}={v!r}" for k, v in info["spans"].items()), flush=True)
        if name == "robust_trimmed":
            require(len(calls) == STEP_CALLS, f"{name}: recorded "
                    f"{len(calls)} screened-step calls")
            check_screened_calls(name, srv.cfg, calls, card)
        if name == "selfheal":
            full_logs = logs
            print(f"  selfheal: warm rounds 2-{len(logs) - 1} ran under "
                  "set_sync_debug_mode('error') on device", flush=True)

    # ---- the qualitative result ---------------------------------------
    # undefended FedAvg collapses under the scale attack, as in every JAX
    # run.  The self-healing stack ends within 0.05 of clean once both
    # have settled: at 100 rounds, on the mean of the last three evals (at
    # round 60 every run of either package sits on its learning onset).
    # Whether trimmed ends within 0.05 of clean is read, not held: the
    # JAX package's own runs end at 0.08-0.21 there.
    require(late["clean"] - acc["robust_none"] >= 0.5, "undefended FedAvg "
            f"under the scale attack ends at {acc['robust_none']!r}, not "
            f"far below clean {late['clean']!r}")
    gap = late["clean"] - late["selfheal"]
    require(gap <= 0.05, f"selfheal at 100 rounds ends at "
            f"{late['selfheal']!r} (last three evals), not within 0.05 "
            f"of clean's {late['clean']!r}")
    gaps = {n: late["clean"] - acc[n] for n in ("robust_none",
                                                "robust_trimmed",
                                                "static_clip")}
    jax_acc = {n: ROBUST_WINNERS[n]["spread"]["final_acc"] for n in acc}
    print(f"robust result: final acc {acc}; gap to clean's last three "
          f"evals {gaps}; trimmed within 0.05 of clean: "
          f"{gaps['robust_trimmed'] <= 0.05}; at 100 rounds (last three "
          f"evals) clean {late['clean']!r} selfheal {late['selfheal']!r}, "
          f"gap {gap!r}; the JAX package's runtimes: final {jax_acc}",
          flush=True)
    print(f"defended overhead (warm s per round vs clean): trimmed "
          f"{warm['robust_trimmed'] / warm['clean']!r}x, selfheal "
          f"{warm['selfheal'] / warm['clean']!r}x, clean_watchdog "
          f"{warm['clean_watchdog'] / warm['clean']!r}x [{card}]",
          flush=True)

    # ---- resume of selfheal from its round-30 snapshot ----------------
    check_resume(OPS, obs, data, ck, full_logs, ROBUST_WINNERS["selfheal"])

    # ---- rounds from the JAX package's own states ---------------------
    robust_anchor_rounds(OPS, obs, data, card)

    # ---- the audited selfheal warm loop on vectorized -----------------
    srv, logs, rows, info = robust_cell(OPS, obs, data, "selfheal",
                                        runtime="vectorized",
                                        rounds=VEC_AUDIT_ROUNDS,
                                        audit_sync=True)
    launches += info["launches"]
    require(info["launches"] == 26, f"selfheal vectorized: "
            f"{info['launches']} lloyd_step launches")
    held = check_robust_cell("selfheal vectorized", srv, logs, rows,
                             ROBUST_WINNERS["selfheal"], drift["selfheal"])
    print(f"selfheal vectorized ({VEC_AUDIT_ROUNDS} rounds): winners and "
          f"screen counts = ROBUST_WINNERS in rounds 0-{held - 1}, warm "
          f"rounds 2-{VEC_AUDIT_ROUNDS - 1} under "
          f"set_sync_debug_mode('error'), banned,screened after 60 rounds="
          f"{totals_at(rows, ROBUST_ROUNDS)} (JAX runs' range "
          f"{drift['selfheal']['banned_60']}, "
          f"{drift['selfheal']['screened_60']}) final_acc="
          f"{logs[-1].test_acc!r} warm_s_per_round="
          f"{info['warm_s_per_round']!r} [{card}]", flush=True)

    screened_step_times(obs, card, warm["selfheal"])
    print(f"robust path lloyd_step launches: {launches} (26 in each "
          f"stage 1, none in a resumed leg or an anchor round)", flush=True)
    return launches


def transformer_path(OPS, TRAIN, obs, servers) -> int:
    """``--mode transformer`` at the CLI defaults on the card: qwen2-0.5b
    for 30 rounds on each runtime and each other dense arch for 3 on
    ``sequential``, counts reset before and read after each run (26
    ``lloyd_step`` launches), held to the JAX package's labels, winners
    and round metrics (TRANSFORMER_REFERENCE).  Returns the launches."""
    ref = json.loads(TRANSFORMER_REFERENCE.read_text())
    runs = [(arch, rt) for arch, by_rt in ref["runs"].items()
            for rt in TF_RUNTIMES if rt in by_rt]
    total = 0
    for arch, runtime in runs:
        want, rounds = ref["runs"][arch][runtime], ref["rounds"][arch]
        reset_counts(OPS)
        obs.SPANS.clear()
        result = TRAIN.main(["--mode", "transformer", "--quiet", "--arch",
                             arch, "--runtime", runtime, "--rounds",
                             str(rounds)])
        torch.cuda.synchronize()
        launches = OPS.lloyd_step.launches
        srv = servers[-1]
        tag = f"transformer {arch} ({runtime})"
        require(srv.runtime.name == runtime and srv.device.type == "cuda",
                f"{tag}: ran {srv.runtime.name} on {srv.device}")
        require(launches == 26, f"{tag}: stage 1 made {launches} "
                "lloyd_step launches, expected 26")
        require(OPS.kmeans_assign.launches == OPS.flash_attention.launches
                == 0, f"{tag}: launched a kernel it does not use")
        labels = obs.device_get(srv.state.clusters).tolist()
        require(labels == want["clusters"], f"{tag}: stage-1 labels "
                f"{labels}, the JAX package's {want['clusters']}")
        require(result["selected"] == want["selected"],
                f"{tag}: winners differ from the JAX package's ("
                f"{first_diff(result['selected'], want['selected'])})")
        errs = {}
        for key, tol in (("test_loss", TF_LOSS_TOL),
                         ("energy_std", TF_LOSS_TOL),
                         ("test_acc", TF_ACC_TOL)):
            errs[key] = max(abs(a - b) for a, b in zip(result[key],
                                                       want[key]))
            require(errs[key] <= tol, f"{tag}: {key} differs from the "
                    f"JAX package's by {errs[key]} > {tol}")
        stage1 = obs.SPANS["run/cluster"]
        warmup = obs.SPANS.get("run/warmup", 0.0)
        loop_s = result["wall_s"] - stage1 - warmup
        print(f"{tag}: {rounds} rounds, lloyd_step launches={launches}, "
              f"labels and winners as JAX's; max |d| test_loss="
              f"{errs['test_loss']!r} energy_std={errs['energy_std']!r} "
              f"test_acc={errs['test_acc']!r}; stage1_s={stage1!r} "
              f"(features {obs.SPANS['cluster/features']!r}, project "
              f"{obs.SPANS['cluster/project']!r}, kmeans "
              f"{obs.SPANS['cluster/kmeans']!r}) warmup_s={warmup!r} "
              f"s_per_round={loop_s / rounds!r} cohort_train_share="
              f"{obs.SPANS['cohort/train'] / loop_s!r} final test_loss="
              f"{result['test_loss'][-1]!r} test_acc="
              f"{result['test_acc'][-1]!r}", flush=True)
        total += launches
    return total


def max_err_vs(got, want, rtol, atol):
    """(max |got - want|, max of |got - want| / (atol + rtol |want|)):
    the second is at most 1 where every element lies within the
    bound."""
    d = (got.float() - want.float()).abs()
    return (float(d.max()),
            float((d / (atol + rtol * want.float().abs())).max()))


def train_step_path(cuda, card) -> None:
    """qwen2-0.5b's full CONFIG (24 layers, d_model 896, vocab 151,936,
    bf16, remat, chunked attention) trained by ``make_train_step`` for
    TRAIN_STEPS SGD steps on one fixed (TRAIN_BATCH, TRAIN_LEN) batch:
    the loss finite every step and falling; s a step, tokens/s, peak
    memory and the device-busy share of one more step.  Then the
    refusal of autograd through the flash kernel on the card, and the
    two hand-written backwards at this width against their plain
    autograd versions."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import rng
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import layers as L
    from repro_torch.models import model as MD

    cfg = get_config(ARCH)
    require(cfg.remat and cfg.attn_impl == "chunked"
            and cfg.dtype == "bfloat16", f"{cfg.name}: not the full config")
    params = MD.init_params(cfg, rng.PRNGKey(0), cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_LEN + 1),
                         device=cuda, generator=g)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "mask": torch.ones((TRAIN_BATCH, TRAIN_LEN), device=cuda)}
    step, opt_init = make_train_step(cfg, lr=TRAIN_LR)
    opt = opt_init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    for _ in range(TRAIN_STEPS):
        t = time.perf_counter()
        params, opt, loss = step(params, opt, batch)
        losses.append(float(loss))                 # waits for the step
        secs.append(time.perf_counter() - t)
    peak = torch.cuda.max_memory_allocated()
    require(all(math.isfinite(v) for v in losses),
            f"train step: non-finite loss {losses}")
    require(losses[-1] < losses[0],
            f"train step: loss did not fall over {TRAIN_STEPS} steps: "
            f"{losses}")
    s_step = statistics.median(secs[1:])
    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        params, opt, loss = step(params, opt, batch)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t
    rows = _kernel_rows(prof)
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    n_params = sum(v.numel() for v in MD.flatten_params(params).values())
    print(f"train step: {cfg.name} full width ({cfg.num_layers} layers, "
          f"{n_params} params, {cfg.dtype}, remat, {cfg.attn_impl}) "
          f"B={TRAIN_BATCH} S={TRAIN_LEN} lr={TRAIN_LR}: losses={losses} "
          f"step_s={secs} s_per_step={s_step!r} (median of the last "
          f"{TRAIN_STEPS - 1}) tokens_per_s="
          f"{TRAIN_BATCH * TRAIN_LEN / s_step!r} max_memory_allocated="
          f"{peak} B; profiled step: wall_s={wall!r} device_busy_s="
          f"{busy!r} busy_share={busy / wall!r} (of the profiled wall, "
          f"which the profiler's host work stretches; of an unprofiled "
          f"step: {busy / s_step!r}) kernel_launches="
          f"{sum(e.count for e in rows)} [{card}]", flush=True)
    for e in rows[:8]:
        print(f"  {e.key[:60]} count={e.count} "
              f"device_ms={e.self_device_time_total / 1e3!r}", flush=True)

    # ---- no backward through the flash kernel, on the card too --------
    flat = {k: v.detach().requires_grad_()
            for k, v in MD.flatten_params(params).items()}
    one = {k: v[:1] for k, v in batch.items()}
    try:
        MD.loss_fn(cfg.replace(attn_impl="pallas"), MD.nested_params(flat),
                   one)
    except NotImplementedError as e:
        print(f"train step, attn_impl='pallas': raises "
              f"NotImplementedError ({e})", flush=True)
    else:
        raise RuntimeError("chip_smoke check failed: autograd through "
                           "the flash kernel did not raise")
    del params, opt, flat, loss
    torch.cuda.empty_cache()

    # ---- chunked attention's backward at one layer's width ------------
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    q, k, v, dout = (torch.randn(1, TRAIN_LEN, h, hd, device=cuda,
                                 generator=g) for _ in range(4))
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(L.chunked_attention(*ins, causal=True),
                              ins, dout)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(L.naive_attention(*ins, causal=True), ins,
                               dout)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        err, share = max_err_vs(a, b, *ATTN_BWD_TOL)
        print(f"chunked_attention backward {name} (1, {TRAIN_LEN}, {h}, "
              f"{hd}) causal fp32 vs autograd through naive: "
              f"max_abs_err={err!r} share_of_bound={share!r} (rtol, atol "
              f"{ATTN_BWD_TOL})", flush=True)
        require(share <= 1.0, f"chunked_attention {name}: beyond "
                f"{ATTN_BWD_TOL}")
    del got, want, ins

    # ---- chunked_softmax_xent at the full vocab ------------------------
    d, vocab = cfg.d_model, cfg.vocab_size
    x = torch.randn(TRAIN_BATCH, TRAIN_LEN, d, device=cuda, generator=g)
    w = torch.randn(d, vocab, device=cuda, generator=g) / math.sqrt(d)
    lab = batch["labels"]
    xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
    val = L.chunked_softmax_xent(None, xs, ws, lab, batch["mask"])
    got = torch.autograd.grad(val, (xs, ws))
    xd, wd = x.clone().requires_grad_(), w.clone().requires_grad_()
    logp = torch.log_softmax(xd @ wd, dim=-1)
    direct = -logp.gather(-1, lab[..., None])[..., 0].mean()
    want = torch.autograd.grad(direct, (xd, wd))
    del logp
    val, direct = float(val.detach()), float(direct.detach())
    rel = abs(val - direct) / abs(direct)
    print(f"chunked_softmax_xent ({TRAIN_BATCH}, {TRAIN_LEN}, {vocab}) "
          f"fp32 vs the direct log-softmax: loss {val!r} vs {direct!r}, "
          f"rel_err={rel!r} (tol {XENT_VALUE_TOL})", flush=True)
    require(rel <= XENT_VALUE_TOL, f"xent value: {rel} > {XENT_VALUE_TOL}")
    for name, a, b in zip(("dx", "dw"), got, want):
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        print(f"chunked_softmax_xent {name}: max_abs_err={err!r} "
              f"max|want|={scale!r} rel_to_max={err / scale!r} (tol "
              f"{XENT_GRAD_TOL})", flush=True)
        require(err <= XENT_GRAD_TOL * scale,
                f"xent {name}: {err} > {XENT_GRAD_TOL} x {scale}")


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
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
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

    # ---- dynamics path --------------------------------------------------
    phase("dynamics path", t0)
    dyn_launches = dynamics_path(OPS, TRAIN, obs, servers, card)

    # ---- robust path ----------------------------------------------------
    phase("robust path", t0)
    robust_launches = robust_path(OPS, obs, card)

    # ---- transformer path -----------------------------------------------
    phase("transformer path", t0)
    tf_launches = transformer_path(OPS, TRAIN, obs, servers)

    # ---- selection path -------------------------------------------------
    phase("selection path", t0)
    selection_path(OPS, TRAIN, cuda)

    # ---- serving path --------------------------------------------------
    phase("serving path", t0)
    flash_launches = serving_path(OPS, cuda)

    # ---- full-width train step -------------------------------------------
    phase("full-width train step", t0)
    train_step_path(cuda, card)

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

    print(f"lloyd_step launches by path: dynamics {dyn_launches} (its "
          f"churn-0.1 run), robust {robust_launches} (26 a run), "
          f"transformer {tf_launches} (26 a run); the kernels line's "
          f"launches is their total, "
          f"{dyn_launches + robust_launches + tf_launches}", flush=True)
    print(json.dumps({"kernels": [
        row("lloyd_step", "src/repro_torch/csrc/kmeans.cu",
            "src/repro/kernels/kmeans.py:144",
            dyn_launches + robust_launches + tf_launches,
            shapes["main"], None),
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
