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
8. Serving path at full width: qwen2-0.5b (24 layers, bf16, weights
   from ``init_params(cfg, PRNGKey(0))``) with ``attn_impl="pallas"``:
   ``logits_fn`` prefill of 4,096 tokens, counts reset before and read
   after (24 flash_attention launches), held against the plain
   ``attn_impl="naive"`` path; teacher-forced ``decode_step`` over 1,536
   tokens held against the kernel prefill; and ``serve`` of 4 x 32
   tokens, whose ids must be the argmax of the logits that made them.

It prints one JSON line with the kernels' numbers and, last, the JSON
status line.  ``--profile`` adds a torch.profiler pass before them:
device time by kernel for the fleet-shape Lloyd step, for one more
paper-path run on the sequential and on the vectorized runtime, for a
warm prefill and for 32 decode steps, and each
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
    for name in ("lloyd_step", "kmeans_assign", "flash_attention"):
        getattr(OPS, name).launches = 0
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
        for name in ("lloyd_step", "kmeans_assign", "flash_attention"):
            getattr(OPS, name).launches = 0
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
    for name in ("lloyd_step", "kmeans_assign", "flash_attention"):
        getattr(OPS, name).launches = 0
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
    for name in ("lloyd_step", "kmeans_assign", "flash_attention"):
        getattr(OPS, name).launches = 0
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

    # ---- serving path --------------------------------------------------
    phase("serving path", t0)
    flash_launches = serving_path(OPS, cuda)

    if "--profile" in sys.argv[1:]:
        phase("profile", t0)
        profile_pass(OPS, TRAIN)
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
