"""Batched greedy-decode serving driver of the port (the JAX package's
``repro.launch.serve``, same flags, plus ``--device``):

  python -m repro_torch.launch.serve --arch qwen2-0.5b \
      --batch 4 --prompt-len 16 --gen 32 [--device cpu]

The CLI serves the arch's reduced (smoke) config, with weights from
``init_params(cfg, PRNGKey(0))``, so its token ids match the JAX CLI's.
An encoder-decoder config (whisper) first encodes stub frames drawn as
the JAX CLI draws them, float32 ``normal(fold_in(PRNGKey(0), 1), (B,
encoder_seq, d_model))``, and fills the cross cache from them.  The
prompt is pre-filled by teacher-forced decode steps (a one-token
server).  The run is on the GPU unless ``--device cpu`` is given.
:func:`serve` is the loop as a function, for a caller that brings its own
config and weights.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import torch

from repro_torch import obs, rng
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_serve_step
from repro_torch.launch.train import set_float32_precision
from repro_torch.models import model as MD


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def encoder_frames(cfg: ModelConfig, batch: int,
                   device="cuda") -> torch.Tensor:
    """Stub frame embeddings (B, encoder_seq, d_model), float32, drawn
    as the JAX CLI draws them, from ``fold_in(PRNGKey(0), 1)``."""
    return rng.normal(rng.fold_in(rng.PRNGKey(0), 1),
                      (batch, cfg.encoder_seq, cfg.d_model), device)


def serve(cfg: ModelConfig, params, batch: int, prompt_len: int, gen: int,
          device="cuda") -> dict:
    """Greedy-decode ``gen`` tokens for ``batch`` random prompts of
    ``prompt_len`` tokens (drawn from ``fold_in(PRNGKey(0), 2)``, as the
    JAX CLI draws them); an encoder-decoder config encodes
    :func:`encoder_frames` first.  Returns the prompts (B, prompt_len),
    the generated ids (B, gen) int32, and the host seconds of the
    encoder and cross cache (0 without an encoder), of the prefill and of
    the generation (each ends in a device synchronise)."""
    device = resolve_device(device)
    state = MD.init_decode_state(cfg, batch, prompt_len + gen, device)
    serve_step = make_serve_step(cfg)
    t_enc = time.perf_counter()
    if cfg.is_encdec:
        frames = encoder_frames(cfg, batch, device=device)
        state["cross"] = MD.build_cross_cache(
            cfg, params, MD.encode(cfg, params, frames))
        _sync(device)
    prompts = rng.randint(rng.fold_in(rng.PRNGKey(0), 2), (batch, prompt_len),
                          0, cfg.vocab_size, device)
    t0 = time.perf_counter()
    # prefill via teacher-forced decode steps (one-token server)
    tok = prompts[:, 0]
    for t in range(prompt_len - 1):
        _, state = serve_step(params, state, prompts[:, t], t)
        tok = prompts[:, t + 1]
    _sync(device)
    t1 = time.perf_counter()
    generated = []
    pos = prompt_len - 1
    for t in range(gen):
        tok, state = serve_step(params, state, tok, pos + t)
        generated.append(tok)
    _sync(device)
    t2 = time.perf_counter()
    return {"prompts": prompts, "tokens": torch.stack(generated, dim=1),
            "encode_s": t0 - t_enc, "prefill_s": t1 - t0,
            "decode_s": t2 - t1}


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--kv-dtype", default=None,
                    choices=[None, "bfloat16", "int8"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the run executes (cuda raises without a "
                         "GPU; there is no silent CPU fallback)")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)
    obs.configure(quiet=args.quiet)
    set_float32_precision()
    device = resolve_device(args.device)

    cfg = get_smoke_config(args.arch)
    if args.kv_dtype:
        cfg = cfg.replace(kv_cache_dtype=args.kv_dtype)
    params = MD.init_params(cfg, rng.PRNGKey(0), device)
    out = serve(cfg, params, args.batch, args.prompt_len, args.gen, device)
    dt = out["decode_s"]
    obs.log(f"arch={cfg.name} batch={args.batch} generated {args.gen} "
            f"tokens/seq in {dt:.2f}s -> {args.batch * args.gen / dt:.1f} "
            f"tok/s (kv={cfg.kv_cache_dtype})")
    obs.log(f"sample token ids: {out['tokens'][0, :16].tolist()}")
    return out


if __name__ == "__main__":
    main()
