"""Serve a small model with batched greedy decoding (KV / recurrent caches),
including the int8-quantized KV cache option, on the PyTorch port
(``examples/serve_decode.py`` with ``repro_torch``).

  PYTHONPATH=src python examples/serve_decode_torch.py --arch xlstm-1.3b \
      [--device cpu]
  PYTHONPATH=src python examples/serve_decode_torch.py --arch starcoder2-3b \
      --kv-dtype int8
"""
import argparse
import time

import torch

from repro_torch import rng
from repro_torch.configs.registry import ARCH_IDS, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_serve_step
from repro_torch.launch.train import set_float32_precision
from repro_torch.models import model as MD


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b", choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--kv-dtype", default="auto",
                    choices=["auto", "bfloat16", "int8"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    set_float32_precision()
    device = resolve_device(args.device)

    cfg = get_smoke_config(args.arch).replace(kv_cache_dtype=args.kv_dtype)
    params = MD.init_params(cfg, rng.PRNGKey(0), device)
    B = args.batch
    state = MD.init_decode_state(cfg, B, args.gen + 8, device)
    if cfg.is_encdec:
        frames = rng.normal(rng.PRNGKey(1),
                            (B, cfg.encoder_seq, cfg.d_model), device)
        state["cross"] = MD.build_cross_cache(
            cfg, params, MD.encode(cfg, params, frames))
    step = make_serve_step(cfg)

    tok = torch.zeros((B,), dtype=torch.int32, device=device)
    toks = []
    t0 = time.time()
    for t in range(args.gen):
        tok, state = step(params, state, tok, t)
        toks.append(tok)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    print(f"{cfg.name}: {B}x{args.gen} tokens in {dt:.2f}s "
          f"({B*args.gen/dt:.0f} tok/s, kv={args.kv_dtype})")
    print("first sequence:", [int(t[0]) for t in toks][:12], "...")


if __name__ == "__main__":
    main()
