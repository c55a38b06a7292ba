"""phi-3-vision-4.2b's teacher-forced decode against its prefix-free
forward, as chip_smoke.py's vlm serving path reads it, in bfloat16 and
in float32: the JAX package and the port on the CPU, or the port alone
on the card.

  PYTHONPATH=src JAX_PLATFORMS=cpu python tools/vlm_bf16_witness.py \\
      [--depths 2 4] [--tokens 256] [--dtypes bfloat16 float32] \\
      [--out witness.json]
  PYTHONPATH=src python tools/vlm_bf16_witness.py --device cuda \\
      [--depths 2 4 32] [--out witness.json]

phi-3-vision-4.2b's CONFIG at full width (d_model 3,072, 32 heads of 96,
d_ff 8,192, vocabulary 32,064) with the depth cut to ``--depths``, the
weights of PRNGKey(0) (the port's ``init_params`` is the JAX package's
bit for bit), ``--tokens`` tokens of PRNGKey(2) (chip_smoke.py's decode
tokens): a forward over the tokens against as many teacher-forced
decode steps.  The reading is chip_smoke.py's: the worst |decode -
forward| over the decoded positions divided by the forward's largest
|logit| over them, over the first 64 positions and over all of them;
beside it ``rms_rel``, the RMS gap over every logit relative to the
logits' RMS, which the bfloat16 logits' rounding steps quantize less.

On the CPU (the default) both packages run, the port on the JAX
package's weights carried across by ``interop``, and the port's forward
is read against the JAX package's; ``--no-excess-precision`` runs the
JAX package with ``--xla_allow_excess_precision=false`` (XLA then rounds
to bfloat16 after every op, as torch does, instead of keeping float32
inside its fusions).  With ``--device cuda`` the port runs
alone (no JAX import: the card's host has none), read twice on the same
weights: with the precision the entry points leave
(``launch.train.set_float32_precision``) and again with
``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
set to False, which stops cuBLAS from reducing a bfloat16 product's
split-K partial sums in bfloat16; the flag is restored after.  Each
reading prints as a JSON line; ``--out`` writes them all.  A phi-3 layer
holds 113 M parameters and the embedding and head 197 M: on 8 CPU
cores a row takes about 5 minutes at 2 layers and 10 at 4 in bfloat16
(3 and 6 in float32), and 4 layers hold about 10 GB in float32, so keep
the CPU's depths small; the card takes seconds a row at 32 layers.
"""
import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

ARCH = "phi-3-vision-4.2b"
FIRST = 64        # chip_smoke.py's VLM_DECODE read 0.0202 here at 64 steps


def reading(dec: np.ndarray, full: np.ndarray) -> dict:
    """dec, full: (S, V) float32 -> chip_smoke.py's measure over the first
    FIRST positions and over all S, with the worst position of each."""
    gap = np.abs(dec - full).max(-1)
    out = {}
    for name, n in ((f"first_{FIRST}", min(FIRST, len(gap))),
                    (f"all_{len(gap)}", len(gap))):
        rel = gap[:n] / np.abs(full[:n]).max()
        out[name] = {"max_rel": float(rel.max()),
                     "at": int(rel.argmax()),
                     "median_rel": float(np.median(rel))}
    out["largest_logit"] = float(np.abs(full).max())
    # a smoother reading: the RMS gap over every logit of every position
    out["rms_rel"] = float(np.sqrt(np.mean((dec - full) ** 2)
                                   / np.mean(full ** 2)))
    return out


def _cfg(get_config, dtype, layers):
    return get_config(ARCH).replace(dtype=dtype, num_layers=layers,
                                    attn_impl="naive", remat=False)


def jax_run(dtype: str, layers: int, s: int):
    """The JAX package: (params as numpy, tokens, forward logits, decode
    logits)."""
    import jax
    import jax.numpy as jnp

    from repro.configs.registry import get_config
    from repro.models import model as MD

    cfg = _cfg(get_config, dtype, layers)
    params = MD.init_params(cfg, jax.random.PRNGKey(0))
    toks = jax.random.randint(jax.random.PRNGKey(2), (1, s), 0,
                              cfg.vocab_size)
    full = np.asarray(jax.jit(lambda p, t: MD.logits_fn(cfg, p, t))(
        params, toks)[0], np.float32)
    step = jax.jit(lambda p, st, t, pos: MD.decode_step(cfg, p, st, t, pos))
    state = MD.init_decode_state(cfg, 1, s)
    dec = []
    for t in range(s):
        lg, state = step(params, state, toks[:, t], jnp.int32(t))
        dec.append(np.asarray(lg[0], np.float32))
    host = jax.tree.map(np.asarray, params)
    return host, np.asarray(toks), full, np.stack(dec)


def port_run(cfg, params, toks):
    """The port on ``toks``' device: (forward logits, decode logits), as
    float32 numpy."""
    import torch

    from repro_torch.models import model as MD

    s = toks.shape[1]
    with torch.no_grad():
        full = MD.logits_fn(cfg, params, toks)[0].float()
        state = MD.init_decode_state(cfg, 1, s, toks.device)
        dec = []
        for t in range(s):
            lg, state = MD.decode_step(cfg, params, state, toks[:, t], t)
            dec.append(lg[0])
        dec = torch.stack(dec)
    return full.cpu().numpy(), dec.float().cpu().numpy()


def cpu_rows(dtype: str, layers: int, s: int) -> list:
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.interop import model_params_from_numpy

    t0 = time.perf_counter()
    host, toks, jf, jd = jax_run(dtype, layers, s)
    cfg = _cfg(get_config, dtype, layers)
    params = model_params_from_numpy(host, cfg, "cpu")
    del host
    pf, pd = port_run(cfg, params, torch.tensor(toks, dtype=torch.long))
    row = {"device": "cpu", "dtype": dtype, "layers": layers, "tokens": s,
           "xla_flags": os.environ.get("XLA_FLAGS", ""),
           "jax": reading(jd, jf), "port": reading(pd, pf),
           "port_vs_jax_forward": reading(pf, jf),
           "seconds": time.perf_counter() - t0}
    return [row]


def card_name() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def cuda_rows(dtype: str, layers: int, s: int) -> list:
    import torch

    from repro_torch import rng
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.train import set_float32_precision
    from repro_torch.models import model as MD

    dev = torch.device("cuda")
    cfg = _cfg(get_config, dtype, layers)
    params = MD.init_params(cfg, rng.PRNGKey(0), dev)
    toks = rng.randint(rng.PRNGKey(2), (1, s), 0, cfg.vocab_size, dev)
    matmul = torch.backends.cuda.matmul
    set_float32_precision()
    entry = matmul.allow_bf16_reduced_precision_reduction
    rows = []
    try:
        for flag in (entry, False):
            matmul.allow_bf16_reduced_precision_reduction = flag
            t0 = time.perf_counter()
            pf, pd = port_run(cfg, params, toks)
            rows.append({"device": "cuda", "card": card_name(),
                         "dtype": dtype, "layers": layers, "tokens": s,
                         "allow_bf16_reduced_precision_reduction": flag,
                         "port": reading(pd, pf),
                         "seconds": time.perf_counter() - t0})
    finally:
        matmul.allow_bf16_reduced_precision_reduction = entry
    del params
    torch.cuda.empty_cache()
    return rows


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--depths", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--tokens", type=int, default=256)
    ap.add_argument("--dtypes", nargs="+", default=["bfloat16", "float32"])
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    ap.add_argument("--no-excess-precision", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.no_excess_precision:    # read when JAX starts its backend
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                                   " --xla_allow_excess_precision=false")
    rows = []
    for dtype in args.dtypes:
        for layers in args.depths:
            new = (cpu_rows(dtype, layers, args.tokens)
                   if args.device == "cpu" else
                   cuda_rows(dtype, layers, args.tokens))
            for row in new:
                rows.append(row)
                print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(rows, indent=1) + "\n")


if __name__ == "__main__":
    main()
