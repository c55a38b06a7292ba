"""granite-moe-3b-a800m's decode against its prefill in bfloat16 and in
float32, in the JAX package and in the port, on the CPU.

  PYTHONPATH=src JAX_PLATFORMS=cpu python tools/moe_bf16_witness.py \
      [--depths 4 8] [--tokens 256] [--dtypes bfloat16 float32] \
      [--out witness.json]

granite-moe-3b-a800m's CONFIG at full width (d_model 1,536, 40 experts
top-8, vocabulary 49,155) with the depth cut to ``--depths``, capacity
factor 8.0 (no token dropped at either shape), naive attention, the JAX
package's weights from PRNGKey(0) carried to the port: a prefill of
``--tokens`` tokens against as many teacher-forced decode steps of the
same tokens, judged by tests/test_models.py:117-139's rule (the share of
positions whose largest gap is within 2e-2 of the largest prefill
logit).  For each dtype, depth and package it prints that share, the
largest and median gap, and the (token, layer) pairs whose top-k expert
sets differ between decode and prefill; and the port's prefill against
the JAX package's.  The port's numbers on the CPU beside the JAX
package's tell a fault of the port from what the dtype does to the
rule.  About half an hour on 8 CPU cores at the defaults, and an hour
more for 16 layers; a granite layer holds 94 M parameters, so keep the
depths small on a shared machine.
"""
import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

ARCH = "granite-moe-3b-a800m"
TOL = 2e-2


def judge(dec, full, rd, rp):
    """dec, full: (S, V) float32; rd, rp: (layers, S, K) sorted expert
    ids -> the rule's numbers."""
    per_pos = np.abs(dec - full).max(-1) / np.abs(full).max()
    return {"share_within": float((per_pos < TOL).mean()),
            "max_rel": float(per_pos.max()),
            "median_rel": float(np.median(per_pos)),
            "flips": int((rd != rp).any(-1).sum()),
            "pairs": int(rd.shape[0] * rd.shape[1])}


def jax_run(dtype, layers, s):
    """The JAX package: (params as numpy, tokens, prefill logits, decode
    logits, prefill routes, decode routes)."""
    import jax
    import jax.numpy as jnp

    from repro.configs.registry import get_config
    from repro.models import model as MD
    from repro.models import moe as MOE

    cfg = get_config(ARCH).replace(dtype=dtype, num_layers=layers,
                                   attn_impl="naive", remat=False,
                                   moe_capacity_factor=8.0)
    routes = []
    orig = MOE.apply_moe

    def recording(p, x, c, **kw):
        probs = jax.nn.softmax(
            x.reshape(-1, x.shape[-1]).astype(jnp.float32) @ p["router"], -1)
        idx = jnp.sort(jax.lax.top_k(probs, c.experts_per_token)[1], -1)
        jax.debug.callback(lambda v: routes.append(np.asarray(v)), idx,
                           ordered=True)
        return orig(p, x, c, **kw)

    MOE.apply_moe = recording
    try:
        params = MD.init_params(cfg, jax.random.PRNGKey(0))
        toks = jax.random.randint(jax.random.PRNGKey(2), (1, s), 0,
                                  cfg.vocab_size)
        full = np.asarray(jax.jit(lambda p, t: MD.logits_fn(cfg, p, t))(
            params, toks)[0], np.float32)
        jax.effects_barrier()
        rp = np.stack(routes)
        routes.clear()
        step = jax.jit(lambda p, st, t, pos: MD.decode_step(cfg, p, st, t,
                                                            pos))
        state = MD.init_decode_state(cfg, 1, s)
        dec = []
        for t in range(s):
            lg, state = step(params, state, toks[:, t], jnp.int32(t))
            dec.append(np.asarray(lg[0], np.float32))
        jax.effects_barrier()
        rd = np.stack(routes).reshape(s, layers, -1).transpose(1, 0, 2)
    finally:
        MOE.apply_moe = orig
    host = jax.tree.map(lambda a: np.asarray(a), params)
    return host, np.asarray(toks), full, np.stack(dec), rp, rd


def port_run(dtype, layers, host, toks):
    """The port on the CPU with the JAX package's weights: (prefill
    logits, decode logits, prefill routes, decode routes)."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.interop import model_params_from_numpy
    from repro_torch.models import model as MD
    from repro_torch.models import moe as MOE

    cfg = get_config(ARCH).replace(dtype=dtype, num_layers=layers,
                                   attn_impl="naive", remat=False,
                                   moe_capacity_factor=8.0)
    params = model_params_from_numpy(host, cfg, "cpu")
    toks = torch.tensor(toks, dtype=torch.long)
    s = toks.shape[1]
    routes = []
    orig = MOE.moe_forward

    def recording(p, x, c, **kw):
        probs = MOE.router_probs(p, x.reshape(-1, x.shape[-1]))
        routes.append(MOE.top_k(probs, c.experts_per_token)[1]
                      .sort(-1).values.numpy())
        return orig(p, x, c, **kw)

    MOE.moe_forward = recording
    try:
        with torch.no_grad():
            full = MD.logits_fn(cfg, params, toks)[0].float().numpy()
            rp = np.stack(routes)
            routes.clear()
            state = MD.init_decode_state(cfg, 1, s, "cpu")
            dec = []
            for t in range(s):
                lg, state = MD.decode_step(cfg, params, state, toks[:, t], t)
                dec.append(lg[0].float().numpy())
            rd = np.stack(routes).reshape(s, layers, -1).transpose(1, 0, 2)
    finally:
        MOE.moe_forward = orig
    return full, np.stack(dec), rp, rd


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--depths", type=int, nargs="+", default=[4, 8])
    ap.add_argument("--tokens", type=int, default=256)
    ap.add_argument("--dtypes", nargs="+", default=["bfloat16"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    rows = []
    for dtype in args.dtypes:
        for layers in args.depths:
            host, toks, jf, jd, jrp, jrd = jax_run(dtype, layers,
                                                    args.tokens)
            pf, pd, prp, prd = port_run(dtype, layers, host, toks)
            del host
            row = {"dtype": dtype, "layers": layers, "tokens": args.tokens,
                   "jax": judge(jd, jf, jrd, jrp),
                   "port": judge(pd, pf, prd, prp),
                   "port_vs_jax_prefill": judge(pf, jf, prp, jrp)}
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(rows, indent=1) + "\n")


if __name__ == "__main__":
    main()
