"""xlstm-1.3b's decode-vs-prefill gap against depth, in the JAX package
and in the port, on the CPU, in float32 and in bfloat16.

  PYTHONPATH=src JAX_PLATFORMS=cpu python tools/xlstm_depth_gap.py \
      [--dtypes float32 bfloat16] [--depths 4 12 24 48] [--out gap.json]

xlstm-1.3b's CONFIG at full width and depth (48 blocks, d_model 2,048,
4 heads of 512) with the vocabulary cut to 512, the JAX package's
weights from PRNGKey(0) shared with the port (whose ``init_params``
draws the same bits, tests/test_torch_zoo.py, but slowly on the CPU
at this size), evaluated at the
first ``--depths`` blocks (whole 4-block periods; the model holds
as many as the largest): a 12-token
prefill against 12 teacher-forced decode steps of the same tokens, for
each of the token draws PRNGKey(SEEDS).  For each dtype, depth and draw
it prints, over the positions, the largest and the median gap over the
largest prefill logit in each package, and the port's prefill and decode
against the JAX package's.  Then, for every block of the largest depth,
each given the JAX package's prefill input to it over BLOCK_TOKENS
tokens, each package's gap between the block's decode and its
full-sequence form over its largest output (``--no-blocks`` skips it).

At random weights the gap grows with depth in both packages: the
mLSTM's normaliser divides by max(|q . n|, exp(-m)), which nears zero,
so the stack amplifies a last-place difference at block 0 by the same
factor whichever package made it.  The port's prefill against the JAX
package's shows that factor on an independent pair of roundings; the
per-block gaps show what each package puts in.  chip_smoke.py holds
xlstm's decode to its full-sequence form block by block for that
reason, in both dtypes.  About an hour on 8 CPU cores (bf16 is the
slower half); the 48-layer float32 model holds 4.6 GB.
"""
import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

ARCH = "xlstm-1.3b"
DEPTHS = (4, 12, 24, 48)
SEEDS = (2, 3, 4)
S = 12
BLOCK_TOKENS = 128
VOCAB = 512


def gaps(got, want):
    """(largest, median) over positions of the largest |got - want| at a
    position, over the largest |want|."""
    per_pos = np.abs(got - want).max(-1) / np.abs(want).max()
    return float(per_pos.max()), float(np.median(per_pos))


def jax_side(dtype, layers_all, depths, blocks):
    """{(depth, seed): (prefill (S, V), decode (S, V))} over ``depths``;
    with ``blocks`` each block's gap (its decode against its full form
    over BLOCK_TOKENS, given the prefill's input) and those inputs; and
    the weights (numpy)."""
    import jax
    import jax.numpy as jnp

    from repro.configs.registry import get_config
    from repro.models import layers as L
    from repro.models import model as MD
    from repro.models import xlstm as X

    cfg = get_config(ARCH).replace(dtype=dtype, vocab_size=VOCAB,
                                   remat=False, num_layers=layers_all)
    params = MD.init_params(cfg, jax.random.PRNGKey(0))
    out = {}
    for layers in depths:
        c = cfg.replace(num_layers=layers)
        n = layers // cfg.cycle_len
        sub = dict(params, blocks=tuple(
            jax.tree.map(lambda a: a[:n], b) for b in params["blocks"]))
        fwd = jax.jit(lambda p, t: MD.logits_fn(c, p, t))
        step = jax.jit(lambda p, st, t, pos: MD.decode_step(c, p, st, t,
                                                            pos))
        for seed in SEEDS:
            toks = jax.random.randint(jax.random.PRNGKey(seed), (1, S), 0,
                                      VOCAB)
            full = np.asarray(fwd(sub, toks)[0], np.float32)
            state = MD.init_decode_state(c, 1, S)
            dec = []
            for t in range(S):
                lg, state = step(sub, state, toks[:, t], jnp.int32(t))
                dec.append(np.asarray(lg[0], np.float32))
            out[layers, seed] = (full, np.stack(dec))
        del sub
    inputs, block_gaps = [], []
    if blocks:
        apply = {"mlstm": X.apply_mlstm, "slstm": X.apply_slstm}
        step = {"mlstm": jax.jit(lambda p, x, c: X.decode_mlstm(p, x, c, cfg)),
                "slstm": jax.jit(lambda p, x, c: X.decode_slstm(p, x, c, cfg))}
        cache = {"mlstm": X.init_mlstm_cache, "slstm": X.init_slstm_cache}
        toks = jax.random.randint(jax.random.PRNGKey(SEEDS[0]),
                                  (1, BLOCK_TOKENS), 0, VOCAB)
        x = params["tok_embed"][toks]
        for g in range(cfg.num_groups):
            for pos, spec in enumerate(cfg.cycle):
                bp = jax.tree.map(lambda a: a[g], params["blocks"][pos])
                inputs.append(np.asarray(x.astype(jnp.float32)))
                h = L.apply_norm(bp["ln1"], x, cfg.norm_eps)
                full = apply[spec.mixer](bp["mixer"], h, cfg)
                st = cache[spec.mixer](cfg, 1)
                outs = []
                for t in range(BLOCK_TOKENS):
                    o, st = step[spec.mixer](bp["mixer"], h[:, t:t + 1], st)
                    outs.append(o)
                dec = jnp.concatenate(outs, 1).astype(jnp.float32)
                full32 = full.astype(jnp.float32)
                block_gaps.append(float(jnp.abs(dec - full32).max()
                                        / jnp.abs(full32).max()))
                x = x + full
    return out, block_gaps, inputs, jax.tree.map(np.asarray, params)


def port_side(dtype, layers_all, depths, inputs, host):
    """As :func:`jax_side`, on the JAX package's weights ``host``, each
    block given the JAX package's input to it."""
    import torch

    from repro_torch import rng
    from repro_torch.configs.registry import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import model as MD

    cfg = get_config(ARCH).replace(dtype=dtype, vocab_size=VOCAB,
                                   remat=False, num_layers=layers_all)
    with torch.no_grad():
        params = _shared(host)
        out = {}
        for layers in depths:
            c = cfg.replace(num_layers=layers)
            n = layers // cfg.cycle_len
            sub = dict(params, blocks=tuple(
                {k: _slice(v, n) for k, v in b.items()}
                for b in params["blocks"]))
            for seed in SEEDS:
                toks = rng.randint(rng.PRNGKey(seed), (1, S), 0, VOCAB,
                                   "cpu")
                full = MD.logits_fn(c, sub, toks)[0].float().numpy()
                state = MD.init_decode_state(c, 1, S, "cpu")
                dec = []
                for t in range(S):
                    lg, state = MD.decode_step(c, sub, state, toks[:, t], t)
                    dec.append(lg[0].float().numpy())
                out[layers, seed] = (full, np.stack(dec))
        block_gaps = []
        for i, x in enumerate(inputs):
            g, pos = divmod(i, cfg.cycle_len)
            bp = _at(params["blocks"][pos], g)
            mixer = MD.MIXERS[cfg.cycle[pos].mixer]
            x = torch.tensor(x).to(params["tok_embed"].dtype)
            h = L.apply_norm(bp["ln1"], x, cfg.norm_eps)
            full = mixer.apply(bp["mixer"], h, cfg, True).float()
            cache = mixer.cache(cfg, 1, BLOCK_TOKENS, (), "cpu")
            dec = torch.cat([mixer.decode(bp["mixer"], h[:, t:t + 1], cache,
                                          t, cfg)
                             for t in range(BLOCK_TOKENS)], 1).float()
            block_gaps.append(float((dec - full).abs().max()
                                    / full.abs().max()))
    return out, block_gaps


def _shared(tree):
    """numpy leaves (float32 or ml_dtypes' bfloat16) -> torch tensors on
    the same memory."""
    import torch
    if isinstance(tree, dict):
        return {k: _shared(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_shared(v) for v in tree)
    if tree.dtype.name == "bfloat16":
        return torch.from_numpy(tree.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(tree)


def _slice(tree, n):
    if isinstance(tree, dict):
        return {k: _slice(v, n) for k, v in tree.items()}
    return tree[:n]


def _at(tree, g):
    if isinstance(tree, dict):
        return {k: _at(v, g) for k, v in tree.items()}
    return tree[g]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtypes", nargs="+", default=["float32", "bfloat16"])
    ap.add_argument("--depths", type=int, nargs="+", default=list(DEPTHS))
    ap.add_argument("--no-blocks", action="store_true",
                    help="skip the per-block gaps")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    rows = []
    for dtype in args.dtypes:
        layers_all = max(args.depths)
        jax_out, jax_blocks, inputs, host = jax_side(
            dtype, layers_all, args.depths, not args.no_blocks)
        port_out, port_blocks = port_side(dtype, layers_all, args.depths,
                                          inputs, host)
        del host
        for (layers, seed), (jf, jd) in jax_out.items():
            pf, pd = port_out[layers, seed]
            row = {"dtype": dtype, "layers": layers, "token_seed": seed,
                   "jax_decode_vs_prefill": gaps(jd, jf),
                   "port_decode_vs_prefill": gaps(pd, pf),
                   "port_vs_jax_prefill": gaps(pf, jf),
                   "port_vs_jax_decode": gaps(pd, jd)}
            rows.append(row)
            print(json.dumps(row), flush=True)
        row = {"dtype": dtype, "layers": layers_all,
               "tokens": BLOCK_TOKENS, "block_gaps": {
                   "jax": jax_blocks, "port": port_blocks}}
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(rows, indent=1) + "\n")


if __name__ == "__main__":
    main()
