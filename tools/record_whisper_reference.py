"""Record the JAX package's whisper-tiny at its full CONFIG in float32 for
chip_smoke.py's whisper serving phase.

  PYTHONPATH=src JAX_PLATFORMS=cpu python tools/record_whisper_reference.py

With ``init_params(CONFIG.replace(dtype="float32"), PRNGKey(0))`` (4
encoder and 4 decoder layers, d 384, 1,500 frames, vocabulary 51,865)
and the serve CLI's frames, float32 ``normal(fold_in(PRNGKey(0), 1), (2,
1500, 384))``, it records:

* ``serve``: the serve CLI's loop at batch 2 (prompts
  ``randint(fold_in(PRNGKey(0), 2), (2, 16))``, 15 teacher-forced steps,
  32 generated tokens): the prompts and the generated ids;
* ``forward``: ``logits_fn`` over 64 tokens ``randint(fold_in(PRNGKey(0),
  3), (2, 64))`` and the same frames: for each position its argmax, its
  largest logit and its log-sum-exp.

All of it goes, with the JAX version, into tools/whisper_reference.json,
which chip_smoke.py reads as JSON (no JAX import there).  About a minute
on one CPU.
"""
import json
import time
from pathlib import Path

OUT = Path(__file__).resolve().parents[1] / "tools" / "whisper_reference.json"
BATCH, PROMPT, GEN, FORWARD = 2, 16, 32, 64


def main() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.configs.whisper_tiny import CONFIG
    from repro.launch.steps import make_serve_step
    from repro.models import model as MD

    t = time.time()
    cfg = CONFIG.replace(dtype="float32")
    key = jax.random.PRNGKey(0)
    params = jax.jit(lambda k: MD.init_params(cfg, k))(key)
    frames = jax.random.normal(jax.random.fold_in(key, 1),
                               (BATCH, cfg.encoder_seq, cfg.d_model))
    enc = jax.jit(lambda p, f: MD.encode(cfg, p, f))(params, frames)

    # the serve CLI's loop (repro/launch/serve.py) at batch 2
    state = MD.init_decode_state(cfg, BATCH, PROMPT + GEN)
    state["cross"] = MD.build_cross_cache(cfg, params, enc)
    step = jax.jit(make_serve_step(cfg))
    prompts = jax.random.randint(jax.random.fold_in(key, 2),
                                 (BATCH, PROMPT), 0, cfg.vocab_size)
    tok = prompts[:, 0]
    for t_ in range(PROMPT - 1):
        _, state = step(params, state, prompts[:, t_], jnp.int32(t_))
        tok = prompts[:, t_ + 1]
    generated = []
    for t_ in range(GEN):
        tok, state = step(params, state, tok, jnp.int32(PROMPT - 1 + t_))
        generated.append(tok)

    tokens = jax.random.randint(jax.random.fold_in(key, 3),
                                (BATCH, FORWARD), 0, cfg.vocab_size)
    logits = jax.jit(lambda p, tk, f: MD.logits_fn(
        cfg, p, tk, encoder_frames=f))(params, tokens, frames)
    logits = np.asarray(logits, np.float32)
    OUT.write_text(json.dumps({
        "jax_version": jax.__version__,
        "config": "whisper-tiny CONFIG, dtype float32, attn_impl "
                  f"{cfg.attn_impl!r}",
        "serve": {"batch": BATCH, "prompt_len": PROMPT, "gen": GEN,
                  "prompts": np.asarray(prompts).tolist(),
                  "tokens": np.stack([np.asarray(g) for g in generated],
                                     1).tolist()},
        "forward": {"tokens": np.asarray(tokens).tolist(),
                    "argmax": logits.argmax(-1).tolist(),
                    "max": logits.max(-1).tolist(),
                    "logsumexp": np.asarray(jax.nn.logsumexp(
                        logits, axis=-1)).tolist()}}) + "\n")
    print(f"wrote {OUT} in {time.time() - t:.1f} s (jax {jax.__version__})",
          flush=True)


if __name__ == "__main__":
    main()
