"""Model assembly: embeddings -> block groups -> norm -> LM head
(``repro.models.model``).

A config's ``cycle`` describes one period of the layer stack; the
parameters of each cycle position are stacked over ``num_groups`` (a
leading group axis, as the JAX package stacks them for its ``lax.scan``),
and the stack is applied by a Python loop over the groups.  A block's
mixer is attention, Mamba (``models.mamba``), mLSTM or sLSTM
(``models.xlstm``), and its FFN a dense MLP, an MoE (``models.moe``,
whose auxiliary load-balance losses the stack sums) or none.

An encoder-decoder config (whisper) adds learned positions and an
encoder: :func:`encode` runs its own stack of (attn, mlp) blocks,
non-causal, over stub frame embeddings; every attention block of an
encoder-decoder config, the encoder's included (as the JAX package
builds them), carries a cross-attention sublayer, which the decoder
applies to the encoder's output.  Decoding reads the encoder through a
cross cache (:func:`build_cross_cache`).  A multimodal prefix (the VLM)
takes the place of the first token embeddings in :func:`forward`;
decoding never reads it, as in the JAX package.

The JAX package's sharding constraints sit at its sites: the residual
stream entering each group is batch- and sequence-sharded, and under
save_block_out each saved sublayer output; they act only inside the dry
run's mesh (``sharding.constrain.use_mesh``) and return their argument
elsewhere.

With ``cfg.remat`` each block runs under ``torch.utils.checkpoint``
(non-reentrant), so the backward holds one block's activations at a
time: policy ``nothing`` recomputes the whole block, ``save_block_out``
keeps the mixer's and the FFN's outputs (one checkpoint per half).
Remat changes memory, not numbers.  ``torch.func`` transforms do not
compose with it, so under one a remat config raises.

The FL plane holds parameters as a flat dict of tensors
(:func:`flatten_params`): path keys joined with ``"."``, which sorts
below every character of a key, and zero-padded tuple indices, so the
sorted keys run in ``jax.tree.leaves`` order of the JAX tree.
:func:`nested_params` rebuilds the tree from the same tensors.

Public API:
  init_params(cfg, key, device)               -> params tree
  encode(cfg, params, frames)                 -> encoder output (B,Se,D)
  forward(cfg, params, tokens, ...)           -> (hidden (B,S,D), moe aux)
  loss_fn(cfg, params, batch)                 -> NLL + 0.01 * moe aux
  logits_fn(cfg, params, tokens, ...)         -> logits (B, S, V)
  flatten_params(tree) / nested_params(flat)  -> the flat view and back
  value_and_grad(loss, flat, batch)           -> (loss, grads by key)
  init_decode_state(cfg, batch, L, device)    -> decode cache tree
  build_cross_cache(cfg, params, enc_out)     -> the decoder's cross K/V
  decode_step(cfg, params, state, tok, pos)   -> (logits, state)
"""
from __future__ import annotations

from functools import partial
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import rng
from repro_torch.configs.base import BlockSpec, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as MOE
from repro_torch.models import xlstm as X
from repro_torch.sharding.constrain import maybe_constrain


# ----------------------------------------------------------------------
# init
# ----------------------------------------------------------------------

class Mixer(NamedTuple):
    """One mixer kind: ``init(key, cfg, device=)``, its full-sequence form
    ``apply(p, h, cfg, causal)``, its decode cache ``cache(cfg, batch,
    cache_len, lead, device)`` (``lead``: leading group axes) and its
    one-token step ``decode(p, h, cache, pos, cfg)``, which updates the
    cache in place."""
    init: Callable
    apply: Callable
    cache: Callable
    decode: Callable


def _attn_decode(p, h, cache, pos, cfg):
    return L.attention_decode(p, h, cache, pos, cfg)[0]


def _recurrent(init, apply, cache, step) -> Mixer:
    """A recurrent mixer, whose step returns its new state: copied into
    the cache's slots."""
    def decode(p, h, c, pos, cfg):
        out, new = step(p, h, c, cfg)
        for k, v in new.items():
            c[k].copy_(v)
        return out
    return Mixer(init, lambda p, h, cfg, causal: apply(p, h, cfg),
                 lambda cfg, b, n, lead, dev: cache(cfg, b, lead, device=dev),
                 decode)


MIXERS = {
    "attn": Mixer(
        L.init_attention,
        lambda p, h, cfg, causal: L.attention_train(p, h, cfg,
                                                    causal=causal),
        lambda cfg, b, n, lead, dev: L.init_kv_cache(cfg, b, n, lead,
                                                     device=dev),
        _attn_decode),
    "mamba": _recurrent(M.init_mamba, M.apply_mamba, M.init_mamba_cache,
                        M.decode_mamba),
    "mlstm": _recurrent(X.init_mlstm, X.apply_mlstm, X.init_mlstm_cache,
                        X.decode_mlstm),
    "slstm": _recurrent(X.init_slstm, X.apply_slstm, X.init_slstm_cache,
                        X.decode_slstm),
}


def _init_block(key, cfg: ModelConfig, spec, device):
    ks = rng.split(key, 6)
    dt = cfg.dtype
    p = {
        "ln1": L.init_norm(ks[0], cfg.d_model, dt, cfg.norm_kind,
                           device=device),
        "mixer": MIXERS[spec.mixer].init(ks[1], cfg, device=device),
    }
    if cfg.is_encdec and spec.mixer == "attn":
        # a cross-attention sublayer (on the encoder's blocks too, unused)
        p["ln_cross"] = L.init_norm(ks[4], cfg.d_model, dt, cfg.norm_kind,
                                    device=device)
        p["cross"] = L.init_attention(ks[5], cfg, device=device)
    if spec.ffn != "none":
        p["ln2"] = L.init_norm(ks[2], cfg.d_model, dt, cfg.norm_kind,
                               device=device)
        p["ffn"] = (MOE.init_moe(ks[3], cfg, device=device)
                    if spec.ffn == "moe"
                    else L.init_mlp(ks[3], cfg.d_model, cfg.d_ff, dt,
                                    cfg.mlp_kind, device=device))
    return p


def _stack(trees):
    """Stack a list of same-shaped dict trees along a new leading axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


# the encoder's one-position cycle
ENCODER_CYCLE = (BlockSpec("attn", "mlp"),)


def _init_block_stack(key, cfg: ModelConfig, device, *,
                      encoder: bool = False):
    """One stacked-param dict per cycle position, leading dim =
    num_groups (the encoder: encoder_layers); group g of position ``pos``
    draws from ``split(fold_in(key, pos), n)[g]``."""
    if encoder:
        n, cycle = cfg.encoder_layers, ENCODER_CYCLE
        cfg = cfg.replace(sliding_window=0)
    else:
        n, cycle = cfg.num_groups, cfg.cycle
    blocks = []
    for pos, spec in enumerate(cycle):
        keys = rng.split(rng.fold_in(key, pos), n)
        blocks.append(_stack([_init_block(k, cfg, spec, device)
                              for k in keys]))
    return tuple(blocks)


# rows of the decoder's learned position table
POS_EMBED_ROWS = 32_768


def init_params(cfg: ModelConfig, key, device="cuda") -> dict:
    device = resolve_device(device)
    ks = rng.split(key, 8)
    params = {
        "tok_embed": L.embed_init(ks[0], (cfg.vocab_size, cfg.d_model),
                                  cfg.dtype, device=device),
        "blocks": _init_block_stack(ks[1], cfg, device),
        "final_norm": L.init_norm(ks[2], cfg.d_model, cfg.dtype,
                                  cfg.norm_kind, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(ks[3], (cfg.d_model, cfg.vocab_size),
                                         cfg.dtype, device=device)
    if cfg.learned_pos:
        params["pos_embed"] = L.embed_init(
            ks[4], (POS_EMBED_ROWS, cfg.d_model), cfg.dtype, device=device)
    if cfg.is_encdec:
        params["enc"] = {
            "pos_embed": L.embed_init(ks[5], (cfg.encoder_seq, cfg.d_model),
                                      cfg.dtype, device=device),
            "blocks": _init_block_stack(ks[6], cfg, device, encoder=True),
            "final_norm": L.init_norm(ks[7], cfg.d_model, cfg.dtype,
                                      cfg.norm_kind, device=device),
        }
    return params


def lm_head_weight(cfg, params):
    return (params["tok_embed"].T if cfg.tie_embeddings
            else params["lm_head"])


def _group(tree, g: int):
    """Group g's parameters (or cache) of a stacked tree, as views."""
    if isinstance(tree, dict):
        return {k: _group(v, g) for k, v in tree.items()}
    return tree[g]


# ----------------------------------------------------------------------
# forward (prefill)
# ----------------------------------------------------------------------

def _cross(bp, x, cfg: ModelConfig, enc_out):
    """x + the cross-attention sublayer over the encoder output."""
    h = L.apply_norm(bp["ln_cross"], x, cfg.norm_eps)
    c = bp["cross"]
    return x + L.attention_train(c, h, cfg, causal=False,
                                 kv_override=L.kv_proj(c, enc_out, cfg))


def _block_out(cfg: ModelConfig, t):
    """A sublayer output that the save_block_out remat policy keeps: in
    the dry run's mesh it is saved seq-sharded, so the checkpoint costs
    B x S/16 x D a block."""
    if cfg.remat_policy != "save_block_out":
        return t
    return maybe_constrain(t, ("pod", "data"),
                           "model" if t.shape[1] % 16 == 0 else None, None)


def _mixer_half(bp, x, cfg: ModelConfig, spec, causal: bool, enc_out=None):
    """x + the mixer, then + the cross-attention sublayer where the block
    has one and an encoder output is given."""
    h = L.apply_norm(bp["ln1"], x, cfg.norm_eps)
    x = x + _block_out(cfg, MIXERS[spec.mixer].apply(bp["mixer"], h, cfg,
                                                     causal))
    if "cross" in bp and enc_out is not None:
        x = _cross(bp, x, cfg, enc_out)
    return x


def _ffn_half(bp, x, cfg: ModelConfig, spec):
    """(x + FFN(x), the block's MoE auxiliary loss or 0.0)."""
    h = L.apply_norm(bp["ln2"], x, cfg.norm_eps)
    if spec.ffn == "moe":
        y, aux = MOE.apply_moe(bp["ffn"], h, cfg)
        return x + _block_out(cfg, y), aux["moe_aux_loss"]
    return x + _block_out(cfg, L.apply_mlp(bp["ffn"], h, cfg)), 0.0


def _apply_block(bp, x, cfg: ModelConfig, spec, *, causal: bool,
                 enc_out=None):
    x = _mixer_half(bp, x, cfg, spec, causal, enc_out)
    if spec.ffn == "none":
        return x, 0.0
    return _ffn_half(bp, x, cfg, spec)


def _remat(fn, *args):
    return checkpoint(fn, *args, use_reentrant=False)


def _run_stack(blocks, x, cfg: ModelConfig, cycle, num_groups: int, *,
               causal: bool, enc_out=None):
    """Apply the grouped stack: groups in order, and within a group the
    cycle's positions in order; each block under remat with
    ``cfg.remat``.  Returns (x, the blocks' summed MoE auxiliary loss)."""
    if cfg.remat:
        if torch._C._functorch.peek_interpreter_stack() is not None:
            raise NotImplementedError(
                f"{cfg.name}: remat=True under a torch.func transform "
                "(torch.utils.checkpoint does not compose with "
                "torch.func); use cfg.replace(remat=False)")
        if cfg.remat_policy not in ("nothing", "save_block_out"):
            raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")
    # sequence-parallel activation carries (Megatron-SP analogue): in the
    # dry run's mesh the residual stream entering each group is sharded
    # (batch -> data, seq -> model); blocks re-gather the sequence inside
    seq_ok = x.shape[1] % 16 == 0
    aux_sum = 0.0
    for g in range(num_groups):
        x = maybe_constrain(x, ("pod", "data"), "model" if seq_ok else None,
                            None)
        for pos, spec in enumerate(cycle):
            bp = _group(blocks[pos], g)
            if not cfg.remat:
                x, aux = _apply_block(bp, x, cfg, spec, causal=causal,
                                      enc_out=enc_out)
            elif cfg.remat_policy == "nothing":
                # bound now: the backward recomputes after the loop moved on
                x, aux = _remat(partial(_apply_block, cfg=cfg, spec=spec,
                                        causal=causal, enc_out=enc_out),
                                bp, x)
            else:
                x, aux = _remat(_mixer_half, bp, x, cfg, spec, causal,
                                enc_out), 0.0
                if spec.ffn != "none":
                    x, aux = _remat(_ffn_half, bp, x, cfg, spec)
            aux_sum = aux_sum + aux
    return x, aux_sum


def encode(cfg: ModelConfig, params, frames: torch.Tensor) -> torch.Tensor:
    """The whisper-style encoder over stub frame embeddings (B, Se, D):
    learned positions, the encoder stack non-causal without a window, the
    final norm.  In JAX's promoted type: float32 frames run a bf16
    config's encoder in float32."""
    enc = params["enc"]
    x = frames + enc["pos_embed"][None, :frames.shape[1]]
    x, _ = _run_stack(enc["blocks"], x, cfg.replace(sliding_window=0),
                      ENCODER_CYCLE, cfg.encoder_layers, causal=False)
    return L.apply_norm(enc["final_norm"], x, cfg.norm_eps)


def forward(cfg: ModelConfig, params, tokens, *,
            prefix_embeddings: Optional[torch.Tensor] = None,
            encoder_frames: Optional[torch.Tensor] = None):
    """Returns (the final hidden states (B, S, D), the summed MoE
    auxiliary loss, 0.0 without MoE blocks).  ``prefix_embeddings``
    (B, P, D) take the place of the first P token embeddings (the
    multimodal prefix); an encoder-decoder config needs
    ``encoder_frames`` (B, Se, D) and fails without them with the JAX
    package's ``AssertionError``."""
    x = L.embed(params["tok_embed"], tokens)
    if prefix_embeddings is not None:
        P = prefix_embeddings.shape[1]
        x = torch.cat([prefix_embeddings.to(x.dtype), x[:, P:]], dim=1)
    if cfg.learned_pos:
        x = x + params["pos_embed"][None, :x.shape[1]]
    enc_out = None
    if cfg.is_encdec:
        if encoder_frames is None:
            raise AssertionError(f"{cfg.name}: an encoder-decoder forward "
                                 "needs encoder_frames")
        enc_out = encode(cfg, params, encoder_frames)
    x, aux = _run_stack(params["blocks"], x, cfg, cfg.cycle, cfg.num_groups,
                        causal=True, enc_out=enc_out)
    return L.apply_norm(params["final_norm"], x, cfg.norm_eps), aux


def loss_fn(cfg: ModelConfig, params, batch, *,
            aux_weight: float = 0.01) -> torch.Tensor:
    """batch: dict(tokens, labels, mask[, prefix_embeddings,
    encoder_frames]).  The mean masked next-token NLL plus ``aux_weight``
    times the summed MoE auxiliary loss (0.0 without MoE blocks, added
    all the same, as the JAX package adds it)."""
    x, aux = forward(cfg, params, batch["tokens"],
                     prefix_embeddings=batch.get("prefix_embeddings"),
                     encoder_frames=batch.get("encoder_frames"))
    nll = L.chunked_softmax_xent(None, x, lm_head_weight(cfg, params),
                                 batch["labels"], batch["mask"])
    return nll + aux_weight * aux


def logits_fn(cfg: ModelConfig, params, tokens, **kw):
    return forward(cfg, params, tokens, **kw)[0] @ lm_head_weight(cfg,
                                                                   params)


# ----------------------------------------------------------------------
# the flat view of the parameter tree
# ----------------------------------------------------------------------

SEP = "."


def flatten_params(tree: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The tree as a flat dict of the same tensors (no copies): a dict's
    keys and a tuple's zero-padded indices joined with ``SEP``.  Sorted,
    the keys run in ``jax.tree.leaves`` order of the JAX tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        width = len(str(max(len(tree) - 1, 0)))
        items = ((f"{i:0{width}d}", v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out: Dict[str, torch.Tensor] = {}
    for k, v in items:
        if min(k) <= SEP:
            raise ValueError(f"parameter key {k!r} holds a character that "
                             f"does not sort above {SEP!r}")
        out.update(flatten_params(v, f"{prefix}{SEP}{k}" if prefix else k))
    return out


def value_and_grad(loss, flat: Dict[str, torch.Tensor], batch
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss(flat, batch) detached, d loss / d flat as a dict with the
    flat view's keys), through ``torch.autograd``.  A leaf the loss does
    not use gets zeros, as ``jax.grad`` gives it (the cross-attention of
    whisper's encoder blocks)."""
    names = sorted(flat)
    leaves = [flat[k].detach().requires_grad_(True) for k in names]
    value = loss(dict(zip(names, leaves)), batch)
    grads = torch.autograd.grad(value, leaves, allow_unused=True,
                                materialize_grads=True)
    return value.detach(), dict(zip(names, grads))


def nested_params(flat: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Rebuild the tree from :func:`flatten_params`'s view (the same
    tensors; ``blocks`` and ``enc.blocks`` are tuples, as
    :func:`init_params` makes them)."""
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        *path, leaf = key.split(SEP)
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    for node in (tree, tree.get("enc", {})):
        blocks = node.get("blocks")
        if blocks is not None:
            node["blocks"] = tuple(blocks[i] for i in sorted(blocks))
    return tree


# ----------------------------------------------------------------------
# decode
# ----------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, batch: int, cache_len: int,
                      device="cuda"):
    """Self-attention / recurrent caches, one per cycle position, stacked
    over the groups; an encoder-decoder config adds the zeroed cross
    cache (num_groups, batch, encoder_seq, KV, hd), which
    :func:`build_cross_cache` replaces."""
    device = resolve_device(device)
    n = cfg.num_groups
    state = {"self": tuple(
        MIXERS[spec.mixer].cache(cfg, batch, cache_len, (n,), device)
        for spec in cfg.cycle)}
    if cfg.is_encdec:
        shape = (n, batch, cfg.encoder_seq, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        dt = L.torch_dtype(cfg.dtype)
        state["cross"] = {"k": torch.zeros(shape, dtype=dt, device=device),
                          "v": torch.zeros(shape, dtype=dt, device=device)}
    return state


def build_cross_cache(cfg: ModelConfig, params, enc_out: torch.Tensor):
    """The decoder's cross-attention K/V from the encoder output (B, Se,
    D): for each group, cycle position 0's ``cross`` projections, stacked
    to (num_groups, B, Se, KV, hd), in JAX's promoted type (float32 for
    float32 frames on a bf16 config)."""
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    B, S, _ = enc_out.shape
    c = params["blocks"][0]["cross"]
    ks, vs = [], []
    for g in range(c["wk"].shape[0]):
        cg = _group(c, g)
        ks.append(L._proj(enc_out, cg["wk"], cg.get("bk")).reshape(
            B, S, kv, hd))
        vs.append(L._proj(enc_out, cg["wv"], cg.get("bv")).reshape(
            B, S, kv, hd))
    return {"k": torch.stack(ks), "v": torch.stack(vs)}


def decode_step(cfg: ModelConfig, params, state, tokens, pos):
    """One greedy decode step.

    tokens: (B,) current token ids; pos: the position (int).  Returns
    (logits (B, V) float32, state); the caches in ``state`` are updated in
    place (a recurrent mixer's new state is copied into its slot).  An
    encoder-decoder config adds the learned position and, in each block
    with one, the cross-attention over ``state["cross"]``."""
    pos = int(pos)
    x = params["tok_embed"][tokens][:, None]              # (B,1,D)
    if cfg.learned_pos:
        x = x + params["pos_embed"][pos:pos + 1][None]
    cross = state.get("cross")
    for g in range(cfg.num_groups):
        for p_idx, spec in enumerate(cfg.cycle):
            bp = _group(params["blocks"][p_idx], g)
            cache = _group(state["self"][p_idx], g)
            h = L.apply_norm(bp["ln1"], x, cfg.norm_eps)
            x = x + MIXERS[spec.mixer].decode(bp["mixer"], h, cache, pos,
                                              cfg)
            if "cross" in bp and cross is not None:
                h = L.apply_norm(bp["ln_cross"], x, cfg.norm_eps)
                x = x + L.attention_decode(bp["cross"], h, _group(cross, g),
                                           pos, cfg, cross=True)[0]
            if spec.ffn != "none":
                h = L.apply_norm(bp["ln2"], x, cfg.norm_eps)
                if spec.ffn == "moe":
                    y = MOE.moe_forward(bp["ffn"], h, cfg)[0]
                else:
                    y = L.apply_mlp(bp["ffn"], h)
                x = x + y
    x = L.apply_norm(params["final_norm"], x, cfg.norm_eps)
    logits = (x[:, 0] @ lm_head_weight(cfg, params)).float()
    return logits, state
