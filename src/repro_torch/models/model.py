"""Model assembly: embeddings -> block groups -> norm -> LM head
(``repro.models.model`` for the dense stack).

A config's ``cycle`` describes one period of the layer stack; the
parameters of each cycle position are stacked over ``num_groups`` (a
leading group axis, as the JAX package stacks them for its ``lax.scan``),
and the stack is applied by a Python loop over the groups.  The port runs
dense cycles of ``("attn", "mlp")`` blocks without an encoder; every
other config raises ``NotImplementedError`` (ROADMAP.md, queue 1: the
rest of the model zoo).

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
  forward(cfg, params, tokens, ...)           -> final hidden states (B,S,D)
  loss_fn(cfg, params, batch)                 -> mean next-token NLL
  logits_fn(cfg, params, tokens, ...)         -> logits (B, S, V)
  flatten_params(tree) / nested_params(flat)  -> the flat view and back
  value_and_grad(loss, flat, batch)           -> (loss, grads by key)
  init_decode_state(cfg, batch, L, device)    -> decode cache tree
  decode_step(cfg, params, state, tok, pos)   -> (logits, state)
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import rng
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L


def check_supported(cfg: ModelConfig, *, decode: bool = False) -> None:
    """Refuse every config whose blocks the port does not have yet."""
    unported = [f"{b.mixer}/{b.ffn} blocks" for b in cfg.cycle
                if (b.mixer, b.ffn) != ("attn", "mlp")]
    if cfg.is_encdec:
        unported.append("the encoder-decoder (cross-attention) path")
    if cfg.learned_pos:
        unported.append("learned positions")
    if decode and cfg.num_prefix_tokens:
        unported.append("the multimodal prefix at decode time")
    if unported:
        raise NotImplementedError(
            f"{cfg.name}: not ported yet (ROADMAP.md, queue 1: the rest "
            "of the model zoo): "
            + ", ".join(unported))


# ----------------------------------------------------------------------
# init
# ----------------------------------------------------------------------

def _init_block(key, cfg: ModelConfig, device):
    ks = rng.split(key, 6)
    dt = cfg.dtype
    return {
        "ln1": L.init_norm(ks[0], cfg.d_model, dt, cfg.norm_kind,
                           device=device),
        "mixer": L.init_attention(ks[1], cfg, device=device),
        "ln2": L.init_norm(ks[2], cfg.d_model, dt, cfg.norm_kind,
                           device=device),
        "ffn": L.init_mlp(ks[3], cfg.d_model, cfg.d_ff, dt, cfg.mlp_kind,
                          device=device),
    }


def _stack(trees):
    """Stack a list of same-shaped dict trees along a new leading axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _init_block_stack(key, cfg: ModelConfig, device):
    """One stacked-param dict per cycle position, leading dim =
    num_groups; group g of position ``pos`` draws from
    ``split(fold_in(key, pos), num_groups)[g]``."""
    blocks = []
    for pos in range(cfg.cycle_len):
        keys = rng.split(rng.fold_in(key, pos), cfg.num_groups)
        blocks.append(_stack([_init_block(k, cfg, device) for k in keys]))
    return tuple(blocks)


def init_params(cfg: ModelConfig, key, device="cuda") -> dict:
    check_supported(cfg)
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

def _mixer_half(bp, x, cfg: ModelConfig, causal: bool):
    h = L.apply_norm(bp["ln1"], x, cfg.norm_eps)
    return x + L.attention_train(bp["mixer"], h, cfg, causal=causal)


def _ffn_half(bp, x, cfg: ModelConfig):
    h = L.apply_norm(bp["ln2"], x, cfg.norm_eps)
    return x + L.apply_mlp(bp["ffn"], h, cfg)


def _apply_block(bp, x, cfg: ModelConfig, *, causal: bool):
    return _ffn_half(bp, _mixer_half(bp, x, cfg, causal), cfg)


def _remat(fn, *args):
    return checkpoint(fn, *args, use_reentrant=False)


def _run_stack(blocks, x, cfg: ModelConfig, *, causal: bool):
    """Apply the grouped stack: groups in order, and within a group the
    cycle's positions in order; each block under remat with
    ``cfg.remat``."""
    if cfg.remat:
        if torch._C._functorch.peek_interpreter_stack() is not None:
            raise NotImplementedError(
                f"{cfg.name}: remat=True under a torch.func transform "
                "(torch.utils.checkpoint does not compose with "
                "torch.func); use cfg.replace(remat=False)")
        if cfg.remat_policy not in ("nothing", "save_block_out"):
            raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")
    for g in range(cfg.num_groups):
        for pos in range(cfg.cycle_len):
            bp = _group(blocks[pos], g)
            if not cfg.remat:
                x = _apply_block(bp, x, cfg, causal=causal)
            elif cfg.remat_policy == "nothing":
                x = _remat(lambda b, t: _apply_block(b, t, cfg,
                                                     causal=causal), bp, x)
            else:
                x = _remat(_mixer_half, bp, x, cfg, causal)
                x = _remat(_ffn_half, bp, x, cfg)
    return x


def forward(cfg: ModelConfig, params, tokens, *,
            prefix_embeddings: Optional[torch.Tensor] = None):
    """Returns the final hidden states (B, S, D).  ``prefix_embeddings``
    (B, P, D) take the place of the first P token embeddings (the
    multimodal prefix)."""
    check_supported(cfg)
    x = params["tok_embed"][tokens]
    if prefix_embeddings is not None:
        P = prefix_embeddings.shape[1]
        x = torch.cat([prefix_embeddings.to(x.dtype), x[:, P:]], dim=1)
    x = _run_stack(params["blocks"], x, cfg, causal=True)
    return L.apply_norm(params["final_norm"], x, cfg.norm_eps)


def loss_fn(cfg: ModelConfig, params, batch, *,
            aux_weight: float = 0.01) -> torch.Tensor:
    """batch: dict(tokens, labels, mask[, prefix_embeddings]).  The mean
    masked next-token NLL plus ``aux_weight`` times the MoE auxiliary
    loss, which is 0.0 on the dense stack (added all the same, as the
    JAX package adds it)."""
    x = forward(cfg, params, batch["tokens"],
                prefix_embeddings=batch.get("prefix_embeddings"))
    aux = torch.zeros((), device=x.device)
    nll = L.chunked_softmax_xent(None, x, lm_head_weight(cfg, params),
                                 batch["labels"], batch["mask"])
    return nll + aux_weight * aux


def logits_fn(cfg: ModelConfig, params, tokens, **kw):
    return forward(cfg, params, tokens, **kw) @ lm_head_weight(cfg, params)


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
    flat view's keys), through ``torch.autograd``."""
    names = sorted(flat)
    leaves = [flat[k].detach().requires_grad_(True) for k in names]
    value = loss(dict(zip(names, leaves)), batch)
    grads = torch.autograd.grad(value, leaves)
    return value.detach(), dict(zip(names, grads))


def nested_params(flat: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Rebuild the tree from :func:`flatten_params`'s view (the same
    tensors; ``blocks`` is a tuple, as :func:`init_params` makes it)."""
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        *path, leaf = key.split(SEP)
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    blocks = tree.get("blocks")
    if blocks is not None:
        tree["blocks"] = tuple(blocks[i] for i in sorted(blocks))
    return tree


# ----------------------------------------------------------------------
# decode
# ----------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, batch: int, cache_len: int,
                      device="cuda"):
    """Self-attention caches, one per cycle position, stacked over the
    groups."""
    check_supported(cfg, decode=True)
    device = resolve_device(device)
    return {"self": tuple(
        L.init_kv_cache(cfg, batch, cache_len, (cfg.num_groups,),
                        device=device)
        for _ in cfg.cycle)}


def decode_step(cfg: ModelConfig, params, state, tokens, pos):
    """One greedy decode step.

    tokens: (B,) current token ids; pos: the position (int).  Returns
    (logits (B, V) float32, state); the caches in ``state`` are updated in
    place."""
    check_supported(cfg, decode=True)
    pos = int(pos)
    x = params["tok_embed"][tokens][:, None]              # (B,1,D)
    for g in range(cfg.num_groups):
        for p_idx in range(cfg.cycle_len):
            bp = _group(params["blocks"][p_idx], g)
            cache = _group(state["self"][p_idx], g)
            h = L.apply_norm(bp["ln1"], x, cfg.norm_eps)
            mixed, _ = L.attention_decode(bp["mixer"], h, cache, pos, cfg)
            x = x + mixed
            h = L.apply_norm(bp["ln2"], x, cfg.norm_eps)
            x = x + L.apply_mlp(bp["ffn"], h)
    x = L.apply_norm(params["final_norm"], x, cfg.norm_eps)
    logits = (x[:, 0] @ lm_head_weight(cfg, params)).float()
    return logits, state
