"""Mixture-of-Experts layer (``repro.models.moe``).

Capacity-factor routing with a scatter dispatch, as the JAX package's
group-local dispatch at one group: the JAX package splits the tokens
into G groups, one per shard of its ``data`` mesh axis, and has G = 1
without a mesh.  The port keeps G = 1 in the dry run's mesh too (its
capacity is then the whole batch's, where JAX's is a group's), and
places the JAX package's ``maybe_constrain`` hints on the ungrouped
tensors (tokens over ``data``, D over ``model`` around the scatter and
the gather, experts over ``model`` in the expert FFN); outside a mesh
they return their argument.

  1. the router (float32) gives each token its top-k experts; a tie goes
     to the lower expert index, as ``lax.top_k`` orders it;
  2. each (token, slot) gets its rank within its expert from a cumulative
     sum of the one-hot over the flattened (token, slot) axis, token-major;
     ranks >= C are dropped into the bucket row ``E * C``;
  3. tokens are scattered into an (E * C + 1, D) buffer, the experts run
     as batched matmuls over (E, C, D), and the results are gathered back
     and combined with the router gates.

Which tokens are dropped is an integer result: on the same router
probabilities it is JAX's, bit for bit.  ``C = min(moe_capacity(T), T *
K)`` depends on the call's token count, so a decode step and a prefill
drop differently, as in JAX.  :func:`apply_moe` adds the auxiliary
losses to :func:`moe_forward`, which a decode step calls alone (the
reference's decode discards them, and XLA drops them as dead code).
Every op is out of place, so the batched
FL runtimes' ``torch.func.vmap(torch.func.grad(loss))`` runs through
the layer.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as Fn

from repro_torch import rng
from repro_torch.models.layers import dense_init, torch_dtype
from repro_torch.sharding.constrain import fold, maybe_constrain


def init_moe(key, cfg, *, device="cuda") -> Dict[str, torch.Tensor]:
    e = cfg.num_experts
    d = cfg.d_model
    f = cfg.d_ff_expert or cfg.d_ff
    dt = torch_dtype(cfg.dtype)
    ks = rng.split(key, 4)
    return {
        "router": dense_init(ks[0], (d, e), torch.float32, device=device),
        "w_gate": dense_init(ks[1], (e, d, f), dt, device=device),
        "w_up": dense_init(ks[2], (e, d, f), dt, device=device),
        "w_down": dense_init(ks[3], (e, f, d), dt, device=device),
    }


def moe_capacity(tokens_per_group: int, cfg) -> int:
    per = tokens_per_group * cfg.experts_per_token / cfg.num_experts
    cap = int(per * cfg.moe_capacity_factor) + 1
    return -(-cap // 8) * 8        # multiple of 8, as the JAX package


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` along the last axis: the k largest values, largest
    first, and on a tie the lower index first (a stable descending sort;
    ``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(probs: torch.Tensor, cfg, capacity: int):
    """Routing of T tokens from their (T, E) router probabilities:
    (gates (T, K) renormalised, idx (T, K), keep (T*K,) bool, slot
    (T*K,) int64 with the drop bucket E*C, counts (E,) of the (token,
    slot) pairs sent to each expert)."""
    E, K = cfg.num_experts, cfg.experts_per_token
    gates, idx = top_k(probs, K)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    flat_e = idx.reshape(-1)                                   # (T*K,)
    onehot = (flat_e[:, None] == torch.arange(                 # (T*K, E)
        E, device=flat_e.device)).long()
    ranks = torch.cumsum(onehot, dim=0) - onehot
    rank = ranks.gather(1, flat_e[:, None])[:, 0]
    keep = rank < capacity
    slot = torch.where(keep, flat_e * capacity + rank,
                       torch.full_like(flat_e, E * capacity))
    return gates, idx, keep, slot, onehot.sum(0)


def _recip(n: int) -> float:
    """1 / n rounded to float32."""
    return float(np.float32(1.0) / np.float32(n))


def router_probs(p, xt: torch.Tensor) -> torch.Tensor:
    """(T, D) tokens -> (T, E) float32 router probabilities."""
    return torch.softmax(xt.float() @ p["router"], dim=-1)


def apply_moe(p, x: torch.Tensor, cfg, *, capacity: int = None):
    """x: (B, S, D) -> ((B, S, D), {"moe_aux_loss", "moe_drop_frac"})."""
    out, probs, keep, counts = moe_forward(p, x, cfg, capacity=capacity)
    T, (E, K) = probs.shape[0], (cfg.num_experts, cfg.experts_per_token)
    # --- load-balance auxiliary loss (Switch-style); a mean and a
    # division by a count multiply by its float32 reciprocal, as XLA
    # rewrites them
    me = probs.sum(0) * _recip(T)                              # (E,)
    ce = counts.float() * _recip(T * K)
    aux_loss = E * torch.sum(me * ce)
    drop = 1.0 - keep.float().sum() * _recip(T * K)
    return out, {"moe_aux_loss": aux_loss, "moe_drop_frac": drop}


def _g(cfg, w):
    """FSDP gather of an expert weight on use (cfg.fsdp_gather_weights)."""
    if getattr(cfg, "fsdp_gather_weights", False):
        return maybe_constrain(w, "model", None, None)
    return w


def moe_forward(p, x: torch.Tensor, cfg, *, capacity: int = None):
    """The layer without its auxiliary losses, which a decode step drops
    (XLA removes them from the reference's decode as dead code): x (B, S,
    D) -> (out (B, S, D), router probs (T, E), keep (T*K,), counts
    (E,))."""
    B, S, D = x.shape
    T = B * S
    E, K = cfg.num_experts, cfg.experts_per_token
    C = capacity if capacity is not None else moe_capacity(T, cfg)
    C = min(C, T * K)

    xt = maybe_constrain(fold(x, T, D), "data", None)
    probs = router_probs(p, xt)
    gates, idx, keep, slot, counts = route(probs, cfg, C)

    # --- dispatch: scatter into (E*C+1, D), the last row the drop bucket
    xrep = xt[:, None].expand(T, K, D).reshape(T * K, D)       # token-major
    xrep = maybe_constrain(xrep, "data", "model")
    buf = xt.new_zeros((E * C + 1, D)).index_put((slot,), xrep)
    buf = maybe_constrain(buf, None, "model")
    h = maybe_constrain(buf[:E * C].reshape(E, C, D), "model", None, None)

    # --- expert FFN as batched matmuls over the experts ---
    g = Fn.silu(torch.bmm(h, _g(cfg, p["w_gate"])))
    u = torch.bmm(h, _g(cfg, p["w_up"]))
    y = torch.bmm(g * u, _g(cfg, p["w_down"]))
    y = maybe_constrain(y, "model", None, None).reshape(E * C, D)
    y = maybe_constrain(y, None, "model")

    # --- gather back and combine with the gates ---
    y = torch.cat([y, y.new_zeros((1, D))], dim=0)
    out = y[slot]                                              # (T*K, D)
    w = gates.reshape(T * K, 1).to(y.dtype) * keep[:, None].to(y.dtype)
    out = (out * w).reshape(T, K, D).sum(dim=1)
    out = maybe_constrain(out, "data", "model")
    return fold(out, B, S, D).to(x.dtype), probs, keep, counts
