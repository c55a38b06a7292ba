"""Mixture-of-Experts layer (``repro.models.moe``).

Capacity-factor routing with a group-local scatter dispatch, as the JAX
package's: the T tokens are split into G groups (:func:`_num_groups`: the
``data`` axis size of the ambient mesh when it divides T, else 1; G = 1
outside a mesh), each group holding one ``data`` shard's tokens.

  1. the router (float32) gives each token its top-k experts; a tie goes
     to the lower expert index, as ``lax.top_k`` orders it;
  2. each (token, slot) gets its rank within its expert from a cumulative
     sum of the one-hot over its group's flattened (token, slot) axis,
     token-major; ranks >= C (the capacity of a group of T / G tokens)
     are dropped into the bucket row ``E * C``;
  3. each group scatters its tokens into a (E * C + 1, D) buffer, the
     (G, E, C, D) -> (E, G, C, D) transpose is the token -> expert
     all-to-all, the experts run as batched matmuls, and the results
     come back, are gathered and combined with the router gates.

Which tokens are dropped is an integer result: on the same router
probabilities it is JAX's, bit for bit.  ``C = min(moe_capacity(T / G),
T / G * K)`` depends on the call's token count, so a decode step and a
prefill drop differently, as in JAX.  :func:`apply_moe` adds the
auxiliary losses (over all T tokens) to :func:`moe_forward`, which a
decode step calls alone (the reference's decode discards them, and XLA
drops them as dead code).  Every op is out of place, so the batched FL
runtimes' ``torch.func.vmap(torch.func.grad(loss))`` runs through the
layer.

Inside the dry run's mesh the scatter, the experts and the combine run
on each device's local shards (``constrain.on_local_shards``) with the
JAX package's placements: the buffer over (``data``, -, ``model``) while
each group scatters its own D-slice, (``model``, ``data``, -, -) in the
experts, back to (``data``, -, ``model``) for the combine.  Where E does
not divide the ``model`` axis (granite-moe's 40 experts over 16) the
expert axis of the buffer and of the gathered weights is padded with
empty experts to the next multiple, as XLA pads an uneven split; no
token is routed to them.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as Fn

from repro_torch import rng
from repro_torch.models.layers import dense_init, torch_dtype
from repro_torch.sharding.constrain import (current_mesh, fold,
                                           is_distributed, maybe_constrain,
                                           on_local_shards)


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


def _num_groups(total_tokens: int) -> int:
    """Groups = the ``data`` axis size of the ambient mesh when it divides
    the tokens (JAX reads its abstract mesh); 1 outside a mesh."""
    mesh = current_mesh()
    if mesh is None or "data" not in mesh.mesh_dim_names:
        return 1
    g = mesh.size(mesh.mesh_dim_names.index("data"))
    return g if total_tokens % g == 0 else 1


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
    """Routing of each group of T tokens from their (..., T, E) router
    probabilities: (gates (..., T, K) renormalised, idx (..., T, K), keep
    (..., T*K) bool, slot (..., T*K) int64 with the drop bucket E*C,
    counts (E,) of the (token, slot) pairs sent to each expert over all
    groups).  A (T, E) input is one group."""
    E, K = cfg.num_experts, cfg.experts_per_token
    gates, idx = top_k(probs, K)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    flat_e = idx.reshape(*idx.shape[:-2], -1)                  # (..., T*K)
    onehot = (flat_e[..., None] == torch.arange(               # (..., T*K, E)
        E, device=flat_e.device)).long()
    ranks = torch.cumsum(onehot, dim=-2) - onehot
    rank = ranks.gather(-1, flat_e[..., None])[..., 0]
    keep = rank < capacity
    slot = torch.where(keep, flat_e * capacity + rank,
                       torch.full_like(flat_e, E * capacity))
    return gates, idx, keep, slot, onehot.sum(tuple(range(onehot.ndim - 1)))


def _recip(n: int) -> float:
    """1 / n rounded to float32."""
    return float(np.float32(1.0) / np.float32(n))


def router_probs(p, xt: torch.Tensor) -> torch.Tensor:
    """(..., D) tokens -> (..., E) float32 router probabilities."""
    return torch.softmax(xt.float() @ p["router"], dim=-1)


def apply_moe(p, x: torch.Tensor, cfg, *, capacity: int = None):
    """x: (B, S, D) -> ((B, S, D), {"moe_aux_loss", "moe_drop_frac"})."""
    out, probs, keep, counts = moe_forward(p, x, cfg, capacity=capacity)
    E, K = cfg.num_experts, cfg.experts_per_token
    T = x.shape[0] * x.shape[1]
    # --- load-balance auxiliary loss (Switch-style, over all groups); a
    # mean and a division by a count multiply by its float32 reciprocal,
    # as XLA rewrites them
    me = probs.sum(tuple(range(probs.ndim - 1))) * _recip(T)   # (E,)
    ce = counts.float() * _recip(T * K)
    aux_loss = E * torch.sum(me * ce)
    drop = 1.0 - keep.float().sum() * _recip(T * K)
    return out, {"moe_aux_loss": aux_loss, "moe_drop_frac": drop}


def _dispatch(xt, slot, K: int, E: int, C: int):
    """Each group's tokens scattered into its (E*C+1, D) buffer, the drop
    bucket cut off: xt (G, Tg, D), slot (G, Tg*K) -> h (E, G, C, D)."""
    G, Tg, D = xt.shape
    xrep = xt[:, :, None].expand(G, Tg, K, D).reshape(G * Tg * K, D)
    rows = E * C + 1
    off = torch.arange(G, device=slot.device)[:, None] * rows
    buf = xt.new_zeros((G * rows, D)).index_put(
        ((slot + off).reshape(-1),), xrep)
    return buf.reshape(G, rows, D)[:, :E * C].reshape(G, E, C, D) \
        .transpose(0, 1)


def _experts(h, w_gate, w_up, w_down):
    """The expert FFN as batched matmuls: h (E, G, C, D) -> (E, G, C, D)."""
    E, G, C, D = h.shape
    hf = h.reshape(E, G * C, D)
    g = Fn.silu(torch.bmm(hf, w_gate))
    u = torch.bmm(hf, w_up)
    return torch.bmm(g * u, w_down).reshape(E, G, C, D)


def _combine(y, slot, gates, keep):
    """The experts' outputs gathered back to each group's (token, slot)
    pairs and summed with the gates: y (E, G, C, D), slot and keep (G,
    Tg*K), gates (G, Tg, K) -> (G * Tg, D)."""
    E, G, C, D = y.shape
    K = gates.shape[-1]
    y = y.transpose(0, 1).reshape(G, E * C, D)
    y = torch.cat([y, y.new_zeros((G, 1, D))], dim=1).reshape(-1, D)
    off = torch.arange(G, device=slot.device)[:, None] * (E * C + 1)
    out = y[(slot + off).reshape(-1)]                          # (G*Tg*K, D)
    w = gates.reshape(-1, 1).to(y.dtype) * keep.reshape(-1, 1).to(y.dtype)
    return (out * w).reshape(-1, K, D).sum(dim=1)


def moe_forward(p, x: torch.Tensor, cfg, *, capacity: int = None):
    """The layer without its auxiliary losses, which a decode step drops
    (XLA removes them from the reference's decode as dead code): x (B, S,
    D) -> (out (B, S, D), router probs (G, T/G, E) and keep (G, T/G*K),
    at one group outside a mesh (T, E) and (T*K,), counts (E,))."""
    B, S, D = x.shape
    T = B * S
    K = cfg.experts_per_token
    G = _num_groups(T)
    Tg = T // G
    C = capacity if capacity is not None else moe_capacity(Tg, cfg)
    C = min(C, Tg * K)
    if is_distributed(x):
        return _moe_on_mesh(p, x, cfg, G, C)
    xt = x.reshape(T, D)
    probs = router_probs(p, xt)
    gates, idx, keep, slot, counts = route(probs.reshape(G, Tg, -1), cfg, C)
    h = _dispatch(xt.reshape(G, Tg, D), slot, K, cfg.num_experts, C)
    y = _experts(h, p["w_gate"], p["w_up"], p["w_down"])
    out = _combine(y, slot, gates, keep)
    if G == 1:
        keep = keep.reshape(-1)
    else:
        probs = probs.reshape(G, Tg, -1)
    return out.reshape(B, S, D).to(x.dtype), probs, keep, counts


# ----------------------------------------------------------------------
# inside the dry run's mesh
# ----------------------------------------------------------------------

def _moved(placements, dims):
    """``placements`` with each Shard(d) made Shard(dims[d])."""
    return [type(p)(dims[p.dim]) if p.is_shard() else p for p in placements]


def _by_groups(x, G: int):
    """(B, S, D) DTensor -> (G, B*S/G, D) over ('data', -, -): a local
    reshape when each 'data' shard holds whole sequences of one group."""
    B, S, D = x.shape
    x = maybe_constrain(x, "data", None, None)
    if G > 1 and B % G == 0:       # G is the 'data' size: B split evenly
        return on_local_shards(lambda t: t.reshape(1, -1, D), x.placements,
                               x)
    return fold(x, G, B * S // G, D)


def _by_sequences(out, B: int, S: int):
    """(G, Tg, D) DTensor -> (B, S, D), the inverse of :func:`_by_groups`."""
    G, _, D = out.shape
    if G > 1 and B % G == 0:
        return on_local_shards(
            lambda t: t.reshape(-1, S, t.shape[-1]), out.placements, out)
    return fold(out, B, S, D)


def _expert_weight(w, experts: int, d_dim: int):
    """An (E, ., .) expert weight padded with zero experts to ``experts``
    and placed for the local experts: E over 'model', gathered over
    'data' (its D dim, ``d_dim``, is split there by the rules)."""
    if w.shape[0] < experts:
        # E does not divide 'model', so the rules leave dim 0 whole
        pad = experts - w.shape[0]
        w = on_local_shards(lambda t: torch.cat(
            [t, t.new_zeros((pad, *t.shape[1:]))]), w.placements, w)
    spec = ["model", None, None]
    spec[d_dim] = "data"
    w = maybe_constrain(w, *spec)            # a local slice: E over 'model'
    return maybe_constrain(w, "model", None, None)


def _moe_on_mesh(p, x, cfg, G: int, C: int):
    """:func:`moe_forward` on DTensors: routing as DTensor ops over the
    groups ('data'), scatter, experts and combine on local shards."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    n_model = mesh.size(names.index("model")) if "model" in names else 1
    Ep = -(-E // n_model) * n_model            # experts padded to 'model'

    xt = _by_groups(x, G)                                      # (G, Tg, D)
    probs = maybe_constrain(router_probs(p, xt), "data", None, None)
    gates, idx, keep, slot, counts = route(probs, cfg, C)
    gates = maybe_constrain(gates, "data", None, None)
    keep = maybe_constrain(keep, "data", None)
    slot = maybe_constrain(torch.where(keep, slot, Ep * C), "data", None)

    # --- dispatch: each group scatters its own D-slice (G over 'data', D
    # over 'model'), then the all-to-all to (E over 'model', G over 'data')
    xd = maybe_constrain(xt, "data", None, "model")
    h = on_local_shards(lambda t, s: _dispatch(t, s, K, Ep, C).contiguous(),
                        _moved(xd.placements, {0: 1, 2: 3}), xd, slot)
    h = maybe_constrain(h, "model", "data", None, None)

    # --- the local experts; a weight's gradient is the groups' sum
    w_gate = _expert_weight(p["w_gate"], Ep, 1)
    w_up = _expert_weight(p["w_up"], Ep, 1)
    w_down = _expert_weight(p["w_down"], Ep, 2)
    y = on_local_shards(_experts, h.placements, h, w_gate, w_up, w_down)

    # --- back to (G over 'data', D over 'model'), gathered and combined;
    # the gates' gradient is the D-slices' sum
    y = maybe_constrain(y, None, "data", None, "model")
    out = on_local_shards(
        lambda yl, sl, gl, kl: _combine(yl, sl, gl, kl).reshape(
            sl.shape[0], -1, yl.shape[-1]),
        _moved(y.placements, {1: 0, 3: 2}), y, slot, gates, keep)
    out = maybe_constrain(out, "data", None, "model")
    return _by_sequences(out, B, S).to(x.dtype), probs, keep, counts
