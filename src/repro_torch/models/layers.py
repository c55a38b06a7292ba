"""Shared building blocks of the transformer (``repro.models.layers``).

Parameters are plain nested dicts of tensors with the JAX package's
names and layouts (a dense weight is (in, out)).  Every ``init_*`` draws
from the port's ``rng`` in the JAX package's key order, so a seeded init
gives the JAX weights.

Attention is implemented three ways, as in the JAX package:
  * ``naive``   — materialise the (S, S) score matrix (small shapes, oracle);
  * ``chunked`` — blockwise attention with an online softmax in torch,
    with the JAX package's hand-written flash backward (a
    ``torch.autograd.Function`` that recomputes each block's
    probabilities from the saved log-sum-exp, so training holds O(S·hd)
    per head, not the (S, S) scores);
  * ``pallas``  — the hand-written CUDA kernel, through
    ``repro_torch.kernels.ops.flash_attention`` (its plain version on the
    CPU).  The name is the JAX package's, where it selects the Pallas TPU
    kernel.  The kernel has no backward, in either package: autograd
    through it raises.
:func:`attention_train` keeps the JAX dispatch: ``naive`` for S <= 1024
whatever the setting.

:func:`chunked_softmax_xent` is the LM loss with the vocab projection
fused per sequence chunk; its backward recomputes each chunk's logits,
so the (B, S, V) logits are never held.  Both ``autograd.Function``
classes carry a generated vmap rule, so the batched FL runtimes'
``torch.func.vmap(torch.func.grad(loss))`` passes through them.

The decode KV cache is updated in place (the JAX package returns a new
cache that XLA writes in place under buffer donation); the functions
still return the cache, so callers read like the JAX code.

Types follow JAX's promotion: a float32 activation times bf16 weights is
a float32 product (whisper's encoder over float32 frames runs in float32
on a bf16 config), which :func:`matmul` does where torch would refuse
the mixed product.

The JAX package's ``maybe_constrain`` points are here too
(``sharding.constrain``).  Outside the dry run's mesh they return their
argument, and the helpers around them (``split_last``, ``merge_last``,
``_logsumexp``, ``_softmax_minus_onehot``, :func:`matmul`) run the plain
ops, so serving and training are unchanged.  Inside it, on DTensors,
the attention runs on each (batch, head) shard's local tensors, the
vocab-sharded loss reduces its max and sum instead of gathering the
vocab, and products gather a sharded sequence first.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as Fn

from repro_torch import rng
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as KOPS
from repro_torch.kernels import ref as KREF
from repro_torch.sharding.constrain import (current_mesh, gather_inner,
                                           is_distributed, maybe_constrain,
                                           merge_last, on_local_shards,
                                           pad_split, padded_to_model,
                                           split_last)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name) -> torch.dtype:
    """A config's dtype name (``"bfloat16"``, ...) as a torch dtype."""
    return name if isinstance(name, torch.dtype) else _DTYPES[name]


# ----------------------------------------------------------------------
# initializers
# ----------------------------------------------------------------------

def dense_init(key, shape, dtype, scale: float = 1.0, *, device="cuda"):
    """Truncated-normal fan-in init (LeCun-style)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale / math.sqrt(fan_in)
    return (std * rng.truncated_normal(key, -2.0, 2.0, shape, device)
            ).to(torch_dtype(dtype))


def embed_init(key, shape, dtype, scale: float = 1.0, *, device="cuda"):
    std = scale / math.sqrt(shape[-1])
    return (std * rng.truncated_normal(key, -2.0, 2.0, shape, device)
            ).to(torch_dtype(dtype))


# ----------------------------------------------------------------------
# norms
# ----------------------------------------------------------------------

def init_norm(key, d, dtype, kind: str = "rmsnorm", *, device="cuda"):
    dt = torch_dtype(dtype)
    if kind == "rmsnorm":
        return {"scale": torch.ones((d,), dtype=dt, device=device)}
    return {"scale": torch.ones((d,), dtype=dt, device=device),
            "bias": torch.zeros((d,), dtype=dt, device=device)}


def apply_norm(p, x, eps: float = 1e-6):
    dt = x.dtype
    x32 = x.float()
    if "bias" in p:  # layernorm
        mu = x32.mean(-1, keepdim=True)
        var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
        y = (x32 - mu) * torch.rsqrt(var + eps)
        return (y * p["scale"].float() + p["bias"].float()).to(dt)
    ms = (x32 * x32).mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(ms + eps)
    return (y * p["scale"].float()).to(dt)


# ----------------------------------------------------------------------
# RoPE
# ----------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device="cuda") -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=resolve_device(device)) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                    # (hd/2,)
    ang = positions[..., :, None].float() * freqs             # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------
# MLP
# ----------------------------------------------------------------------

def init_mlp(key, d_model, d_ff, dtype, kind: str = "swiglu", *,
             device="cuda"):
    ks = rng.split(key, 3)
    if kind == "swiglu":
        return {
            "w_gate": dense_init(ks[0], (d_model, d_ff), dtype, device=device),
            "w_up": dense_init(ks[1], (d_model, d_ff), dtype, device=device),
            "w_down": dense_init(ks[2], (d_ff, d_model), dtype, device=device),
        }
    dt = torch_dtype(dtype)
    return {  # gelu MLP (starcoder2 / whisper style)
        "w_up": dense_init(ks[0], (d_model, d_ff), dtype, device=device),
        "b_up": torch.zeros((d_ff,), dtype=dt, device=device),
        "w_down": dense_init(ks[1], (d_ff, d_model), dtype, device=device),
        "b_down": torch.zeros((d_model,), dtype=dt, device=device),
    }


def _gathered(w, cfg, *spec):
    """FSDP weight-gather on use: re-constrain the weight so the 'data'
    shard dim is gathered (weights are small; the alternative, computing
    with a sharded contraction dim, all-reduces the much larger
    activations).  Active only when cfg.fsdp_gather_weights, and then
    only inside the dry run's mesh (``sharding.constrain``)."""
    if cfg is None or not getattr(cfg, "fsdp_gather_weights", False):
        return w
    return maybe_constrain(w, *spec)


def _foldable(x):
    """DTensor ``x`` (..., F) (inside an autograd Function), its local
    shard copied contiguous where the shard's leading dims do not merge
    as a view (a gradient in the attention's transposed layout at one
    head a rank): DTensor folds them with a view of the local shard, and
    takes the DTensor for contiguous by its global strides."""
    from torch.distributed.tensor import DTensor
    local = x.to_local()
    try:
        local.view(-1, local.shape[-1])
    except (RuntimeError, ValueError):
        return DTensor.from_local(local.contiguous(), x.device_mesh,
                                  x.placements, run_check=False,
                                  shape=x.shape, stride=x.stride())
    return x


class _MeshMatmul(torch.autograd.Function):
    """x (..., D) @ w (D, F) on DTensors inside the dry run's mesh, with
    the inner dims of x and of the output gradient gathered before each
    product folds them (DTensor cannot flatten a sharded inner dim, the
    sequence split over 'model' between blocks)."""

    @staticmethod
    def forward(ctx, x, w):
        x = _foldable(gather_inner(x))
        ctx.save_for_backward(x, w)
        return x @ w

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = _foldable(gather_inner(g))
        gw = x.reshape(-1, x.shape[-1]).transpose(0, 1) \
            @ g.reshape(-1, g.shape[-1])
        return g @ w.transpose(-1, -2), gw


class _Reduced(torch.autograd.Function):
    """A partial DTensor (the vocab-sharded lookup's masked partial sums)
    reduced, and its gradient placed as the lookup's output with the
    partial dims whole: the lookup's backward then never meets another
    kind of partial sum (a plain one from the blocks' backward, which
    DTensor cannot turn into a masked one)."""

    @staticmethod
    def forward(ctx, x):
        from torch.distributed.tensor import Replicate
        ctx.placements = [Replicate() if p.is_partial() else p
                          for p in x.placements]
        return x.redistribute(x.device_mesh, ctx.placements)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.placements)


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """table[tokens]; inside the dry run's mesh through ``Fn.embedding``,
    whose backward DTensor can place for a sharded table (the indexing
    backward's ``index_put`` it cannot).  With the table's D split over
    'data', as the batch is, DTensor's plan would gather every token and
    then the whole (B, S, D) output to put the batch back on 'data': a
    transient of twice the batch's embeddings a device.  So the table is
    gathered over 'data' first (FSDP's gather on use), in a training step
    too, where its gradient is reduce-scattered back to the table's
    placements: the whole table where the vocab does not split over
    'model' (granite's 49,155 rows)."""
    if not is_distributed(table):
        return table[tokens]
    table = maybe_constrain(table, "model", None)
    # reduce the vocab-sharded lookup's masked partial sums at once
    out = _Reduced.apply(Fn.embedding(tokens, table))
    return maybe_constrain(out, ("pod", "data"), *(None,) * (out.ndim - 1))


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in JAX's promoted type: operands of two float types are both
    taken to the wider (torch refuses a mixed matmul)."""
    if x.dtype != w.dtype:
        dt = torch.result_type(x, w)
        x, w = x.to(dt), w.to(dt)
    if x.ndim > 2 and is_distributed(x):
        return _MeshMatmul.apply(x, w)
    return x @ w


def apply_mlp(p, x, cfg=None):
    if "w_gate" in p:
        h = Fn.silu(matmul(x, _gathered(p["w_gate"], cfg, None, "model"))) \
            * matmul(x, _gathered(p["w_up"], cfg, None, "model"))
        return matmul(h, _gathered(p["w_down"], cfg, "model", None))
    # jax.nn.gelu defaults to the tanh approximation
    h = Fn.gelu(matmul(x, _gathered(p["w_up"], cfg, None, "model"))
                + p["b_up"], approximate="tanh")
    return matmul(h, _gathered(p["w_down"], cfg, "model", None)) \
        + p["b_down"]


# ----------------------------------------------------------------------
# attention (GQA, causal, optional sliding window)
# ----------------------------------------------------------------------

def init_attention(key, cfg, *, device="cuda"):
    d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    dt = torch_dtype(cfg.dtype)
    ks = rng.split(key, 4)
    p = {
        "wq": dense_init(ks[0], (d, h * hd), dt, device=device),
        "wk": dense_init(ks[1], (d, kv * hd), dt, device=device),
        "wv": dense_init(ks[2], (d, kv * hd), dt, device=device),
        "wo": dense_init(ks[3], (h * hd, d), dt, device=device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h * hd,), dtype=dt, device=device)
        p["bk"] = torch.zeros((kv * hd,), dtype=dt, device=device)
        p["bv"] = torch.zeros((kv * hd,), dtype=dt, device=device)
    return p


def _proj(x, w, b):
    return matmul(x, w) if b is None else matmul(x, w) + b


def _padded_heads(cfg, x) -> int:
    """The query heads padded to the dry run's 'model' axis (GSPMD's
    padding of an uneven split) where ``x`` is a DTensor inside the mesh
    and the axis does not divide them, else 0."""
    if not is_distributed(x):
        return 0
    hp = padded_to_model(cfg.num_heads)
    return 0 if hp == cfg.num_heads else hp


def _padded_proj(x, w, b, cfg, hp, source=None, gather=True):
    """x @ w (+ b) with w's output heads padded to ``hp`` and split over
    'model' (``pad_split``): (..., hp * hd), split by whole heads, the
    padded heads zero.  ``source`` maps query head j to the weight's head
    (a KV head for k and v)."""
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    w = pad_split(w, -1, hd, h, hp, source)
    if gather:
        w = _gathered(w, cfg, None, "model")
    if b is not None:
        b = pad_split(b, 0, hd, h, hp, source)
    return _proj(x, w, b)


def _q(p, x, cfg):
    """q (B, S, heads, hd); on a mesh whose 'model' axis does not divide
    the heads, padded to it (:func:`_padded_heads`)."""
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    hp = _padded_heads(cfg, x)
    if hp:
        return split_last(_padded_proj(x, p["wq"], p.get("bq"), cfg, hp),
                          hp, hd)
    q = _proj(x, _gathered(p["wq"], cfg, None, "model"), p.get("bq"))
    return split_last(q, h, hd)


def kv_proj(p, x, cfg):
    """k and v (B, S, KV, hd) projected from x.  On a mesh whose 'model'
    axis does not divide the query heads they come padded as q is, each
    query head's KV head in its place (:func:`_expand_kv`'s map): the
    rank's own heads only, where XLA pads the expanded K/V."""
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    hp = _padded_heads(cfg, x)
    if hp:
        rep = _kv_rep(cfg.num_heads, kv)
        return tuple(split_last(_padded_proj(
            x, p[w], p.get(b), cfg, hp, lambda j: j // rep), hp, hd)
            for w, b in (("wk", "bk"), ("wv", "bv")))
    k = _proj(x, _gathered(p["wk"], cfg, None, "model"), p.get("bk"))
    v = _proj(x, _gathered(p["wv"], cfg, None, "model"), p.get("bv"))
    return split_last(k, kv, hd), split_last(v, kv, hd)


def _kv_rep(num_heads, kv):
    """Query heads a KV head serves (the last KV head fewer where KV does
    not divide the heads)."""
    return num_heads // kv if num_heads % kv == 0 else -(-num_heads // kv)


def _expand_kv(k, num_heads):
    """(B, S, KV, hd) -> (B, S, H, hd) by repeating each KV head ``rep``
    times in a row (``jnp.repeat``), so query head h reads KV head
    h // rep.  The repeat axis goes after the KV axis before the reshape;
    ``repeat_interleave`` would do the same but waits on the device for
    its output size."""
    B, S, KV, hd = k.shape
    rep = _kv_rep(num_heads, KV)
    k = k[:, :, :, None].expand(B, S, KV, rep, hd).reshape(B, S, KV * rep, hd)
    return k[:, :, :num_heads]


def naive_attention(q, k, v, *, causal: bool, window: int = 0
                    ) -> torch.Tensor:
    """Reference attention. q:(B,Sq,H,hd) k,v:(B,Sk,H,hd).  The plain
    version of the kernel, ``ref.flash_attention_ref``, computes it.
    Inside the mesh each (batch, head) shard attends alone on its local
    shards (batch over 'data', heads over 'model'), as the chunked path
    does: the reference's products fold (B, H) into one batch dim, which
    DTensor cannot do with both split (torch 2.11)."""
    def attend(q, k, v):
        return KREF.flash_attention_ref(q, k, v, causal=causal,
                                        window=window)

    if not is_distributed(q):
        return attend(q, k, v)
    q, k, v = (maybe_constrain(t, "data", None, "model", None)
               for t in (q, k, v))
    return on_local_shards(attend, q.placements, q, k, v)


# ---------------- flash attention with a hand-written backward -----------
# Layout inside is (B, H, S, hd).  The blocks of a (q block, kv block)
# pair that no query of the pair may see are skipped: there the online
# softmax step is the identity (p = 0, corr = 1) and the backward adds
# zeros, so skipping changes no value and saves the masked half of a
# causal pass.

def _pad_to(x, blk):
    """Zero-pad axis 2 (S) to a multiple of ``blk``."""
    pad = (-x.shape[2]) % blk
    return Fn.pad(x, (0, 0, 0, pad)) if pad else x


def _block_sees(q0, bq, k0, bk, *, causal, window, sk, q_offset) -> bool:
    """Whether any query of rows [q0, q0 + bq) sees any key of
    [k0, k0 + bk) (``_block_mask`` has a True)."""
    qlo, qhi = q0 + q_offset, q0 + bq - 1 + q_offset
    khi = min(k0 + bk, sk) - 1
    if k0 >= sk or (causal and k0 > qhi):
        return False
    return not (window > 0 and khi <= qlo - window)


def _block_mask(q0, bq, k0, bk, *, causal, window, sk, q_offset, device):
    """(bq, bk) bool: the JAX package's ``_block_mask`` for the block
    starting at query row ``q0`` and key ``k0`` (padding keys >= sk
    masked)."""
    qpos = torch.arange(q0, q0 + bq, device=device)[:, None] + q_offset
    kpos = torch.arange(k0, k0 + bk, device=device)[None, :]
    m = kpos < sk
    if causal:
        m = m & (kpos <= qpos)
    if window > 0:
        m = m & (kpos > qpos - window)
    return m


def _flash_fwd(q, k, v, causal, window, bq, bk, q_offset):
    """q, k, v: (B, H, S, hd).  Returns (out (B, H, Sq, hd) in q's type,
    lse (B, H, Sq) float32), as ``_flash_fwd_impl``: fp32 m, l and acc,
    masked probabilities zeroed, lse = m + log(l), 1e30 where l == 0."""
    B, H, Sq, hd = q.shape
    Sk = k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    qp, kp, vp = _pad_to(q, bq).float(), _pad_to(k, bk).float(), \
        _pad_to(v, bk).float()
    dev = q.device
    geo = dict(causal=causal, window=window, sk=Sk, q_offset=q_offset)
    outs, lses = [], []
    for q0 in range(0, qp.shape[2], bq):
        qb = qp[:, :, q0:q0 + bq]
        # accumulators shaped (and, in the dry run's mesh, placed) as qb
        m = torch.full_like(qb[..., 0], -1e30)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qb)
        for k0 in range(0, kp.shape[2], bk):
            if not _block_sees(q0, bq, k0, bk, **geo):
                continue
            msk = _block_mask(q0, bq, k0, bk, device=dev, **geo)
            s = torch.einsum("bhqd,bhkd->bhqk", qb,
                             kp[:, :, k0:k0 + bk]) * scale
            s = torch.where(msk, s, -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.where(msk, torch.exp(s - m_new[..., None]), 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p, vp[:, :, k0:k0 + bk])
            m = m_new
        outs.append((acc / torch.clamp(l[..., None], min=1e-30)).to(q.dtype))
        lses.append(torch.where(l > 0, m + torch.log(torch.clamp(
            l, min=1e-30)), 1e30))
    return (torch.cat(outs, dim=2)[:, :, :Sq],
            torch.cat(lses, dim=2)[:, :, :Sq])


def _flash_bwd(q, k, v, out, lse, dout, causal, window, bq, bk, q_offset):
    """``_flash_bwd_impl``: for each kv block (outer) and q block (inner),
    p = exp(s - lse) masked, dv += p^T dout, ds = p (dp - delta) scale,
    dk += ds^T q, dq += ds k; fp32 throughout, cast to the inputs'
    types."""
    B, H, Sq, hd = q.shape
    Sk = k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    delta = (dout.float() * out.float()).sum(-1)             # (B, H, Sq)
    qp, dop = _pad_to(q, bq).float(), _pad_to(dout, bq).float()
    kp, vp = _pad_to(k, bk).float(), _pad_to(v, bk).float()
    pad_q = qp.shape[2] - Sq
    lsep = Fn.pad(lse, (0, pad_q))
    deltap = Fn.pad(delta, (0, pad_q))
    dev = q.device
    geo = dict(causal=causal, window=window, sk=Sk, q_offset=q_offset)
    nq = qp.shape[2] // bq
    dq = [torch.zeros_like(qp[:, :, :bq]) for _ in range(nq)]
    dks, dvs = [], []
    for k0 in range(0, kp.shape[2], bk):
        kf, vf = kp[:, :, k0:k0 + bk], vp[:, :, k0:k0 + bk]
        dkj = torch.zeros_like(kf)
        dvj = torch.zeros_like(vf)
        for i in range(nq):
            q0 = i * bq
            if not _block_sees(q0, bq, k0, bk, **geo):
                continue
            msk = _block_mask(q0, bq, k0, bk, device=dev, **geo)
            qf, dof = qp[:, :, q0:q0 + bq], dop[:, :, q0:q0 + bq]
            s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
            p = torch.where(msk, torch.exp(
                s - lsep[:, :, q0:q0 + bq, None]), 0.0)
            dvj = dvj + torch.einsum("bhqk,bhqd->bhkd", p, dof)
            dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
            ds = p * (dp - deltap[:, :, q0:q0 + bq, None]) * scale
            dkj = dkj + torch.einsum("bhqk,bhqd->bhkd", ds, qf)
            dq[i] = dq[i] + torch.einsum("bhqk,bhkd->bhqd", ds, kf)
        dks.append(dkj)
        dvs.append(dvj)
    return (torch.cat(dq, dim=2)[:, :, :Sq].to(q.dtype),
            torch.cat(dks, dim=2)[:, :, :Sk].to(k.dtype),
            torch.cat(dvs, dim=2)[:, :, :Sk].to(v.dtype))


class _FlashMHA(torch.autograd.Function):
    """The JAX package's ``_flash_mha`` custom VJP: the forward keeps
    (q, k, v, out, lse); the backward recomputes the blocks."""

    generate_vmap_rule = True

    @staticmethod
    def forward(q, k, v, causal, window, bq, bk, q_offset):
        return _flash_fwd(q, k, v, causal, window, bq, bk, q_offset)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window, bq, bk, q_offset = inputs
        out, lse = output
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.geometry = (causal, window, bq, bk, q_offset)
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, out, lse, dout, *ctx.geometry)
        return dq, dk, dv, None, None, None, None, None


def chunked_attention(q, k, v, *, causal: bool, window: int = 0,
                      q_block: int = 512, kv_block: int = 1024,
                      q_offset: int = 0) -> torch.Tensor:
    """Flash attention in torch with an exact-memory backward.  q, k, v:
    (B, S, H, hd) (kv pre-expanded to H heads).  Returns the same
    layout."""
    bq, bk = min(q_block, q.shape[1]), min(kv_block, k.shape[1])
    # (B,S,H,hd) -> (B,H,S,hd), pin batch->data, heads->model
    qt = maybe_constrain(q.transpose(1, 2), "data", "model", None, None)
    kt = maybe_constrain(k.transpose(1, 2), "data", "model", None, None)
    vt = maybe_constrain(v.transpose(1, 2), "data", "model", None, None)

    def flash(qt, kt, vt):
        return _FlashMHA.apply(qt, kt, vt, causal, window, bq, bk,
                               q_offset)[0]

    if is_distributed(qt):
        # each (batch, head) shard attends alone: the block loop runs on
        # the local shards
        out = on_local_shards(flash, qt.placements, qt, kt, vt)
    else:
        out = flash(qt, kt, vt)
    out = maybe_constrain(out, "data", "model", None, None)
    return out.transpose(1, 2)


def attention_train(p, x, cfg, *, causal: bool = True,
                    positions: Optional[torch.Tensor] = None,
                    kv_override=None):
    """Full-sequence attention (train / prefill).  ``kv_override``
    supplies external (B, Sk, KV, hd) K/V (cross-attention,
    :func:`kv_proj` of the encoder output): q is projected from x and
    RoPE is not applied (the K/V projections of x, which JAX computes
    and XLA drops, are not made).  On a mesh whose 'model' axis does not
    divide the heads, q, k and v come padded to it, split by whole
    heads, and ``wo`` takes zero rows for the padded heads."""
    B, S, _ = x.shape
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q = _q(p, x, cfg)
    if kv_override is not None:
        k, v = kv_override
    else:
        k, v = kv_proj(p, x, cfg)
        if cfg.rope_theta > 0:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
    if q.shape[2] == h:     # else k and v come padded as q, expanded
        k = _expand_kv(k, h)
        v = _expand_kv(v, h)
    win = cfg.sliding_window
    if cfg.attn_impl == "naive" or S <= 1024:
        o = naive_attention(q, k, v, causal=causal, window=win)
    elif cfg.attn_impl == "pallas":
        o = KOPS.flash_attention(q, k, v, causal=causal, window=win)
    else:
        o = chunked_attention(q, k, v, causal=causal, window=win)
    return matmul(merge_last(o), _gathered(_wo(p, o, cfg), cfg, "model",
                                           None))


def _wo(p, o, cfg):
    """``wo`` with zero rows for the padded heads of ``o`` (heads at dim
    2), split over 'model' as ``o``'s heads are; ``wo`` itself
    unpadded."""
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    if o.shape[2] == h:
        return p["wo"]
    return pad_split(p["wo"], 0, hd, h, o.shape[2])


# ---------------- decode (single new token against a KV cache) -----------

def init_kv_cache(cfg, batch, cache_len, layers_leading=(), *,
                  device="cuda"):
    """Allocate a KV cache.  Sliding-window archs use a ring buffer of
    min(window, cache_len).  Optional int8 quantized storage."""
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    eff = min(cfg.sliding_window, cache_len) if cfg.sliding_window \
        else cache_len
    shape = (*layers_leading, batch, eff, kv, hd)
    if cfg.resolved_kv_cache_dtype == "int8":
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:-1], device=device),
            "v_scale": torch.zeros(shape[:-1], device=device),
        }
    dt = torch_dtype(cfg.resolved_kv_cache_dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def _quantize_kv(x):
    """(B,1,KV,hd) -> int8 values + per-(token,head) scale."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0].float()


def _dequantize_kv(q, scale):
    return q.float() * scale[..., None]


def update_kv_cache(cache, k_new, v_new, pos, cfg):
    """Insert one token at position pos (ring-buffered for sliding
    window), in place; returns the cache."""
    eff = cache["k"].shape[-3]
    slot = int(pos) % eff
    if "k_scale" in cache:
        kq, ks = _quantize_kv(k_new)
        vq, vs = _quantize_kv(v_new)
        cache["k"][..., slot:slot + 1, :, :] = kq
        cache["v"][..., slot:slot + 1, :, :] = vq
        cache["k_scale"][..., slot:slot + 1, :] = ks
        cache["v_scale"][..., slot:slot + 1, :] = vs
    else:
        cache["k"][..., slot:slot + 1, :, :] = k_new
        cache["v"][..., slot:slot + 1, :, :] = v_new
    return cache


def attention_decode(p, x, cache, pos, cfg, *, cross: bool = False,
                     cross_len=None):
    """One-token attention against the cache.

    x: (B, 1, D).  pos: the current position (int).  Returns (out, cache);
    a self-attention cache is updated in place.  For cross-attention
    (``cross=True``) the cache holds the encoder's precomputed K/V and is
    not written; every slot below ``cross_len`` (all of them when None)
    is valid."""
    B = x.shape[0]
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    pos = int(pos)
    hp = _padded_heads(cfg, x)
    if hp:
        q = split_last(_padded_proj(x, p["wq"], p.get("bq"), cfg, hp,
                                    gather=False), hp, hd)
    else:
        q = split_last(_proj(x, p["wq"], p.get("bq")), h, hd)
    if not cross:
        k_new = split_last(_proj(x, p["wk"], p.get("bk")), kv, hd)
        v_new = split_last(_proj(x, p["wv"], p.get("bv")), kv, hd)
        if cfg.rope_theta > 0:
            posv = torch.full((B, 1), pos, device=x.device)
            q = apply_rope(q, posv, cfg.rope_theta)
            k_new = apply_rope(k_new, posv, cfg.rope_theta)
        cache = update_kv_cache(cache, k_new, v_new, pos, cfg)
    if "k_scale" in cache:
        kc = _dequantize_kv(cache["k"], cache["k_scale"])
        vc = _dequantize_kv(cache["v"], cache["v_scale"])
    else:
        kc, vc = cache["k"], cache["v"]
    eff = kc.shape[-3]
    # validity of each cache slot
    slot_idx = torch.arange(eff, device=x.device)
    if cross:
        valid = slot_idx < (eff if cross_len is None else cross_len)
    elif cfg.sliding_window and cfg.sliding_window <= eff:
        valid = slot_idx < min(pos + 1, eff)   # ring buffer full once warm
    else:
        valid = slot_idx <= pos
    kc = _expand_kv(kc, h)                              # (B, eff, H, hd)
    vc = _expand_kv(vc, h)
    if hp:
        # zero heads to q's padding (the heads dim is whole on every rank)
        kc, vc = (on_local_shards(
            lambda t: Fn.pad(t, (0, 0, 0, hp - h)), t.placements, t)
            for t in (kc, vc))

    def attend(q, kc, vc):
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                         kc.float()) / math.sqrt(hd)
        s = torch.where(valid, s, torch.full_like(s, -1e30))
        w = torch.softmax(s, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", w, vc.float())

    if is_distributed(q):
        # batch over 'data', heads over 'model'; each shard attends alone
        q, kc, vc = (maybe_constrain(t, "data", None, "model", None)
                     for t in (q, kc, vc))
        o = on_local_shards(attend, q.placements, q, kc, vc)
    else:
        o = attend(q, kc, vc)
    return matmul(merge_last(o.to(x.dtype)), _wo(p, o, cfg)), cache


# ----------------------------------------------------------------------
# losses
# ----------------------------------------------------------------------

def _xent_chunks(x, labels, mask, chunk):
    """Pad S to a multiple of ``chunk`` and yield each chunk's
    (x (B, c, D), labels, mask)."""
    pad = (-x.shape[1]) % chunk
    if pad:
        x = Fn.pad(x, (0, 0, 0, pad))
        labels = Fn.pad(labels, (0, pad))
        mask = Fn.pad(mask, (0, pad))
    for s0 in range(0, x.shape[1], chunk):
        yield (x[:, s0:s0 + chunk], labels[:, s0:s0 + chunk],
               mask[:, s0:s0 + chunk])


def _logsumexp(logits):
    """logsumexp over the vocab.  Inside the dry run's mesh in the form
    whose two reductions (max, sum) leave a vocab-sharded DTensor sharded:
    ``torch.logsumexp`` would gather the vocab first."""
    if current_mesh() is None:
        return torch.logsumexp(logits, dim=-1)
    m = logits.amax(-1, keepdim=True)
    return (m + torch.log(torch.exp(logits - m).sum(-1, keepdim=True)))[..., 0]


def _on_vocab_shards(fn, logits, *args):
    """``fn(logits, iota, *args)``, ``iota`` the vocab index of each of
    logits' columns; inside the mesh on each device's local shards, the
    DTensor ``args`` (the labels) placed as the logits but for the vocab:
    DTensor (torch 2.11) broadcasts a vocab-sharded iota against
    batch-sharded labels over the whole batch."""
    if not is_distributed(logits):
        return fn(logits, torch.arange(logits.shape[-1],
                                       device=logits.device), *args)
    from torch.distributed.tensor import Replicate
    mesh, last = logits.device_mesh, logits.ndim - 1
    width = logits.to_local().shape[-1]
    split = [i for i, p in enumerate(logits.placements) if p.is_shard(last)]
    assert len(split) <= 1, logits.placements
    first = mesh.get_local_rank(split[0]) * width if split else 0
    iota = torch.arange(first, first + width, device=logits.device)
    pl = [Replicate() if p.is_shard(last) else p for p in logits.placements]
    args = [a.redistribute(mesh, pl) for a in args]
    return on_local_shards(lambda t, *a: fn(t, iota, *a),
                           logits.placements, logits, *args)


def _softmax_minus_onehot(logits, idx):
    """softmax(logits) - onehot(idx) over the vocab (idx: (..., 1)); inside
    the mesh from the sharded logsumexp and each shard's own vocab
    columns, so nothing is gathered."""
    if current_mesh() is None:
        return torch.softmax(logits, dim=-1) - torch.zeros_like(
            logits).scatter(-1, idx, 1.0)
    p = torch.exp(logits - _logsumexp(logits)[..., None])
    return _on_vocab_shards(
        lambda p, iota, idx: p - (iota == idx).to(p.dtype), p, idx)


def _drop_padding(logits, vocab: int):
    """logits with the vocab columns past ``vocab`` (the padding of the
    vocab to the 'model' axis) at -inf, so that they take no part in the
    logsumexp, the softmax or dW (a zero column would add e^0 to every
    row's sum); ``logits`` itself where nothing is padded."""
    if logits.shape[-1] == vocab:
        return logits
    return _on_vocab_shards(
        lambda t, iota: torch.where(iota < vocab, t, float("-inf")), logits)


class _ChunkedXent(torch.autograd.Function):
    """Masked mean next-token NLL over (x_final @ w_head) chunk by chunk.
    The forward sums each chunk's NLL in chunk order, as the JAX
    package's scan does; the backward recomputes each chunk's logits
    (``jax.checkpoint`` over the scan body in the JAX package):
    dlogits = (softmax - onehot) * mask * g / max(cnt, 1),
    dx = dlogits @ w^T, dw = sum over chunks of x^T dlogits, one (D, V)
    product a chunk with the batch and the chunk contracted together
    (summed in float32, then cast to w's type).  ``vocab`` is the real
    vocab where w_head's columns are padded to the mesh's 'model' axis."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, w, labels, mask, chunk, vocab):
        tot = torch.zeros((), device=x.device)
        cnt = torch.zeros((), device=x.device)
        for xc, lc, mc in _xent_chunks(x, labels, mask, chunk):
            logits = _drop_padding(maybe_constrain(
                (xc @ w).float(), "data", None, "model"), vocab)  # (B, c, V)
            lse = _logsumexp(logits)
            # the vocab-sharded gather is a masked partial in the dry
            # run's mesh: reduce it before dropping the index dim
            gold = maybe_constrain(logits.gather(-1, lc[..., None].long()),
                                   "data")[..., 0]
            tot = tot + ((lse - gold) * mc).sum()
            cnt = cnt + mc.sum()
        return tot / torch.clamp(cnt, min=1.0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, labels, mask, chunk, vocab = inputs
        ctx.save_for_backward(x, w, labels, mask)
        ctx.chunk, ctx.vocab = chunk, vocab

    @staticmethod
    def backward(ctx, g):
        x, w, labels, mask = ctx.saved_tensors
        scale = g / torch.clamp(mask.float().sum(), min=1.0)
        dxs, dw = [], None
        for xc, lc, mc in _xent_chunks(x, labels, mask, ctx.chunk):
            logits = _drop_padding(maybe_constrain(
                (xc @ w).float(), "data", None, "model"), ctx.vocab)
            dl = _softmax_minus_onehot(logits, lc[..., None].long())
            dl = (dl * (mc * scale)[..., None]).to(x.dtype)
            dxs.append(dl @ w.transpose(-1, -2))
            part = (xc.reshape(-1, xc.shape[-1]).transpose(0, 1)
                    @ dl.reshape(-1, dl.shape[-1])).float()
            dw = part if dw is None else dw + part
        dx = torch.cat(dxs, dim=1)[:, :x.shape[1]]
        return dx, dw.to(w.dtype), None, None, None, None


def chunked_softmax_xent(logits_fn, x_final, w_head, labels, mask,
                         chunk: int = 256):
    """Cross-entropy with the vocab projection fused per sequence chunk,
    so the (B, S, V) logits are never held (``logits_fn`` is unused, as
    in the JAX package).  x_final: (B, S, D) final hidden states; w_head:
    (D, V); labels, mask: (B, S).  Inside the mesh a vocab that the
    'model' axis does not divide is padded to it with zero columns
    (``pad_split``), which the loss drops, as GSPMD pads the logits'
    split."""
    x_final = maybe_constrain(x_final, "data", None, None)
    vocab = w_head.shape[-1]
    vp = padded_to_model(vocab)
    if vp != vocab and is_distributed(x_final):
        w_head = pad_split(w_head, 1, 1, vocab, vp)
    # GSPMD derives the head's gather over 'data' from the logits
    # constraint; DTensor plans one op at a time, so it is asked for (one
    # all-gather of D x V/16 a step, not the logits reduced per chunk)
    w_head = maybe_constrain(w_head, None, "model")
    return _ChunkedXent.apply(x_final, w_head, labels, mask,
                              min(chunk, x_final.shape[1]), vocab)
