"""Shared building blocks of the transformer (``repro.models.layers``
without the cross-attention of the encoder-decoder models).

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
    """FSDP weight-gather on use in the JAX package; FSDP is not ported,
    so a weight is used as it is."""
    return w


def apply_mlp(p, x, cfg=None):
    if "w_gate" in p:
        h = Fn.silu(x @ _gathered(p["w_gate"], cfg, None, "model")) \
            * (x @ _gathered(p["w_up"], cfg, None, "model"))
        return h @ _gathered(p["w_down"], cfg, "model", None)
    # jax.nn.gelu defaults to the tanh approximation
    h = Fn.gelu(x @ _gathered(p["w_up"], cfg, None, "model") + p["b_up"],
                approximate="tanh")
    return h @ _gathered(p["w_down"], cfg, "model", None) + p["b_down"]


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
    return x @ w if b is None else x @ w + b


def _qkv(p, x, cfg):
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = _proj(x, _gathered(p["wq"], cfg, None, "model"), p.get("bq"))
    k = _proj(x, _gathered(p["wk"], cfg, None, "model"), p.get("bk"))
    v = _proj(x, _gathered(p["wv"], cfg, None, "model"), p.get("bv"))
    B, S = x.shape[0], x.shape[1]
    return (q.reshape(B, S, h, hd), k.reshape(B, S, kv, hd),
            v.reshape(B, S, kv, hd))


def _expand_kv(k, num_heads):
    """(B, S, KV, hd) -> (B, S, H, hd) by repeating each KV head ``rep``
    times in a row (``jnp.repeat``), so query head h reads KV head
    h // rep.  The repeat axis goes after the KV axis before the reshape;
    ``repeat_interleave`` would do the same but waits on the device for
    its output size."""
    B, S, KV, hd = k.shape
    rep = num_heads // KV if num_heads % KV == 0 else -(-num_heads // KV)
    k = k[:, :, :, None].expand(B, S, KV, rep, hd).reshape(B, S, KV * rep, hd)
    return k[:, :, :num_heads]


def naive_attention(q, k, v, *, causal: bool, window: int = 0
                    ) -> torch.Tensor:
    """Reference attention. q:(B,Sq,H,hd) k,v:(B,Sk,H,hd).  The plain
    version of the kernel, ``ref.flash_attention_ref``, computes it."""
    return KREF.flash_attention_ref(q, k, v, causal=causal, window=window)


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
        m = torch.full((B, H, bq), -1e30, device=dev)
        l = torch.zeros((B, H, bq), device=dev)
        acc = torch.zeros((B, H, bq, hd), device=dev)
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
    dq = [torch.zeros((B, H, bq, hd), device=dev) for _ in range(nq)]
    dks, dvs = [], []
    for k0 in range(0, kp.shape[2], bk):
        kf, vf = kp[:, :, k0:k0 + bk], vp[:, :, k0:k0 + bk]
        dkj = torch.zeros((B, H, bk, hd), device=dev)
        dvj = torch.zeros((B, H, bk, hd), device=dev)
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
    out, _ = _FlashMHA.apply(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), causal, window, bq, bk,
                             q_offset)
    return out.transpose(1, 2)


def attention_train(p, x, cfg, *, causal: bool = True,
                    positions: Optional[torch.Tensor] = None):
    """Full-sequence attention (train / prefill).  Cross-attention
    (``kv_override`` in the JAX package) comes with the encoder-decoder
    models, which are not ported yet."""
    B, S, _ = x.shape
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _qkv(p, x, cfg)
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    k = _expand_kv(k, h)
    v = _expand_kv(v, h)
    win = cfg.sliding_window
    if cfg.attn_impl == "naive" or S <= 1024:
        o = naive_attention(q, k, v, causal=causal, window=win)
    elif cfg.attn_impl == "pallas":
        o = KOPS.flash_attention(q, k, v, causal=causal, window=win)
    else:
        o = chunked_attention(q, k, v, causal=causal, window=win)
    o = o.reshape(B, S, h * hd)
    return o @ _gathered(p["wo"], cfg, "model", None)


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


def attention_decode(p, x, cache, pos, cfg):
    """One-token self-attention against the cache.

    x: (B, 1, D).  pos: the current position (int).  Returns (out, cache);
    the cache is updated in place.  Cross-attention comes with the
    encoder-decoder models, which are not ported yet."""
    B = x.shape[0]
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    pos = int(pos)
    q = _proj(x, p["wq"], p.get("bq")).reshape(B, 1, h, hd)
    k_new = _proj(x, p["wk"], p.get("bk")).reshape(B, 1, kv, hd)
    v_new = _proj(x, p["wv"], p.get("bv")).reshape(B, 1, kv, hd)
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
    if cfg.sliding_window and cfg.sliding_window <= eff:
        valid = slot_idx < min(pos + 1, eff)   # ring buffer full once warm
    else:
        valid = slot_idx <= pos
    kc = _expand_kv(kc, h)                              # (B, eff, H, hd)
    vc = _expand_kv(vc, h)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kc.float()) / math.sqrt(hd)
    s = torch.where(valid, s, torch.full_like(s, -1e30))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", w, vc.float())
    o = o.to(x.dtype).reshape(B, 1, h * hd)
    return o @ p["wo"], cache


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


class _ChunkedXent(torch.autograd.Function):
    """Masked mean next-token NLL over (x_final @ w_head) chunk by chunk.
    The forward sums each chunk's NLL in chunk order, as the JAX
    package's scan does; the backward recomputes each chunk's logits
    (``jax.checkpoint`` over the scan body in the JAX package):
    dlogits = (softmax - onehot) * mask * g / max(cnt, 1),
    dx = dlogits @ w^T, dw = sum over chunks of x^T dlogits (summed in
    float32, then cast to w's type)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, w, labels, mask, chunk):
        tot = torch.zeros((), device=x.device)
        cnt = torch.zeros((), device=x.device)
        for xc, lc, mc in _xent_chunks(x, labels, mask, chunk):
            logits = (xc @ w).float()                        # (B, c, V)
            lse = torch.logsumexp(logits, dim=-1)
            gold = logits.gather(-1, lc[..., None].long())[..., 0]
            tot = tot + ((lse - gold) * mc).sum()
            cnt = cnt + mc.sum()
        return tot / torch.clamp(cnt, min=1.0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, labels, mask, chunk = inputs
        ctx.save_for_backward(x, w, labels, mask)
        ctx.chunk = chunk

    @staticmethod
    def backward(ctx, g):
        x, w, labels, mask = ctx.saved_tensors
        scale = g / torch.clamp(mask.float().sum(), min=1.0)
        dxs, dw = [], torch.zeros(w.shape, device=w.device)
        for xc, lc, mc in _xent_chunks(x, labels, mask, ctx.chunk):
            logits = (xc @ w).float()
            idx = lc[..., None].long()
            dl = torch.softmax(logits, dim=-1) - torch.zeros_like(
                logits).scatter(-1, idx, 1.0)
            dl = (dl * (mc * scale)[..., None]).to(x.dtype)
            dxs.append(dl @ w.transpose(-1, -2))
            dw = dw + (xc.transpose(-1, -2) @ dl).float()
        dx = torch.cat(dxs, dim=1)[:, :x.shape[1]]
        return dx, dw.to(w.dtype), None, None, None


def chunked_softmax_xent(logits_fn, x_final, w_head, labels, mask,
                         chunk: int = 256):
    """Cross-entropy with the vocab projection fused per sequence chunk,
    so the (B, S, V) logits are never held (``logits_fn`` is unused, as
    in the JAX package).  x_final: (B, S, D) final hidden states; w_head:
    (D, V); labels, mask: (B, S)."""
    return _ChunkedXent.apply(x_final, w_head, labels, mask,
                              min(chunk, x_final.shape[1]))
