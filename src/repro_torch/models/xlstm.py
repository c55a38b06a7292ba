"""xLSTM mixers: mLSTM (matrix memory, chunkwise parallel) and sLSTM
(scalar memory, strictly sequential) [arXiv:2405.04517]
(``repro.models.xlstm``).

The mLSTM's parallel form is chunkwise: a loop over sequence chunks of
256 carrying the (C, n, m) matrix-memory state, with a quadratic part
inside each chunk.  The forget gates' log-cumsum inside a chunk runs in
XLA's order (``rng.cumsum``), so the decays round as in the reference.
The sLSTM is a Python loop over time, the reference's ``lax.scan``: each
step depends on the last through the recurrent matrices.  Every function
returns new tensors; none writes in place.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as Fn
from torch.utils.checkpoint import checkpoint

from repro_torch import rng
from repro_torch.models.layers import dense_init, matmul, torch_dtype
from repro_torch.models.mamba import softplus
from repro_torch.sharding.constrain import (gather_inner, is_distributed,
                                           loop_trips, maybe_constrain,
                                           merge_last, on_local_shards,
                                           split_last)

NEG = -1e30                  # the reference's "minus infinity"


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: ``-softplus(-x)``."""
    return -softplus(-x)


# ----------------------------------------------------------------------
# mLSTM
# ----------------------------------------------------------------------

def init_mlstm(key, cfg, *, device="cuda") -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    h = cfg.xlstm_num_heads
    dt = torch_dtype(cfg.dtype)
    ks = rng.split(key, 8)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "wq": dense_init(ks[0], (d, d), dt, device=device),
        "wk": dense_init(ks[1], (d, d), dt, device=device),
        "wv": dense_init(ks[2], (d, d), dt, device=device),
        "wz": dense_init(ks[3], (d, d), dt, device=device),  # output gate
        "wo": dense_init(ks[4], (d, d), dt, device=device),
        "wi": dense_init(ks[5], (d, h), torch.float32, device=device),
        "wf": dense_init(ks[6], (d, h), torch.float32, device=device),
        "bi": torch.zeros((h,), **f32),
        "bf": torch.full((h,), 3.0, **f32),     # open forget gates at init
    }


def _mlstm_qkv(p, x, h):
    dh = x.shape[-1] // h
    # inside the mesh the sequence gathered once for the six products,
    # and one float32 copy that the two gates keep (off it a copy each,
    # so that x's gradient sums in the same order)
    x = gather_inner(x)
    xf = x.float() if is_distributed(x) else None

    def heads(t):
        return split_last(t, h, dh).transpose(1, 2)      # (B,h,S,dh)

    def gate(w):
        # the (D, h) gate weights whole inside the mesh (a few KB): left to
        # DTensor, the product may split the 4 heads over 'model', which
        # does not divide them
        return matmul(x.float() if xf is None else xf,
                      maybe_constrain(p[w], None, None))

    q, k, v = (heads(matmul(x, p[w])) for w in ("wq", "wk", "wv"))
    li = (gate("wi") + p["bi"]).transpose(1, 2)                   # (B,h,S)
    lf = log_sigmoid(gate("wf") + p["bf"]).transpose(1, 2)
    return q, k, v, li, lf


def apply_mlstm(p, x, cfg, *, chunk: int = 256):
    """Chunkwise-parallel mLSTM. x: (B, S, D) -> (B, S, D).  Inside the
    mesh each device runs the chunk loop on its local shards, as the JAX
    package splits the work: rows over 'data' and v's head_dim over
    'model' (output column j and C's column j read only v's column j,
    and the denominator reads no v), q, k and the gates whole there.  So
    no collective runs in the loop, and q's and k's gradients come back
    partial sums over 'model'.  DTensor's own placements for the loop's
    products would split a dim that the 16-way axis does not divide (4
    heads, or a pod's 8-row batch shard), and its local views fail
    (torch 2.11).  Under ``cfg.remat`` (the block under
    ``torch.utils.checkpoint``) each chunk is recomputed in the
    backward, keeping only the carried (C, n, m), as JAX's
    ``jax.checkpoint`` on the scan step."""
    q, k, v, li, lf = _mlstm_qkv(p, x, cfg.xlstm_num_heads)   # (B,h,S,dh)
    out = _mlstm_loop(q, k, v, li, lf, chunk,
                      cfg.remat and torch.is_grad_enabled())
    out = merge_last(out.to(x.dtype).transpose(1, 2))
    out = out * Fn.silu(matmul(x, p["wz"]))
    return matmul(out, p["wo"])


def _mlstm_loop(q, k, v, li, lf, chunk: int, recompute: bool):
    """:func:`_mlstm_chunks`, inside the mesh on the local shards: rows
    over 'data', v's head_dim (and the output's) over 'model'."""
    if not is_distributed(q):
        return _mlstm_chunks(q, k, v, li, lf, chunk, recompute)
    q, k = (maybe_constrain(t, "data", None, None, None) for t in (q, k))
    v = maybe_constrain(v, "data", None, None, "model")
    li, lf = (maybe_constrain(t, "data", None, None) for t in (li, lf))
    return on_local_shards(lambda *a: _mlstm_chunks(*a, chunk, recompute),
                           v.placements, q, k, v, li, lf)


def _mlstm_step(q, k, v, ii, ff, C, n, m, scale):
    """One chunk: q, k (B, h, c, dk), v (B, h, c, dv), ii, ff (B, h, c),
    the carried C (B, h, dk, dv), n (B, h, dk), m (B, h) -> (the chunk's
    output (B, h, c, dv) float32, C, n, m at its end)."""
    c = q.shape[2]
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    F = rng.cumsum(ff)                             # inclusive log decay
    Ftot = F[..., -1]
    # state written at s decays by F[t] - F[s]; write gain ii[s]
    ldecay = F[..., :, None] - F[..., None, :] + ii[..., None, :]
    ldecay = torch.where(tri, ldecay, NEG)         # causal, s <= t
    linter = F + m[..., None]                      # decay of carried state
    m_t = torch.maximum(linter, ldecay.amax(-1))              # (B,h,chunk)
    wintra = torch.exp(ldecay - m_t[..., None])
    winter = torch.exp(linter - m_t)

    qf = q.float() * scale
    kf, vf = k.float(), v.float()
    s_qk = torch.einsum("bhtd,bhsd->bhts", qf, kf) * wintra
    num = torch.einsum("bhts,bhsv->bhtv", s_qk, vf) \
        + torch.einsum("bhtd,bhdv->bhtv", qf, C) * winter[..., None]
    nvec = torch.einsum("bhts,bhsd->bhtd", wintra, kf) \
        + n[..., None, :] * winter[..., None]
    den = torch.einsum("bhtd,bhtd->bht", qf, nvec).abs()
    out = num / torch.maximum(den, torch.exp(-m_t))[..., None]

    # ---- state update to the end of the chunk ----
    m_new = torch.maximum(Ftot + m, (Ftot[..., None] - F + ii).amax(-1))
    wstate = torch.exp(Ftot[..., None] - F + ii - m_new[..., None])
    carry = torch.exp(Ftot + m - m_new)
    C = C * carry[..., None, None] \
        + torch.einsum("bhs,bhsd,bhsv->bhdv", wstate, kf, vf)
    n = n * carry[..., None] + torch.einsum("bhs,bhsd->bhd", wstate, kf)
    return out, C, n, m_new


def _mlstm_chunks(q, k, v, li, lf, chunk: int, recompute: bool = False):
    """The chunk loop: q, k (B, h, S, dk), v (B, h, S, dv), li, lf (B, h,
    S) -> (B, h, S, dv) float32.  The scale is dk's, so that a shard of
    v's columns (dv < dk) gives its columns of the whole.  With
    ``recompute`` each chunk runs under ``torch.utils.checkpoint``."""
    B, h, S, dh = q.shape
    dv = v.shape[-1]
    scale = 1.0 / math.sqrt(dh)
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        q, k, v = (Fn.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        li = Fn.pad(li, (0, pad), value=NEG)       # padded i-gate: no write
        lf = Fn.pad(lf, (0, pad))

    C = torch.zeros((B, h, dh, dv), dtype=torch.float32, device=q.device)
    n = torch.zeros((B, h, dh), dtype=torch.float32, device=q.device)
    m = torch.zeros((B, h), dtype=torch.float32, device=q.device)
    outs = []
    for s0 in range(0, S + pad, chunk):
        sl = slice(s0, s0 + chunk)
        args = (q[:, :, sl], k[:, :, sl], v[:, :, sl], li[..., sl],
                lf[..., sl], C, n, m, scale)
        if recompute:
            out, C, n, m = checkpoint(_mlstm_step, *args, use_reentrant=False)
        else:
            out, C, n, m = _mlstm_step(*args)
        outs.append(out)
    return torch.cat(outs, dim=2)[:, :, :S]


def init_mlstm_cache(cfg, batch, layers_leading=(), *, device="cuda"):
    d, h = cfg.d_model, cfg.xlstm_num_heads
    dh = d // h
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "C": torch.zeros((*layers_leading, batch, h, dh, dh), **f32),
        "n": torch.zeros((*layers_leading, batch, h, dh), **f32),
        "m": torch.zeros((*layers_leading, batch, h), **f32),
    }


def decode_mlstm(p, x, cache, cfg):
    """One-token mLSTM step. x: (B, 1, D) -> (out, new_cache).  Inside
    the mesh it runs on local shards as the chunk loop does: rows over
    'data', v's, C's and the output's head_dim over 'model' (C's
    placement in the decode state), q, k, n and the gates whole there
    (DTensor's plan for the products fails, torch 2.11)."""
    h = cfg.xlstm_num_heads
    dh = x.shape[-1] // h
    q, k, v, li, lf = _mlstm_qkv(p, x, h)          # (B,h,1,dh), (B,h,1)
    q, k, v = q[:, :, 0], k[:, :, 0], v[:, :, 0]
    li, lf = li[..., 0], lf[..., 0]                # (B,h)
    C, n, m = cache["C"], cache["n"], cache["m"]
    if is_distributed(q):
        q, k, n = (maybe_constrain(t, "data", None, None) for t in (q, k, n))
        li, lf, m = (maybe_constrain(t, "data", None) for t in (li, lf, m))
        v = maybe_constrain(v, "data", None, "model")
        C = maybe_constrain(C, "data", None, None, "model")
        fw, iw, m_new, n_new, qf, norm = on_local_shards(
            lambda *a: _decode_gates(*a, dh), q.placements, q, k, li, lf, n,
            m)
        C_new, out = on_local_shards(_decode_values, C.placements, k, v, C,
                                     fw, iw, qf, norm)
    else:
        fw, iw, m_new, n_new, qf, norm = _decode_gates(q, k, li, lf, n, m, dh)
        C_new, out = _decode_values(k, v, C, fw, iw, qf, norm)
    out = merge_last(out[:, :, 0])[:, None].to(x.dtype)
    out = out * Fn.silu(matmul(x, p["wz"]))
    return matmul(out, p["wo"]), {"C": C_new, "n": n_new, "m": m_new}


def _decode_gates(q, k, li, lf, n, m, dh):
    """The step's parts that read no v: (fw, iw, m, n at the step's end,
    the scaled q, the output's normaliser)."""
    m_new = torch.maximum(lf + m, li)
    fw = torch.exp(lf + m - m_new)
    iw = torch.exp(li - m_new)
    n_new = n * fw[..., None] + iw[..., None] * k.float()
    qf = q.float() / math.sqrt(dh)
    den = torch.einsum("bhd,bhd->bh", qf, n_new).abs()
    return fw, iw, m_new, n_new, qf, torch.maximum(den, torch.exp(-m_new))


def _decode_values(k, v, C, fw, iw, qf, norm):
    """C at the step's end and the output (B, h, 1, dv), for v's
    columns."""
    C_new = C * fw[..., None, None] + iw[..., None, None] \
        * k.float()[..., :, None] * v.float()[..., None, :]
    num = torch.einsum("bhd,bhdv->bhv", qf, C_new)
    return C_new, (num / norm[..., None])[:, :, None]


# ----------------------------------------------------------------------
# sLSTM
# ----------------------------------------------------------------------

GATES = ("z", "i", "f", "o")


def init_slstm(key, cfg, *, device="cuda") -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    h = cfg.xlstm_num_heads
    dh = d // h
    dt = torch_dtype(cfg.dtype)
    ks = rng.split(key, 9)
    p = {"wo_proj": dense_init(ks[8], (d, d), dt, device=device)}
    for i, g in enumerate(GATES):
        p[f"w{g}"] = dense_init(ks[i], (d, d), dt, device=device)
        # per-head block-diagonal recurrent matrix
        p[f"r{g}"] = dense_init(ks[4 + i], (h, dh, dh), torch.float32,
                                scale=0.5, device=device)
        p[f"b{g}"] = torch.full((d,), 3.0 if g == "f" else 0.0,
                                dtype=torch.float32, device=device)
    return p


def _slstm_cell(p, xg, state):
    """One time step. xg: dict of (B, H, dh) pre-activations from W x."""
    c, n, hprev, m = state                          # (B,H,dh) each

    def rec(g):
        return torch.einsum("bhe,hed->bhd", hprev, p[f"r{g}"])

    zt = torch.tanh(xg["z"] + rec("z"))
    it = xg["i"] + rec("i")
    ft = xg["f"] + rec("f")
    ot = torch.sigmoid(xg["o"] + rec("o"))
    m_new = torch.maximum(ft + m, it)
    iw = torch.exp(it - m_new)
    fw = torch.exp(ft + m - m_new)
    c_new = fw * c + iw * zt
    n_new = fw * n + iw
    h_new = ot * c_new / torch.clamp(n_new, min=1e-6)
    return (c_new, n_new, h_new, m_new), h_new


def _slstm_pre(p, x, h):
    """Input pre-activations for all gates: (B, S, H, dh) each.  Inside
    the mesh x is gathered once (one float32 copy that the four products
    keep) and each (D, D) weight's 'data' shards (FSDP's gather on use),
    so that the products are column-parallel over 'model' with the rows
    over 'data': with both split over 'data', torch 2.11's plan for the
    product's backward fails at one row a device."""
    dh = x.shape[-1] // h
    x = gather_inner(x)
    xf = x.float() if is_distributed(x) else None     # off it: a copy each
    return {g: split_last(matmul(x.float() if xf is None else xf,
                                 maybe_constrain(p[f"w{g}"], None, "model")
                                 .float()) + p[f"b{g}"], h, dh)
            for g in GATES}


RECURRENT = tuple(f"r{g}" for g in GATES)


def _slstm_scan(p, pre):
    """The recurrence over time: p {"rz", ...: (H, dh, dh)}, pre {gate:
    (B, S, H, dh)} -> the hidden states (B, S, H, dh).  The dry run's
    tally runs one step and counts it S times (``loop_trips``); its
    output has the shape of S steps'."""
    B, S, h, dh = pre["z"].shape
    z0 = torch.zeros((B, h, dh), dtype=torch.float32, device=pre["z"].device)
    state = (z0, z0, z0, z0)
    with loop_trips(S) as once:
        if once is not None:
            ht = once(lambda *a: _slstm_cell(dict(zip(RECURRENT, a[:4])),
                                             dict(zip(GATES, a[4:8])),
                                             a[8:])[0],
                      *(p[k] for k in RECURRENT),
                      *(pre[g][:, 0] for g in GATES), *state)[2]
            return ht[:, None].expand(B, S, h, dh).contiguous()
    hs = []
    for t in range(S):
        state, ht = _slstm_cell(p, {g: pre[g][:, t] for g in GATES}, state)
        hs.append(ht)
    return torch.stack(hs, dim=1)


def apply_slstm(p, x, cfg):
    """Sequential sLSTM over the full sequence. x: (B, S, D).  Inside the
    mesh the pre-activations' 'model' shards are gathered once and each
    device runs the S steps on its local rows (B over 'data'; the
    recurrent matrices are replicated and each (batch, head) row is
    independent), so no step dispatches through DTensor."""
    pre = _slstm_pre(p, x, cfg.xlstm_num_heads)
    if is_distributed(pre["z"]):
        pre = [maybe_constrain(pre[g], "data", None, None, None)
               for g in GATES]
        hs = on_local_shards(
            lambda *t: _slstm_scan(dict(zip(RECURRENT, t[4:])),
                                   dict(zip(GATES, t[:4]))),
            pre[0].placements, *pre, *(p[k] for k in RECURRENT))
    else:
        hs = _slstm_scan(p, pre)
    out = merge_last(hs).to(x.dtype)
    return matmul(out, p["wo_proj"])


def init_slstm_cache(cfg, batch, layers_leading=(), *, device="cuda"):
    d, h = cfg.d_model, cfg.xlstm_num_heads
    shape = (*layers_leading, batch, h, d // h)
    return {s: torch.zeros(shape, dtype=torch.float32, device=device)
            for s in ("c", "n", "h", "m")}


def decode_slstm(p, x, cache, cfg):
    """One-token sLSTM step. x: (B, 1, D) -> (out, new_cache).  Inside
    the mesh the step runs on the local rows (B over 'data'; the state's
    'model' shards gathered), as the full sequence does: DTensor's plan
    for the recurrent product fails there (torch 2.11)."""
    pre = _slstm_pre(p, x, cfg.xlstm_num_heads)
    xg = [pre[g][:, 0] for g in GATES]
    state = [cache[s] for s in ("c", "n", "h", "m")]
    if is_distributed(xg[0]):
        xg, state = ([maybe_constrain(t, "data", None, None) for t in ts]
                     for ts in (xg, state))
        c, n, hh, m, hnew = on_local_shards(
            lambda *t: _decode_cell(t[8:], t[:4], t[4:8]),
            xg[0].placements, *xg, *state, *(p[k] for k in RECURRENT))
    else:
        c, n, hh, m, hnew = _decode_cell([p[k] for k in RECURRENT], xg,
                                         state)
    out = matmul(merge_last(hnew)[:, None].to(x.dtype), p["wo_proj"])
    return out, {"c": c, "n": n, "h": hh, "m": m}


def _decode_cell(rec, xg, state):
    """(c, n, h, m, h) of one step: rec the recurrent matrices, xg the
    gates' pre-activations, in RECURRENT's and GATES' order."""
    new, hnew = _slstm_cell(dict(zip(RECURRENT, rec)), dict(zip(GATES, xg)),
                            tuple(state))
    return (*new, hnew)
