"""Mamba (selective SSM) mixer block, jamba's recurrent layer
(``repro.models.mamba``).

Training and prefill use the chunked scan: a loop over sequence chunks
of 256 carrying the SSM state ``h``, and inside a chunk an associative
scan over the (decay, input) pairs with the carry prepended.  The scan
is :func:`associative_scan`, the odd/even recursion of
``lax.associative_scan`` written in torch: log depth (about 2 log2(257)
= 17 vectorised steps a chunk, where a loop would take 256), and the
same tree of combinations as the reference, so the float32 products and
sums pair up as XLA pairs them (XLA may still fuse a multiply and an add
that torch rounds twice, so the two agree to a tolerance, not bit for
bit).  ``jax.checkpoint`` on the reference's chunk step is remat only
and moves no number; the port keeps no remat inside the block.

Decode is the exact single-step recurrence with a (conv ring, ssm state)
cache: the ``(dc - 1, di)`` ring in ``cfg.dtype``, the state in float32.
Every function returns new tensors; none writes in place.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as Fn

from repro_torch import rng, xla_math
from repro_torch.models.layers import dense_init, matmul, torch_dtype
from repro_torch.sharding.constrain import maybe_constrain


def init_mamba(key, cfg, *, device="cuda") -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    di = cfg.mamba_d_inner
    ds = cfg.mamba_d_state
    dc = cfg.mamba_d_conv
    dr = cfg.dt_rank
    dt = torch_dtype(cfg.dtype)
    ks = rng.split(key, 7)
    # S4D-real A: XLA's float32 log of 1..d_state, bit for bit
    a_log = xla_math.log(torch.arange(1, ds + 1, dtype=torch.float32,
                                      device=device))
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "w_in": dense_init(ks[0], (d, 2 * di), dt, device=device),
        "conv_w": dense_init(ks[1], (dc, di), dt, device=device),
        "conv_b": torch.zeros((di,), dtype=dt, device=device),
        "w_x_dbc": dense_init(ks[2], (di, dr + 2 * ds), dt, device=device),
        "w_dt": dense_init(ks[3], (dr, di), dt, device=device),
        "b_dt": torch.log(torch.expm1(torch.tensor(0.01))).to(device)
        * torch.ones((di,), **f32),
        "a_log": a_log[None, :].expand(di, ds).contiguous(),
        "d_skip": torch.ones((di,), **f32),
        "w_out": dense_init(ks[4], (di, d), dt, device=device),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` at every x
    (``torch.nn.functional.softplus`` switches to x above 20)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def _ssm_params(p, x, cfg):
    """x: (..., di) conv+silu output -> (dt, B, C) selective params."""
    dr, ds = cfg.dt_rank, cfg.mamba_d_state
    # the contraction over d_inner ('model') reduced once, before the
    # slices (DTensor slices no partial sum)
    dbc = matmul(x, p["w_x_dbc"])
    dbc = maybe_constrain(dbc, "data", *(None,) * (dbc.ndim - 1))
    dt_r, b, c = dbc[..., :dr], dbc[..., dr:dr + ds], dbc[..., dr + ds:]
    dt = softplus(matmul(dt_r.float(), p["w_dt"].float()) + p["b_dt"])
    return dt, b.float(), c.float()


def _conv_taps(xp, w, b, s):
    """sum_j xp[:, j:j+s] * w[j] + b over the dc taps, in the reference's
    order, in float32, rounded once to xp's type: XLA computes the
    reference's fused elementwise chain so, and the prefill and the
    decode step (one tap window, :func:`decode_mamba`) then round alike.
    A bf16 chain rounded at every step drifts from the decode's, and
    jamba's routers turn that drift into expert flips."""
    wf = w.float()
    out = sum(xp[:, j:j + s].float() * wf[j] for j in range(w.shape[0]))
    return (out + b.float()).to(xp.dtype)


def _causal_conv(x, w, b):
    """x: (B, S, di); depthwise causal conv along S with kernel (dc, di)."""
    # zeros before the sequence (a cat: DTensor pads no dim)
    xp = torch.cat([torch.zeros_like(x[:, :1]).expand(
        -1, w.shape[0] - 1, -1), x], dim=1)
    return _conv_taps(xp, w, b, x.shape[1])


def _combine(a1, b1, a2, b2):
    """(a1, b1) then (a2, b2): the decay products and the state."""
    return a2 * a1, a2 * b1 + b2


def _interleave(x, y):
    """[x0, y0, x1, y1, ...] along axis 1 (x may be one longer)."""
    n = y.shape[1]
    out = torch.stack([x[:, :n], y], dim=2).reshape(
        x.shape[0], 2 * n, *x.shape[2:])
    return torch.cat([out, x[:, n:]], dim=1) if x.shape[1] > n else out


def associative_scan(a, b):
    """Inclusive scan of (a, b) pairs along axis 1 under
    :func:`_combine`, by ``lax.associative_scan``'s recursion: combine
    adjacent pairs, scan the half, then fill in the even elements."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine(a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2])
    oa, ob = associative_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = _combine(oa, ob, a[:, 2::2], b[:, 2::2])
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def apply_mamba(p, x, cfg, *, chunk: int = 256):
    """Full-sequence mamba mixer. x: (B, S, D) -> (B, S, D)."""
    B, S, D = x.shape
    di, ds = cfg.mamba_d_inner, cfg.mamba_d_state
    xz = matmul(x, p["w_in"])
    xi, z = xz[..., :di], xz[..., di:]                    # (B,S,di)
    xi = maybe_constrain(xi, "data", None, "model")
    xi = Fn.silu(_causal_conv(xi, p["conv_w"], p["conv_b"]))
    dt, bmat, cmat = _ssm_params(p, xi, cfg)
    a = -torch.exp(p["a_log"])                            # (di, ds)

    # discretize: da[t] = exp(dt[t] * A); dbx[t] = dt * B[t] * x[t]
    chunk = min(chunk, S)
    pad = (-S) % chunk
    xf, dt_, b_, c_ = (Fn.pad(t, (0, 0, 0, pad)) if pad else t
                       for t in (xi.float(), dt, bmat, cmat))
    h = torch.zeros((B, di, ds), dtype=torch.float32, device=x.device)
    ys = []
    for s0 in range(0, S + pad, chunk):
        xc, dtc = xf[:, s0:s0 + chunk], dt_[:, s0:s0 + chunk]
        bc, cc = b_[:, s0:s0 + chunk], c_[:, s0:s0 + chunk]
        da = torch.exp(dtc[..., None] * a)                # (B,chunk,di,ds)
        da = maybe_constrain(da, "data", None, "model", None)
        dbx = (dtc * xc)[..., None] * bc[..., None, :]
        dbx = maybe_constrain(dbx, "data", None, "model", None)
        # the carry prepended as the first element
        da0 = torch.cat([torch.ones_like(da[:, :1]), da], dim=1)
        dbx0 = torch.cat([h[:, None], dbx], dim=1)
        _, hs = associative_scan(da0, dbx0)
        hs = hs[:, 1:]                                    # (B,chunk,di,ds)
        ys.append(torch.einsum("bcds,bcs->bcd", hs, cc))
        h = hs[:, -1]
    y = torch.cat(ys, dim=1)[:, :S]
    y = y + xi.float() * p["d_skip"]
    y = (y * Fn.silu(z.float())).to(x.dtype)
    return matmul(y, p["w_out"])


# ---------------------------- decode ----------------------------------

def init_mamba_cache(cfg, batch, layers_leading=(), *, device="cuda"):
    di, ds, dc = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
    return {
        "conv": torch.zeros((*layers_leading, batch, dc - 1, di),
                            dtype=torch_dtype(cfg.dtype), device=device),
        "ssm": torch.zeros((*layers_leading, batch, di, ds),
                           dtype=torch.float32, device=device),
    }


def decode_mamba(p, x, cache, cfg):
    """One-token mamba step. x: (B, 1, D) -> (out, new_cache)."""
    di = cfg.mamba_d_inner
    xz = x[:, 0] @ p["w_in"]
    xi, z = xz[..., :di], xz[..., di:]                    # (B, di)
    # conv ring: the state holds the previous dc-1 inputs
    conv_in = torch.cat([cache["conv"], xi[:, None]], dim=1)  # (B,dc,di)
    xc = Fn.silu(_conv_taps(conv_in, p["conv_w"], p["conv_b"], 1)[:, 0])
    dt, bvec, cvec = _ssm_params(p, xc, cfg)              # (B,di),(B,ds)
    a = -torch.exp(p["a_log"])
    da = torch.exp(dt[..., None] * a)                     # (B,di,ds)
    h = cache["ssm"] * da + (dt * xc.float())[..., None] \
        * bvec[:, None, :]
    y = torch.einsum("bds,bs->bd", h, cvec)
    y = y + xc.float() * p["d_skip"]
    y = (y * Fn.silu(z.float())).to(x.dtype)
    out = (y @ p["w_out"])[:, None]
    return out, {"conv": conv_in[:, 1:], "ssm": h}
