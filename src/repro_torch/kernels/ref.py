"""Plain-torch oracles for the kernels, twins of ``repro.kernels.ref``.

The fused Lloyd step is batched over restarts: ``x`` is (N, F) and ``c``
is (R, K, F), or (K, F) for one restart (then every output loses its
leading R axis).  Outputs: labels int32 (R, N), min distance float32
(R, N), sums float32 (R, K, F) = onehot^T x and counts float32 (R, K).
The assign oracles take one (K, F) ``c``; the attention oracle takes
(B, S, H, hd) q, k, v with K/V already expanded to H heads.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import NEG_INF


def _batched(c: torch.Tensor):
    return (c[None], True) if c.dim() == 2 else (c, False)


def _finish(d, x32, k, squeeze):
    """Argmin (first index on ties), min distance and the update from
    (R, N, K) distances.  Each centroid's sum adds its rows in row order
    (``index_add_``; on the CPU the result does not depend on the
    centroid's index, which a one-hot matmul does not promise)."""
    lab = d.argmin(dim=2)
    dist = torch.gather(d, 2, lab[..., None])[..., 0]
    sums = torch.stack([x32.new_zeros(k, x32.shape[1]).index_add_(0, lr, x32)
                        for lr in lab])                     # (R, K, F)
    counts = torch.stack([torch.bincount(lr, minlength=k) for lr in lab])
    out = (lab.int(), dist, sums, counts.float())
    return tuple(t[0] for t in out) if squeeze else out


def lloyd_step_ref(x: torch.Tensor, c: torch.Tensor):
    """The naive oracle: (R, N, K, F) broadcast distances, one restart at
    a time (as ``repro.kernels.ref.lloyd_step_ref``)."""
    c, squeeze = _batched(c)
    x32 = x.float()
    d = torch.stack([((x32[:, None, :] - cr.float()[None]) ** 2).sum(-1)
                     for cr in c])                         # (R, N, K)
    return _finish(d, x32, c.shape[1], squeeze)


def _broadcast_dist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return ((x.float()[:, None, :] - c.float()[None]) ** 2).sum(-1)


def kmeans_assign_ref(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """x: (N, F), c: (K, F) -> argmin_k ||x_n - c_k||^2, int32 (N,)."""
    return _broadcast_dist(x, c).argmin(dim=1).int()


def kmeans_min_dist_ref(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return _broadcast_dist(x, c).amin(dim=1)


def attention_mask(qpos: torch.Tensor, kpos: torch.Tensor, *, causal: bool,
                   window: int) -> torch.Tensor:
    """(len(qpos), len(kpos)) bool: which keys each query position sees."""
    qpos, kpos = qpos[:, None], kpos[None, :]
    mask = torch.ones((qpos.shape[0], kpos.shape[1]), dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: int = 0) -> torch.Tensor:
    """Naive attention with an fp32 softmax: q (B, Sq, H, hd), k, v
    (B, Sk, H, hd) -> (B, Sq, H, hd) in q's type; masked scores are
    NEG_INF.  It is also the model's ``naive`` attention."""
    sq, sk, hd = q.shape[1], k.shape[1], q.shape[3]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     k.float()) / math.sqrt(hd)
    mask = attention_mask(torch.arange(sq, device=q.device),
                          torch.arange(sk, device=q.device), causal=causal,
                          window=window)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v.float()).to(q.dtype)
