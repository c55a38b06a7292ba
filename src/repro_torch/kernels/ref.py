"""Plain-torch oracles for the fused Lloyd kernel, batched over restarts.

``x`` is (N, F) and ``c`` is (R, K, F), or (K, F) for one restart (then
every output loses its leading R axis).  Outputs: labels int32 (R, N),
min distance float32 (R, N), sums float32 (R, K, F) = onehot^T x and
counts float32 (R, K).
"""
from __future__ import annotations

import torch


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

