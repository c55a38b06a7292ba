"""Public wrappers for the hand-written kernels, with device dispatch.

Each wrapper launches its CUDA kernel for CUDA tensors and raises if the
build or the launch fails; it takes its plain version only because the
tensors lie on the CPU:

* ``lloyd_step`` -> ``csrc/kmeans.cu`` (replaces the Pallas TPU kernel
  ``repro/kernels/kmeans.py::lloyd_step``), plain :func:`_lloyd_step_torch`;
* ``kmeans_assign`` -> ``csrc/kmeans.cu`` (replaces
  ``repro/kernels/kmeans.py::kmeans_assign``), plain
  :func:`_kmeans_assign_torch`;
* ``flash_attention`` -> ``csrc/flash_attention.cu`` (replaces
  ``repro/kernels/flash_attention.py::flash_attention``), plain
  :func:`_flash_attention_torch`.

``<wrapper>.launches`` counts kernel launches (one per call on the card),
so a run can show that its path went through the kernel.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ref as REF
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.kmeans import kmeans_assign_cuda, lloyd_step_cuda


def distances(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(R, N, K) float32 squared distances by the kernel's decomposition
    ``||x||^2 - 2 x.c^T + ||c||^2``; x (N, F), c (R, K, F).

    Each x.c is reduced on its own, as the kernel does, not by a matmul:
    a CPU GEMM rounds a column differently depending on where it sits, so
    two restarts that reach the same partition under different centroid
    numbers would not tie exactly in inertia, and the best-restart argmin
    would stop taking the first of them as the JAX package does."""
    x32, c32 = x.float(), c.float()
    cross = torch.stack([(x32[:, None, :] * cr[None]).sum(2) for cr in c32])
    return ((x32 * x32).sum(1)[None, :, None] - 2.0 * cross
            + (c32 * c32).sum(2)[:, None, :])


def _lloyd_step_torch(x: torch.Tensor, c: torch.Tensor):
    """The plain version: the kernel's decomposition (distances as
    :func:`distances`, the one-hot update as row sums) as torch ops, the
    twin of ``repro.kernels.ops._lloyd_step_jnp``.  x is (N, F); c is (R, K, F),
    or (K, F) for one restart."""
    c3, squeeze = REF._batched(c)
    return REF._finish(distances(x, c3), x.float(), c3.shape[1], squeeze)


def lloyd_step(x: torch.Tensor, c: torch.Tensor):
    """One fused Lloyd assign+update pass for every restart in ``c``.

    x: (N, F) float32 or bfloat16; c: (R, K, F), or (K, F) for R = 1.
    Returns (labels int32, min_dist f32, sums f32, counts f32) shaped
    (R, N), (R, N), (R, K, F), (R, K) — without the R axis for a 2-D c."""
    if x.device != c.device:
        raise ValueError(f"x on {x.device} and c on {c.device}")
    if x.device.type == "cpu":
        return _lloyd_step_torch(x, c)
    c3, squeeze = REF._batched(c)
    out = lloyd_step_cuda(x.contiguous(), c3.float().contiguous())
    lloyd_step.launches += 1
    return tuple(t[0] for t in out) if squeeze else out


lloyd_step.launches = 0


def _kmeans_assign_torch(x: torch.Tensor, c: torch.Tensor):
    """The plain version: labels (first index on ties) and min distances
    by the kernel's decomposition (:func:`distances`)."""
    d = distances(x, c.float()[None])[0]                   # (N, K)
    lab = d.argmin(dim=1)
    return lab.int(), torch.gather(d, 1, lab[:, None])[:, 0]


def kmeans_assign(x: torch.Tensor, c: torch.Tensor):
    """Assignment only: x (N, F) float32 or bfloat16, c (K, F) ->
    (labels int32 (N,), min_dist float32 (N,))."""
    if x.device != c.device:
        raise ValueError(f"x on {x.device} and c on {c.device}")
    if x.device.type == "cpu":
        return _kmeans_assign_torch(x, c)
    out = kmeans_assign_cuda(x.contiguous(), c.float().contiguous())
    kmeans_assign.launches += 1
    return out


kmeans_assign.launches = 0


def _flash_attention_torch(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool = True,
                           window: int = 0) -> torch.Tensor:
    """The plain version: the naive fp32 softmax of
    ``ref.flash_attention_ref``."""
    return REF.flash_attention_ref(q, k, v, causal=causal, window=window)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous and starting on a 16-byte boundary (a view into a
    larger tensor may start anywhere), copied only where it must be."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _pad_head_dim(t: torch.Tensor) -> torch.Tensor:
    """t zero-padded along its last axis (head_dim) to the next multiple
    of 8, which the kernel takes; a head_dim over 256 stays as it is (the
    kernel refuses it)."""
    hd = t.shape[-1]
    if hd % 8 == 0 or hd > 256:
        return t
    return torch.nn.functional.pad(t, (0, -hd % 8))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Forward attention: q (B, Sq, H, hd), k, v (B, Sk, H, hd) with K/V
    already expanded to H heads -> (B, Sq, H, hd) in q's type.  There is
    no backward: under autograd, with an input that requires grad, it
    raises ``NotImplementedError``.

    The kernel takes head dims that are multiples of 8; another hd under
    256 is zero-padded to the next one (zero columns add nothing to q.k,
    and the output's padded columns are dropped), with the scale of the
    true hd."""
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        # as jax.grad through the Pallas kernel fails: neither has a
        # backward, and no other attention stands in for it
        raise NotImplementedError(
            "flash_attention (attn_impl='pallas') has no backward; train "
            "with attn_impl='chunked' or 'naive'")
    if q.device.type == "cpu":
        return _flash_attention_torch(q, k, v, causal=causal, window=window)
    hd = q.shape[-1]
    q, k, v = (_aligned(_pad_head_dim(t)) for t in (q, k, v))
    out = flash_attention_cuda(q, k, v, causal=causal, window=window,
                               scale=1.0 / math.sqrt(hd))
    flash_attention.launches += 1
    return out[..., :hd] if out.shape[-1] != hd else out


flash_attention.launches = 0
