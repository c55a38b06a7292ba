"""Public wrapper for the fused Lloyd kernel with device dispatch.

``lloyd_step`` launches the hand-written CUDA kernel
(``repro_torch/csrc/kmeans.cu``, replacing the Pallas TPU kernel
``repro/kernels/kmeans.py::lloyd_step``) for CUDA tensors and raises if
the build or the launch fails; it takes the plain version,
:func:`_lloyd_step_torch`, only because the tensors lie on the CPU.
``lloyd_step.launches`` counts kernel launches (one per call), so a run
can show that its k-means went through the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref as REF
from repro_torch.kernels.kmeans import lloyd_step_cuda


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
