"""The hand-written CUDA kernels for k-means: the Lloyd step and the
assign-only step, and their bindings.

``csrc/kmeans.cu`` replaces the Pallas TPU kernels
``repro/kernels/kmeans.py::lloyd_step`` (body ``_lloyd_kernel``) and
``::kmeans_assign`` (body ``_assign_kernel``); the source's header says
what bounds them on an H100 and how the design answers.  It is built at
first use by :mod:`repro_torch.kernels.build` and bound with ``ctypes``.
Nothing here runs at import time: the CPU tests import this module
without a compiler.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build as B

LIBRARY = B.CudaLibrary("kmeans.cu", {
    "lloyd_step": ([B.P, B.I, B.P, B.I, B.I, B.I, B.I, B.P, B.P, B.P, B.P,
                    B.P, B.P, B.P], B.I),
    "kmeans_assign": ([B.P, B.I, B.P, B.I, B.I, B.I, B.P, B.P, B.P], B.I),
    "lloyd_rows_per_chunk": ([], B.I),
    "lloyd_max_restarts": ([], B.I),
    "lloyd_max_centroids": ([], B.I),
})


def _check_x(x: torch.Tensor, c: torch.Tensor, name: str) -> None:
    if not (x.is_cuda and c.is_cuda) or x.device != c.device:
        raise ValueError(f"{name} takes x and c on one CUDA device")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if c.dtype != torch.float32:
        raise TypeError(f"c must be float32, got {c.dtype}")
    if not (x.is_contiguous() and c.is_contiguous()):
        raise ValueError("x and c must be contiguous")


def lloyd_step_cuda(x: torch.Tensor, c: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    """Launch the Lloyd step (assign, update and, for more than one chunk
    of rows, the reduce) on ``torch.cuda.current_stream()``.

    x: (N, F) float32 or bfloat16, c: (R, K, F) float32, both contiguous
    on the same CUDA device.  Returns labels int32 (R, N), dist float32
    (R, N), sums float32 (R, K, F), counts float32 (R, K).  Raises on
    anything the kernel does not take and when the launch fails."""
    _check_x(x, c, "lloyd_step_cuda")
    if x.dim() != 2 or c.dim() != 3 or c.shape[2] != x.shape[1]:
        raise ValueError(f"shapes x {tuple(x.shape)} and c {tuple(c.shape)} "
                         "are not (N, F) and (R, K, F)")
    n, f = x.shape
    r, k = c.shape[0], c.shape[1]
    lib = LIBRARY.load()
    if not (0 < k <= lib.lloyd_max_centroids()
            and 0 < r <= lib.lloyd_max_restarts() and n > 0 and f > 0):
        raise ValueError(f"lloyd_step_cuda takes 1 <= K <= "
                         f"{lib.lloyd_max_centroids()} and 1 <= R <= "
                         f"{lib.lloyd_max_restarts()}; got K={k}, R={r}, "
                         f"N={n}, F={f}")
    dev = x.device
    labels = torch.empty((r, n), dtype=torch.int32, device=dev)
    dist = torch.empty((r, n), dtype=torch.float32, device=dev)
    sums = torch.empty((r, k, f), dtype=torch.float32, device=dev)
    counts = torch.empty((r, k), dtype=torch.float32, device=dev)
    # per-chunk partial sums, only where a reduce over chunks follows
    chunks = -(-n // lib.lloyd_rows_per_chunk())
    psums = pcounts = None
    if chunks > 1:
        psums = torch.empty((chunks, r, k, f), dtype=torch.float32,
                            device=dev)
        pcounts = torch.empty((chunks, r, k), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.lloyd_step(
            x.data_ptr(), int(x.dtype == torch.bfloat16), c.data_ptr(), n, f,
            k, r, labels.data_ptr(), dist.data_ptr(), sums.data_ptr(),
            counts.data_ptr(), psums.data_ptr() if chunks > 1 else None,
            pcounts.data_ptr() if chunks > 1 else None,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lloyd_step kernel launch failed: CUDA error "
                           f"{err}")
    return labels, dist, sums, counts


def kmeans_assign_cuda(x: torch.Tensor, c: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the assign-only kernel on ``torch.cuda.current_stream()``.

    x: (N, F) float32 or bfloat16, c: (K, F) float32, both contiguous on
    the same CUDA device.  Returns labels int32 (N,) and the min distance
    float32 (N,).  Raises on anything the kernel does not take and when
    the launch fails."""
    _check_x(x, c, "kmeans_assign_cuda")
    if x.dim() != 2 or c.dim() != 2 or c.shape[1] != x.shape[1]:
        raise ValueError(f"shapes x {tuple(x.shape)} and c {tuple(c.shape)} "
                         "are not (N, F) and (K, F)")
    n, f = x.shape
    k = c.shape[0]
    lib = LIBRARY.load()
    if not (0 < k <= lib.lloyd_max_centroids() and n > 0 and f > 0):
        raise ValueError(f"kmeans_assign_cuda takes 1 <= K <= "
                         f"{lib.lloyd_max_centroids()}; got K={k}, N={n}, "
                         f"F={f}")
    labels = torch.empty((n,), dtype=torch.int32, device=x.device)
    dist = torch.empty((n,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.kmeans_assign(
            x.data_ptr(), int(x.dtype == torch.bfloat16), c.data_ptr(), n, f,
            k, labels.data_ptr(), dist.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"kmeans_assign kernel launch failed: CUDA error "
                           f"{err}")
    return labels, dist
