"""The hand-written CUDA flash-attention kernel and its binding.

``csrc/flash_attention.cu`` replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention`` (body ``_kernel``);
the source's header says what bounds it on an H100 and how the design
answers.  It is built at first use by :mod:`repro_torch.kernels.build`
and bound with ``ctypes``.  Nothing here runs at import time: the CPU
tests import this module without a compiler.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import build as B

# the score of a masked key: csrc/flash_attention.cu's NEG_INF and its
# oracle's (kernels/ref.py); not -inf, so a row that sees no key stays
# finite, as in the Pallas kernel
NEG_INF = -1e30

LIBRARY = B.CudaLibrary("flash_attention.cu", {
    "flash_attention": ([B.P, B.P, B.P, B.P, B.I, B.I, B.I, B.I, B.I, B.I,
                         B.F, B.I, B.I, B.P], B.I),
})


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, window: int,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Launch the kernel on ``torch.cuda.current_stream()``.

    q: (B, Sq, H, hd), k and v: (B, Sk, H, hd) (K/V already expanded to H
    heads), all float32 or all bfloat16, contiguous and 16-byte aligned, on
    one CUDA device; hd a multiple of 8 up to 256.  Scores are scaled by
    ``scale``, 1/sqrt(hd) unless given (a caller that zero-pads hd passes
    that of the true hd).  Returns o (B, Sq, H, hd) in q's type.  Raises on anything the kernel does not take and when
    the launch fails."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_cuda takes q, k and v on one CUDA "
                         "device")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            k.dtype == v.dtype == q.dtype):
        raise TypeError(f"q, k, v must all be float32 or all bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 or (
            k.shape[0], k.shape[2], k.shape[3]) != (
            q.shape[0], q.shape[2], q.shape[3]):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} are not (B, Sq, H, hd) and "
                         "(B, Sk, H, hd)")
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    if hd % 8 or not 8 <= hd <= 256:
        raise ValueError(f"flash_attention_cuda takes a head_dim that is a "
                         f"multiple of 8 up to 256, got {hd}")
    if min(b, sq, sk, h) <= 0 or max(b, h) > 65535:
        raise ValueError(f"flash_attention_cuda cannot launch B={b}, Sq={sq}, "
                         f"Sk={sk}, H={h}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must start on a 16-byte boundary (the "
                         "kernel copies 16-byte chunks)")
    lib = LIBRARY.load()
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            int(q.dtype == torch.bfloat16), b, h, sq, sk, hd,
            1.0 / math.sqrt(hd) if scale is None else float(scale),
            int(bool(causal)), int(window),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    return o
