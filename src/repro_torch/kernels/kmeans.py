"""The hand-written CUDA kernel for the fused Lloyd step, and its build.

``csrc/kmeans.cu`` replaces the Pallas TPU kernel
``repro/kernels/kmeans.py::lloyd_step`` (body ``_lloyd_kernel``); the
source's header says what bounds it on an H100 and how the design
answers.  It is compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (``build/repro_torch/`` at the
root of the checkout) and bound with ``ctypes``.  Nothing here runs at
import time: the CPU tests import this module without a compiler.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional, Tuple

import torch

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "kmeans.cu"
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIB: Optional[ctypes.CDLL] = None
BUILD_LOG = ""                      # nvcc's -Xptxas -v report


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernel is built on a "
                           "machine with the CUDA toolkit")
    return found


def _lib_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libkmeans_{digest[:16]}.so"


def build() -> float:
    """Compile ``csrc/kmeans.cu`` unless an up-to-date library is already
    there, and load it.  Returns the seconds the build took (0.0 when
    there was nothing to build)."""
    global _LIB, BUILD_LOG
    if _LIB is not None:
        return 0.0
    out, secs = _lib_path(), 0.0
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(SOURCE)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        secs = time.perf_counter() - t0
        BUILD_LOG = proc.stdout
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCE}:\n{proc.stdout}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.lloyd_step.argtypes = [P, I, P, I, I, I, I, I, P, P, P, P, P, P, P]
    lib.lloyd_step.restype = I
    for fn in ("lloyd_rows_per_tile", "lloyd_max_restarts",
               "lloyd_max_centroids"):
        getattr(lib, fn).argtypes = []
        getattr(lib, fn).restype = I
    _LIB = lib
    return secs


def lloyd_step_cuda(x: torch.Tensor, c: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    """Launch the fused Lloyd kernel on ``torch.cuda.current_stream()``.

    x: (N, F) float32 or bfloat16, c: (R, K, F) float32, both contiguous
    on the same CUDA device.  Returns labels int32 (R, N), dist float32
    (R, N), sums float32 (R, K, F), counts float32 (R, K).  Raises on
    anything the kernel does not take and when the launch fails."""
    if not (x.is_cuda and c.is_cuda) or x.device != c.device:
        raise ValueError("lloyd_step_cuda takes x and c on one CUDA device")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if c.dtype != torch.float32:
        raise TypeError(f"c must be float32, got {c.dtype}")
    if x.dim() != 2 or c.dim() != 3 or c.shape[2] != x.shape[1]:
        raise ValueError(f"shapes x {tuple(x.shape)} and c {tuple(c.shape)} "
                         "are not (N, F) and (R, K, F)")
    if not (x.is_contiguous() and c.is_contiguous()):
        raise ValueError("x and c must be contiguous")
    n, f = x.shape
    r, k = c.shape[0], c.shape[1]
    build()
    lib = _LIB
    if not (0 < k <= lib.lloyd_max_centroids()
            and 0 < r <= lib.lloyd_max_restarts() and n > 0 and f > 0):
        raise ValueError(f"lloyd_step_cuda takes 1 <= K <= "
                         f"{lib.lloyd_max_centroids()} and 1 <= R <= "
                         f"{lib.lloyd_max_restarts()}; got K={k}, R={r}, "
                         f"N={n}, F={f}")
    tiles = -(-n // lib.lloyd_rows_per_tile())
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    blocks = min(tiles, 4 * sms)
    dev = x.device
    labels = torch.empty((r, n), dtype=torch.int32, device=dev)
    dist = torch.empty((r, n), dtype=torch.float32, device=dev)
    sums = torch.empty((r, k, f), dtype=torch.float32, device=dev)
    counts = torch.empty((r, k), dtype=torch.float32, device=dev)
    psums = torch.empty((blocks, r, k, f), dtype=torch.float32, device=dev)
    pcounts = torch.empty((blocks, r, k), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.lloyd_step(
            x.data_ptr(), int(x.dtype == torch.bfloat16), c.data_ptr(), n, f,
            k, r, blocks, labels.data_ptr(), dist.data_ptr(),
            sums.data_ptr(), counts.data_ptr(), psums.data_ptr(),
            pcounts.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lloyd_step kernel launch failed: CUDA error "
                           f"{err}")
    return labels, dist, sums, counts
