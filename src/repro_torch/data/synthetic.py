"""Synthetic image datasets (offline: no MNIST download).

Class-conditional image distributions with the paper's tensor shapes:

  * 'mnist'  : (28, 28, 1), 10 classes
  * 'fmnist' : (28, 28, 1), 10 classes
  * 'cifar'  : (32, 32, 3), 10 classes

Each class c has a smooth random template (a 7x7 Gaussian seed upsampled
bilinearly); samples are template + per-sample translation jitter + pixel
noise.  The draws come from ``repro_torch.rng``, so labels and shifts are
the JAX package's own and pixels agree to float rounding.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import rng
from repro_torch.device import resolve_device


@dataclass
class Dataset:
    x: np.ndarray          # (N, H, W, C) float32 in [0, 1]
    y: np.ndarray          # (N,) int32
    num_classes: int


def _templates(key, num_classes: int, hw: Tuple[int, int, int], device):
    h, w, c = hw
    seeds = rng.normal(key, (num_classes, 7, 7, c), device)
    # bilinear upsampling, half-pixel centres: the same weights as
    # jax.image.resize(..., "bilinear") when upsampling (NCHW for torch)
    t = F.interpolate(seeds.permute(0, 3, 1, 2), size=(h, w),
                      mode="bilinear", align_corners=False,
                      antialias=False).permute(0, 2, 3, 1)
    return 0.5 + 0.35 * t / torch.clamp(t.abs().max(), min=1e-6)


# fixed name->seed offsets (Python's hash(name) varies per process)
_NAME_SEEDS = {"mnist": 11, "fmnist": 22_222, "cifar": 44_444}


def _name_seed(name: str) -> int:
    if name in _NAME_SEEDS:
        return _NAME_SEEDS[name]
    return zlib.crc32(name.encode()) % 65536


def _roll(base: torch.Tensor, sh: torch.Tensor) -> torch.Tensor:
    """Per-sample ``jnp.roll`` by (sh[n, 0], sh[n, 1]) over (H, W)."""
    n, h, w = base.shape[:3]
    rows = (torch.arange(h, device=base.device)[None, :] - sh[:, :1]) % h
    cols = (torch.arange(w, device=base.device)[None, :] - sh[:, 1:]) % w
    b = torch.arange(n, device=base.device)[:, None, None]
    return base[b, rows[:, :, None], cols[:, None, :]]


def make_image_dataset(name: str, n_train: int = 12_000, n_test: int = 2_000,
                       noise: float = 0.12, seed: int = 0,
                       device="cuda") -> Tuple[Dataset, Dataset]:
    device = resolve_device(device)
    hw = (32, 32, 3) if name == "cifar" else (28, 28, 1)
    nc = 10
    key = rng.PRNGKey(seed + _name_seed(name))
    kt, kn1, kn2, _, _ = rng.split(key, 5)
    temps = _templates(kt, nc, hw, device)

    def gen(k, n):
        ky, kshift, knoise = rng.split(k, 3)
        y = rng.randint(ky, (n,), 0, nc, device)
        sh = rng.randint(kshift, (n, 2), -2, 3, device)
        base = _roll(temps[y], sh)
        x = base + noise * rng.normal(knoise, base.shape, device)
        return (torch.clamp(x, 0.0, 1.0).cpu().numpy().astype(np.float32),
                y.cpu().numpy().astype(np.int32))

    xtr, ytr = gen(rng.fold_in(kn1, 0), n_train)
    xte, yte = gen(rng.fold_in(kn2, 1), n_test)
    return Dataset(xtr, ytr, nc), Dataset(xte, yte, nc)
