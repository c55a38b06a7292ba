"""Client dynamics, the part the selection schemes read: the straggler
latency model.

FedCS (``core/schemes.py``) predicts each client's round latency at bid
time from this model: the compute term scales with the client's local
sample count (the same ``Ns_i`` that drives eq 11's energy) times a
slowdown factor drawn under ``cfg.straggler_profile``, plus a fixed
up/download term, in units of the fleet-mean round time.

  * ``energy`` (default): a full battery runs at 1x, an empty one at
    about 3x, with a small jitter so equal-energy clients still differ;
  * ``uniform`` / ``lognormal``: energy-independent noise;
  * ``none``: deterministic.

The fault model (availability churn, deadline misses, ``fault_step``)
is not ported yet (ROADMAP.md, queue 1: fleet dynamics).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import rng
from repro_torch.configs.base import FLConfig

STRAGGLER_PROFILES = ("energy", "uniform", "lognormal", "none")


def latency_scale(cfg: FLConfig, key, residual: torch.Tensor
                  ) -> torch.Tensor:
    """Per-client slowdown factor under ``cfg.straggler_profile``."""
    p = cfg.straggler_profile
    dev = residual.device
    if p == "none":
        return torch.ones_like(residual)
    if p == "uniform":
        return rng.uniform(key, residual.shape, 0.5, 2.0, dev)
    if p == "lognormal":
        return torch.exp(0.5 * rng.normal(key, residual.shape, dev))
    if p == "energy":
        # residual / 100 as XLA compiles it: times the float32 of 0.01
        frac = torch.clamp(residual * float(np.float32(0.01)), 0.0, 1.0)
        jitter = rng.uniform(key, residual.shape, 0.9, 1.1, dev)
        return (1.0 + 2.0 * (1.0 - frac)) * jitter
    raise ValueError(f"unknown straggler_profile={p!r}; "
                     f"expected {STRAGGLER_PROFILES}")


def round_latency(cfg: FLConfig, key, residual: torch.Tensor,
                  local_sizes: torch.Tensor) -> torch.Tensor:
    """Per-client compute+network latency in units of the fleet-mean
    round time: the local sample count over the fleet mean times the
    straggler factor, plus 0.05 for the model's up/download."""
    sizes = local_sizes.float()
    # jnp.mean as XLA runs it: the sum times the float32 reciprocal of N
    mean = sizes.sum() * float(np.float32(1.0) / np.float32(sizes.numel()))
    compute = sizes / torch.clamp(mean, min=1.0)
    # one rounding for the multiply-add, as XLA fuses it under jit
    return rng._fma(compute, latency_scale(cfg, key, residual),
                    float(np.float32(0.05)))
