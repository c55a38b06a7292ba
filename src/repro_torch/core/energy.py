"""Energy model of the MEC federated system (paper §IV-A).

Every client has a battery in *percent* (0..100).  Per training round a
selected client pays

    E_sum = E_cp + E_cm                                   (eq 9)
    E_cm  = E_re + E_se                                   (eq 10)
    E_cp  = Ns_i * rho / 100                              (eq 11)

The paper's headline system metric is the **energy balance**: the standard
deviation of residual energy across all clients (population std, N in the
denominator, as ``jnp.std``).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import rng
from repro_torch.configs.base import FLConfig
from repro_torch.device import resolve_device


def init_energy(cfg: FLConfig, key, device="cuda") -> torch.Tensor:
    """Initial residual energy per client, percent scale [0, 100].

    case1 ('full'): everyone at 100%.
    case2 ('normal'): N(mean, std) truncated to [low, high] (paper §V-A).
    """
    device = resolve_device(device)
    n = cfg.num_clients
    if cfg.init_energy_mode == "full":
        return torch.full((n,), 100.0, device=device)
    tn = rng.truncated_normal(
        key, (cfg.init_energy_low - cfg.init_energy_mean)
        / cfg.init_energy_std,
        (cfg.init_energy_high - cfg.init_energy_mean) / cfg.init_energy_std,
        (n,), device)
    e = cfg.init_energy_mean * 100.0 + cfg.init_energy_std * 100.0 * tn
    return torch.clamp(e, cfg.init_energy_low * 100.0,
                       cfg.init_energy_high * 100.0)


def compute_cost_energy(local_sizes: torch.Tensor, cfg: FLConfig
                        ) -> torch.Tensor:
    """E_cp per client for one local round (eq 11)."""
    return local_sizes.float() * cfg.energy_per_100_samples / 100.0


def round_energy(local_sizes: torch.Tensor, cfg: FLConfig) -> torch.Tensor:
    """E_sum per client if selected this round (eq 9-11)."""
    return (compute_cost_energy(local_sizes, cfg)
            + cfg.energy_rx + cfg.energy_tx) * cfg.local_epochs


def apply_round(residual: torch.Tensor, selected: torch.Tensor,
                local_sizes: torch.Tensor, cfg: FLConfig) -> torch.Tensor:
    """Subtract this round's consumption from selected clients (floored at
    0).  The energy term is rounded on its own before the subtraction, as
    the reference pins it (no fused multiply-subtract)."""
    e = round_energy(local_sizes, cfg)
    return torch.where(selected, (residual - e).clamp_min(0.0), residual)


def energy_balance(residual: torch.Tensor) -> torch.Tensor:
    """The paper's balance metric: std-dev of residual energy (Fig 9/10)."""
    return residual.std(correction=0)


def energy_stats(residual: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Fleet energy summary computed with the round's other metrics."""
    return {
        "energy_std": residual.std(correction=0),
        "energy_mean": residual.mean(),
        "energy_min": residual.min(),
    }
