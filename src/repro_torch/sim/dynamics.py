"""Client dynamics: availability churn, stragglers and deadline misses
(FedCS, Nishio & Yonetani, arXiv:1804.08333), the per-round fault model
the round step (``core/rounds.py``) runs when ``cfg.dynamics_enabled``:

  * **availability churn** — a two-state Markov process per client: an
    available client drops with prob ``cfg.churn`` a round, an
    unavailable one rejoins with prob ``cfg.rejoin_prob``.  Round-start
    availability gates auction eligibility; a winner that goes offline
    mid-round (another ``churn`` draw) is DROPPED.
  * **stragglers** — the latency model: the compute term scales with the
    client's local sample count (the same ``Ns_i`` that drives eq 11's
    energy) times a slowdown factor drawn under
    ``cfg.straggler_profile``, plus a fixed up/download term, in units of
    the fleet-mean round time.  FedCS (``core/schemes.py``) predicts
    latency from the same model at bid time.

      * ``energy`` (default): a full battery runs at 1x, an empty one at
        about 3x, with a small jitter so equal-energy clients still
        differ;
      * ``uniform`` / ``lognormal``: energy-independent noise;
      * ``none``: deterministic.
  * **deadline misses** — a surviving winner whose latency exceeds
    ``cfg.deadline`` (when positive) is LATE: its update exists but
    arrives after the round closes (the buffered aggregation folds it in
    later; the synchronous path loses it).

Every draw comes from a dedicated key chain (:func:`dynamics_key`), apart
from the server's selection chain, so a ``--churn 0`` run stays
bit-identical to a dynamics-free one.  Outcome codes (int32, per
client): 0 = not selected, 1 = COMPLETED, 2 = LATE, 3 = DROPPED.

The Byzantine corruption model lives here too: a fixed adversary set
(:func:`adversary_mask`, drawn once from its own key chain) and
:func:`corrupt_updates`, which perturbs the adversaries' rows of a
cohort's ``(C, D)`` flat delta matrix inside the screened aggregation
(``core/aggregation.py``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from repro_torch import rng
from repro_torch.configs.base import FLConfig
from repro_torch.device import resolve_device

# per-winner outcome codes (see module docstring)
NOT_SELECTED = 0
COMPLETED = 1
LATE = 2
DROPPED = 3

STRAGGLER_PROFILES = ("energy", "uniform", "lognormal", "none")

# update-corruption attacks (core/aggregation.py screens them); the last
# three are adaptive: they read the defense's running state (the clip
# EMA, the honest cohort's statistics, the round counter)
ATTACKS = ("none", "nan", "scale", "signflip", "noise",
           "sub_clip", "alie", "on_off")

# fold_in tag separating the dynamics chain from the selection chain
_DYN_STREAM_TAG = 0x5D7A11CE
# fold_in tag of the adversary chain: its own stream, so corruption
# composes with churn on or off and never draws from the selection chain
_ADV_STREAM_TAG = 0xAD5E11A7


@dataclass
class DynamicsState:
    """Carried fleet-dynamics state: ``avail`` is the churn process's
    current availability mask."""

    avail: torch.Tensor          # (N,) bool — client reachable this round


def dynamics_key(cfg: FLConfig) -> torch.Tensor:
    """Root of the dedicated dynamics key chain: ``fold_in(PRNGKey(seed),
    0x5D7A11CE)``, so it never draws from the selection chain."""
    return rng.fold_in(rng.PRNGKey(cfg.seed), _DYN_STREAM_TAG)


def init_dynamics(cfg: FLConfig, device="cuda") -> DynamicsState:
    """Round-0 dynamics state: everyone starts available."""
    return DynamicsState(avail=torch.ones(
        cfg.num_clients, dtype=torch.bool, device=resolve_device(device)))


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


# ----------------------------------------------------------------------
# Byzantine corruption model (per-winner update perturbation)
# ----------------------------------------------------------------------

def adversary_key(cfg: FLConfig) -> torch.Tensor:
    """Root of the adversary key chain: ``fold_in(PRNGKey(seed),
    0xAD5E11A7)``, apart from the selection and dynamics chains."""
    return rng.fold_in(rng.PRNGKey(cfg.seed), _ADV_STREAM_TAG)


def adversary_mask(cfg: FLConfig, device="cuda") -> torch.Tensor:
    """(N,) bool: the run's fixed Byzantine set, exactly
    ``round(adversary_frac * N)`` clients, the head of
    ``permutation(fold_in(adversary_key, 0), N)``."""
    device = resolve_device(device)
    n = cfg.num_clients
    m = int(round(cfg.adversary_frac * n))
    mask = torch.zeros(n, dtype=torch.bool, device=device)
    if m <= 0:
        return mask
    perm = rng.permutation(rng.fold_in(adversary_key(cfg), 0), n, device)
    return mask.index_fill_(0, perm[:m], True)


def column_sum(x: torch.Tensor) -> torch.Tensor:
    """``x.sum(0)`` of a (C, D) matrix, the rows added one after another
    in order: the order XLA's CPU backend reduces a leading axis in, so
    the sums are the JAX package's bit for bit (torch's own reduction
    order differs, and differs again on CUDA).  C is a cohort's row
    count, so the loop is short."""
    total = x[0]
    for i in range(1, x.shape[0]):
        total = total + x[i]
    return total


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """float32 square root, correctly rounded as XLA's is: through float64
    (torch's vectorised CPU ``sqrt`` is off by an ulp on some inputs)."""
    return torch.sqrt(x.double()).float()


def _honest_stats(deltas: torch.Tensor, adv: torch.Tensor,
                  valid: torch.Tensor):
    """The colluding adversaries' view of the cohort: mean,
    per-coordinate std and median l2 norm of the honest valid rows (the
    median is the lower-middle order statistic, index
    ``int(0.5 * (v - 1))``)."""
    ok = valid & ~adv
    okf = ok[:, None]
    cnt = torch.clamp(ok.sum(), min=1).float()
    mean = column_sum(torch.where(okf, deltas, 0.0)) / cnt
    var = column_sum(torch.where(okf, torch.square(deltas - mean), 0.0)) / cnt
    std = sqrt32(var)
    norms = sqrt32(torch.square(torch.where(okf, deltas, 0.0)).sum(1))
    sorted_n = torch.sort(torch.where(ok, norms, math.inf)).values
    v = ok.sum()
    idx = torch.clamp((0.5 * (v - 1).float()).to(torch.int64), 0,
                      deltas.shape[0] - 1)
    med = sorted_n.index_select(0, idx.reshape(1)).reshape(())
    return mean, std, torch.where(v > 0, med, 0.0)


def corrupt_updates(cfg: FLConfig, key, deltas: torch.Tensor,
                    adv: torch.Tensor, valid: torch.Tensor,
                    clip_ema=None, round_idx=None) -> torch.Tensor:
    """Perturb the adversarial valid rows of a (C, D) flat delta matrix
    under ``cfg.attack``; honest and padding rows pass through unchanged.

      * ``nan``      — the whole row NaN (quarantine catches it);
      * ``scale``    — times ``attack_scale`` (finite: it must be clipped
        or trimmed);
      * ``signflip`` — times ``-attack_scale``;
      * ``noise``    — plus Gaussian noise of std ``attack_scale`` x the
        cohort's RMS delta, drawn as ``normal(key, (C, D))`` by position;
      * ``sub_clip`` — the negated honest mean direction at
        ``sub_clip_margin x clip_mult x`` the clip EMA (the honest median
        norm while the EMA is unseeded): just under a static clip;
      * ``alie``     — honest mean minus ``alie_z`` x the honest std;
      * ``on_off``   — ``scale`` for ``onoff_period`` rounds, then as many
        clean rounds.

    ``clip_ema`` and ``round_idx`` are the screened step's 0-d tensors."""
    a = cfg.attack
    if a == "none" or not cfg.adversary_enabled:
        return deltas
    hit = (adv & valid)[:, None]
    if a == "nan":
        return torch.where(hit, math.nan, deltas)
    if a == "scale":
        return torch.where(hit, cfg.attack_scale * deltas, deltas)
    if a == "signflip":
        return torch.where(hit, -cfg.attack_scale * deltas, deltas)
    if a == "noise":
        ok = valid[:, None]
        denom = torch.clamp(valid.sum() * deltas.shape[1], min=1)
        rms = sqrt32(torch.square(torch.where(ok, deltas, 0.0)).sum() / denom)
        noise = (rng.normal(key, deltas.shape, deltas.device)
                 * cfg.attack_scale * rms)
        return torch.where(hit, deltas + noise, deltas)
    if a == "sub_clip":
        mean, _, med_norm = _honest_stats(deltas, adv, valid)
        base = (med_norm if clip_ema is None
                else torch.where(clip_ema > 0, clip_ema, med_norm))
        target = cfg.sub_clip_margin * cfg.clip_mult * base
        mnorm = sqrt32(torch.square(mean).sum())
        row = -mean / torch.clamp(mnorm, min=1e-12) * target
        return torch.where(hit, row[None, :], deltas)
    if a == "alie":
        mean, std, _ = _honest_stats(deltas, adv, valid)
        # one rounding for the multiply-add, as XLA fuses it under jit
        row = rng._fma(std, float(np.float32(-cfg.alie_z)), mean)
        return torch.where(hit, row[None, :], deltas)
    if a == "on_off":
        period = max(int(cfg.onoff_period), 1)
        if round_idx is None:
            return torch.where(hit, cfg.attack_scale * deltas, deltas)
        active = torch.div(round_idx, period,
                           rounding_mode="floor") % 2 == 0
        return torch.where(hit & active, cfg.attack_scale * deltas, deltas)
    raise ValueError(f"unknown attack={a!r}; expected {ATTACKS}")


# ----------------------------------------------------------------------
# the per-round fault step
# ----------------------------------------------------------------------

def fault_step(cfg: FLConfig, key, win: torch.Tensor, avail: torch.Tensor,
               residual: torch.Tensor, local_sizes: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One round of the fault model.  ``win`` (N,) bool auction winners,
    ``avail`` (N,) bool round-start availability, ``residual`` /
    ``local_sizes`` the SelectionState columns the latency model reads.

    Returns ``(outcome, latency, new_avail)``: (N,) int32 outcome codes
    (NOT_SELECTED for non-winners), (N,) float32 latencies and the next
    round's availability (winners that dropped mid-round start it
    offline; everyone else churns independently)."""
    k_mid, k_lat, k_drop, k_join = rng.split(key, 4)
    dev = win.device
    lat = round_latency(cfg, k_lat, residual, local_sizes)
    # mid-round dropout: a second churn draw
    mid_drop = rng.bernoulli(k_mid, cfg.churn, win.shape, dev)
    survived = win & avail & ~mid_drop
    missed = ((lat > float(np.float32(cfg.deadline)))
              if cfg.deadline > 0.0 else torch.zeros_like(win))
    outcome = torch.where(
        win, torch.where(survived, torch.where(missed, LATE, COMPLETED),
                         DROPPED),
        NOT_SELECTED).to(torch.int32)
    # availability churn for the next round; mid-round droppers are
    # offline whatever their churn draw
    drop = rng.bernoulli(k_drop, cfg.churn, avail.shape, dev)
    join = rng.bernoulli(k_join, cfg.rejoin_prob, avail.shape, dev)
    new_avail = torch.where(avail, ~drop, join) & ~(win & mid_drop)
    return outcome, lat, new_avail


def update_staleness(staleness: torch.Tensor,
                     outcome: torch.Tensor) -> torch.Tensor:
    """Rounds since a client last COMPLETED a round."""
    return torch.where(outcome == COMPLETED, 0,
                       staleness + 1).to(torch.int32)


def outcome_metrics(outcome: torch.Tensor,
                    staleness: torch.Tensor) -> dict:
    """The round's dynamics scalars, on the device (fetched with the
    round's one batched drain)."""
    return {
        "num_completed": (outcome == COMPLETED).sum(),
        "num_late": (outcome == LATE).sum(),
        "num_dropped": (outcome == DROPPED).sum(),
        "staleness_mean": staleness.float().mean(),
        "staleness_max": staleness.max(),
    }


# ----------------------------------------------------------------------
# host-side helpers (server aggregation path)
# ----------------------------------------------------------------------

def split_outcomes(sel_idx: np.ndarray, outcome_np: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The fetched winner indices by outcome: ``(completed, late,
    dropped)``."""
    codes = outcome_np[sel_idx]
    return (sel_idx[codes == COMPLETED], sel_idx[codes == LATE],
            sel_idx[codes == DROPPED])


def staleness_weight(cfg: FLConfig, tau: int) -> float:
    """FedBuff-style staleness discount for a buffered update folded
    ``tau`` rounds after its dispatch: ``(1 + tau) ** -alpha``."""
    return float((1.0 + float(tau)) ** -cfg.staleness_alpha)
