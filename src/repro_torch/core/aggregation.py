"""Screened robust FedAvg: the defended aggregation layer.

The runtimes' plain paths fuse the FedAvg reduction into their training
programs, which propagates a single poisoned row into the global model.
When ``cfg.defended`` (any ``--defense``, or an active ``--attack``) the
server routes stage 3 through this module instead: every runtime returns
the cohort's per-client flat param deltas as one ``(C, D)`` float32
matrix (:class:`UpdateBatch`), and :func:`make_screened_step` applies the
corruption model (``sim/dynamics.corrupt_updates``: the attack happens
on the device, after local training), screens, aggregates and updates
the reputation ledger, all on the device and without a host
synchronisation:

  1. **quarantine** — rows with a non-finite coordinate are excluded and
     the survivors' weights renormalised.  It comes first: a NaN row
     poisons every statistic computed over it.
  2. **adaptive band** (``--defense-mode adaptive``) — survivor norms
     above a running median + ``k_eff`` x a running MAD are screened out
     like quarantine and earn ``outlier_strike``; ``k_eff`` tightens as
     the screen-rate EMA (``pressure``) rises.
  3. **defense** (``cfg.defense``): ``clip`` (each row's norm clipped to
     ``clip_mult`` x the running median norm, then the renormalised
     weighted mean), ``trimmed`` (coordinate-wise mean after dropping
     ``ceil(trim_frac * V)`` values from each tail), ``median``
     (coordinate-wise median) or ``none`` (the plain weighted sum,
     corrupted rows included: the attack baseline).
  4. **reputation** — one scatter-add of a strike per quarantined client
     (and the band's fractional strikes) into ``SelectionState.strikes``
     on a fresh tensor; the round step bans or prices struck clients.

Every decision keeps the JAX package's float32 arithmetic: percentile
indices are ``int(float32(q) * float32(v - 1))`` truncated, the trim
count is ``ceil(float32(trim_frac) * float32(v))`` clipped to
``(v - 1) // 2``, and the order is ``isfinite``, then norms, then the
band comparison, so quarantine, band and strike verdicts are the JAX
package's bit for bit on the same rows.  The row axis is padded to the
static :func:`screen_capacity`, as in the JAX package (its ``noise``
draw is by position in the padded matrix).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import FLConfig
from repro_torch.device import resolve_device

DEFENSES = ("none", "clip", "trimmed", "median")
DEFENSE_MODES = ("static", "adaptive")

Tree = Dict[str, torch.Tensor]


@dataclass
class DefenseState:
    """The screened aggregation's carried statistics (0-d float32 tensors
    on the device); a feature that is off keeps its field None, which a
    checkpoint drops, as the JAX package's pytree does.

      * ``clip_ema`` — running median survivor norm (0 = unseeded);
      * ``mad_ema``  — running MAD of survivor norms (adaptive only);
      * ``pressure`` — EMA of the per-round screen rate (adaptive only);
      * ``tighten``  — cumulative watchdog tightening factor (watchdog
        on only): thresholds divide by it.
    """

    clip_ema: torch.Tensor
    mad_ema: Optional[torch.Tensor] = None
    pressure: Optional[torch.Tensor] = None
    tighten: Optional[torch.Tensor] = None


def init_defense_state(cfg: FLConfig, device="cuda") -> DefenseState:
    """Round-0 defense state under ``cfg``."""
    if cfg.defense_mode not in DEFENSE_MODES:
        raise ValueError(f"unknown defense_mode={cfg.defense_mode!r}; "
                         f"expected {DEFENSE_MODES}")
    device = resolve_device(device)
    adaptive = cfg.defense_mode == "adaptive"

    def scalar(v):
        return torch.full((), v, dtype=torch.float32, device=device)

    return DefenseState(
        clip_ema=scalar(0.0),
        mad_ema=scalar(0.0) if adaptive else None,
        pressure=scalar(0.0) if adaptive else None,
        tighten=scalar(1.0) if cfg.watchdog_enabled else None)


@dataclass
class UpdateBatch:
    """A cohort's per-client updates as a runtime returns them:
    ``deltas`` (C, D) float32 flat deltas against the dispatched globals
    (row order = packer order, padding rows all-zero), ``weights`` (C,)
    float32 FedAvg weights (0 on padding) and ``client_idx`` (C,) int32
    global ids (-1 on padding), both on the host."""

    deltas: torch.Tensor
    weights: np.ndarray
    client_idx: np.ndarray


def flat_size(params: Tree) -> int:
    """Total flat parameter count D."""
    return int(sum(v.numel() for v in params.values()))


def screen_capacity(cfg: FLConfig) -> int:
    """Static row capacity of the screened step: the largest cohort any
    scheme can produce (per-cluster k x J, or the random scheme's K),
    rounded up to a power of two."""
    from repro_torch.core.selection import k_per_cluster
    k_total = max(int(round(cfg.select_ratio * cfg.num_clients)), 1)
    bound = min(cfg.num_clients,
                max(k_total, k_per_cluster(cfg) * cfg.num_clusters))
    cap = 1
    while cap < bound:
        cap *= 2
    return cap


def flat_delta(new: Tree, old: Tree) -> torch.Tensor:
    """(D,) float32 ``new - old``, leaves in sorted-key order (the JAX
    package's ``jax.tree.leaves`` order on a dict)."""
    return torch.cat([(new[k].float() - old[k].float()).reshape(-1)
                      for k in sorted(old)])


def apply_delta(params: Tree, flat: torch.Tensor) -> Tree:
    """``params + flat``: the inverse of :func:`flat_delta`'s layout."""
    out, o = {}, 0
    for k in sorted(params):
        p = params[k]
        n = p.numel()
        out[k] = p + flat[o:o + n].reshape(p.shape).to(p.dtype)
        o += n
    return out


def _percentile_sorted(sorted_vals: torch.Tensor, v: torch.Tensor,
                       q: float) -> torch.Tensor:
    """q-th percentile of the first ``v`` entries of an ascending vector
    (invalid entries sorted to +inf at the tail); 0 when v = 0."""
    cap = sorted_vals.shape[0]
    idx = torch.clamp((q * (v - 1).float()).to(torch.int64), 0, cap - 1)
    val = sorted_vals.index_select(0, idx.reshape(1)).reshape(())
    return torch.where(v > 0, val, 0.0)


def _ema(old: torch.Tensor, new: torch.Tensor, beta: float) -> torch.Tensor:
    return (1.0 - beta) * old + beta * new


def make_screened_step(cfg: FLConfig):
    """The fused corrupt -> quarantine -> (adaptive band) -> defend ->
    aggregate -> reputation step::

        (deltas (cap, D) f32, weights (cap,) f32, valid (cap,) bool,
         adv (cap,) bool, ids (cap,) int32, strikes (N,) f32,
         dstate: DefenseState, round_idx () int32, key)
          -> (agg_delta (D,), new_strikes (N,), new_dstate,
              report: dict of 0-d tensors)

    All tensors on one device; ``key`` is a host key of ``repro_torch.rng``
    (the ``noise`` attack's draw).  Nothing in it reads a device value
    back, so the report rides the server's pending buffer and drains with
    the round's one batched fetch."""
    from repro_torch.sim import dynamics as DYN
    defense = cfg.defense
    if defense not in DEFENSES:
        raise ValueError(f"unknown defense={defense!r}; expected {DEFENSES}")
    if cfg.defense_mode not in DEFENSE_MODES:
        raise ValueError(f"unknown defense_mode={cfg.defense_mode!r}; "
                         f"expected {DEFENSE_MODES}")
    adaptive = cfg.defense_mode == "adaptive" and defense != "none"

    def screen(deltas, weights, valid, adv, ids, strikes, dstate,
               round_idx, key):
        cap, d = deltas.shape
        dev = deltas.device
        clip_state = dstate.clip_ema
        deltas = DYN.corrupt_updates(cfg, key, deltas, adv, valid,
                                     clip_ema=clip_state,
                                     round_idx=round_idx)
        finite = torch.isfinite(deltas).all(dim=1)
        if defense == "none":
            # no screening: corrupted rows flow into the aggregate
            quarantined = torch.zeros_like(valid)
            ok = valid
        else:
            quarantined = valid & ~finite
            ok = valid & finite
        # statistics over finite valid rows only, so a NaN row never
        # poisons them, even with the defense off
        mok = valid & finite
        safe = torch.where(mok[:, None], deltas, 0.0)
        norms = DYN.sqrt32(torch.square(safe).sum(1))
        v_metric = mok.sum()
        sorted_norms = torch.sort(torch.where(mok, norms, math.inf)).values
        p50 = _percentile_sorted(sorted_norms, v_metric, 0.50)
        p99 = _percentile_sorted(sorted_norms, v_metric, 0.99)
        # running median norm, seeded by the first non-empty round
        new_clip = torch.where(
            v_metric > 0,
            torch.where(clip_state > 0, _ema(clip_state, p50, cfg.clip_beta),
                        p50),
            clip_state)
        tight = dstate.tighten
        if adaptive:
            dev_norm = torch.where(mok, torch.abs(norms - p50), math.inf)
            mad = _percentile_sorted(torch.sort(dev_norm).values, v_metric,
                                     0.50)
            new_mad = torch.where(
                v_metric > 0,
                torch.where(dstate.clip_ema > 0,
                            _ema(dstate.mad_ema, mad, cfg.clip_beta), mad),
                dstate.mad_ema)
            # a Python number over a tensor would be a reciprocal times
            # the number in torch, not one division as in XLA
            k_eff = (torch.full_like(dstate.pressure, cfg.adapt_k)
                     / (1.0 + cfg.adapt_gain * dstate.pressure))
            if tight is not None:
                k_eff = k_eff / tight
            mad_safe = torch.maximum(new_mad, cfg.adapt_mad_floor * new_clip)
            thr_band = new_clip + k_eff * mad_safe
            outlier = mok & (norms > thr_band) & (new_clip > 0)
            ok = ok & ~outlier
        else:
            new_mad = dstate.mad_ema
            outlier = torch.zeros_like(valid)
        okf = ok.float()
        thr = cfg.clip_mult * new_clip
        if tight is not None:
            thr = thr / tight
        clipped = mok & (norms > thr)
        v = ok.sum()
        zeros = torch.zeros(d, dtype=torch.float32, device=dev)

        if defense == "none":
            agg = (weights * okf) @ deltas
        elif defense == "clip":
            factor = torch.where(clipped,
                                 thr / torch.clamp(norms, min=1e-12), 1.0)
            w_ok = weights * okf
            mass = w_ok.sum()
            agg = torch.where(
                mass > 0,
                (w_ok / torch.clamp(mass, min=1e-12))
                @ (safe * factor[:, None]), zeros)
        elif defense == "trimmed":
            s = torch.sort(torch.where(ok[:, None], deltas, math.inf),
                           dim=0).values
            k = torch.ceil(cfg.trim_frac * v.float()).to(torch.int64)
            k = torch.minimum(torch.clamp(k, min=0), torch.clamp(
                torch.div(v - 1, 2, rounding_mode="floor"), min=0))
            ranks = torch.arange(cap, device=dev)[:, None]
            keep = (ranks >= k) & (ranks < v - k)
            kept = torch.where(keep, s, 0.0)
            agg = torch.where(
                v > 0, DYN.column_sum(kept)
                / torch.clamp(v - 2 * k, min=1).float(), zeros)
        else:   # median
            s = torch.sort(torch.where(ok[:, None], deltas, math.inf),
                           dim=0).values
            lo = torch.clamp(torch.div(v - 1, 2, rounding_mode="floor"),
                             0, cap - 1)
            hi = torch.clamp(torch.div(v, 2, rounding_mode="floor"),
                             0, cap - 1)
            agg = torch.where(
                v > 0, 0.5 * (s.index_select(0, lo.reshape(1))[0]
                              + s.index_select(0, hi.reshape(1))[0]),
                zeros)

        # reputation: one scatter-add on a copy, never on the caller's
        # tensor (a watchdog snapshot may hold it)
        n = strikes.shape[0]
        add = (torch.where(quarantined, 1.0, 0.0)
               + cfg.outlier_strike * torch.where(outlier, 1.0, 0.0))
        new_strikes = strikes.clone().index_add_(
            0, torch.clamp(ids.long(), 0, n - 1), add)
        if adaptive:
            rejected = (quarantined | outlier).sum().float()
            frac = rejected / torch.clamp(v_metric, min=1).float()
            new_pressure = _ema(dstate.pressure, frac, cfg.pressure_beta)
        else:
            new_pressure = dstate.pressure
        new_dstate = DefenseState(clip_ema=new_clip, mad_ema=new_mad,
                                  pressure=new_pressure,
                                  tighten=dstate.tighten)
        n_valid = valid.sum()
        report: Dict[str, torch.Tensor] = {
            "num_quarantined": quarantined.sum(),
            "num_screened": outlier.sum(),
            "num_survivors": v,
            "survivor_frac": torch.where(
                n_valid > 0,
                v.float() / torch.clamp(n_valid, min=1).float(), 0.0),
            "clipped_frac": torch.where(
                v_metric > 0,
                clipped.sum() / torch.clamp(v_metric, min=1).float(), 0.0),
            "update_norm_p50": p50,
            "update_norm_p99": p99,
            "defense_pressure": (new_pressure if adaptive
                                 else torch.zeros((), device=dev)),
        }
        return agg, new_strikes, new_dstate, report

    return screen
