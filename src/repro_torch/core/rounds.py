"""Round control plane: the paper's per-round stage-2 pipeline (cost ->
Nash bids -> s_min -> per-cluster reverse auction -> rewards ->
energy/history update -> metrics) as one function of (state, key).

Every metric the RoundLog needs is computed on the state's device and
returned as 0-d tensors, so the server fetches them in one batch at its
logging boundaries.

``simulate_rounds`` is the selection-only simulation (``--mode
selection``): the round step in a Python loop over rounds on the JAX
key chain, with the metrics kept on the device as (T,) tensors.  No op of
a round reads a device value back or copies a host value to the device,
so the loop queues its rounds without waiting for the card, as the JAX
package's ``lax.scan`` does.  ``simulate_rounds_reference`` is its
exact-equality oracle: the per-cluster winner loop and a fetch every
round.  The fleet-dynamics round (fault model, staleness) is not ported
yet (ROADMAP.md, queue 1: fleet dynamics).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import rng
from repro_torch.configs.base import FLConfig
from repro_torch.core import auction as A
from repro_torch.core import energy as E
from repro_torch.core import schemes as SCH
from repro_torch.core import selection as SEL
from repro_torch.core.virtual_dataset import virtual_dataset_gap_device
from repro_torch.device import resolve_device

Metrics = Dict[str, torch.Tensor]


def round_rewards(win: torch.Tensor, bids: torch.Tensor,
                  local_sizes: torch.Tensor, cfg: FLConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-client rewards + server share under cfg.reward_model (eq 15/16).
    Zero-winner rounds pay exactly zero on both sides."""
    if cfg.reward_model == "bid_share":
        return A.reward_bid_share(win, bids, cfg)
    return (A.reward_sample_share(win, local_sizes, cfg),
            torch.zeros((), device=bids.device))


def _round_body(state: SEL.SelectionState, key, cfg: FLConfig,
                count_hists: Optional[torch.Tensor],
                global_hist: Optional[torch.Tensor],
                winners_impl: str = "segmented",
                avail: Optional[torch.Tensor] = None
                ) -> Tuple[SEL.SelectionState, torch.Tensor, Metrics]:
    """One full control-plane round, a pure function of (state, key)."""
    scheme = SCH.get_scheme(cfg.scheme_select)
    if state.strikes is not None and cfg.reputation_mode == "ban":
        trust = state.strikes < cfg.strike_threshold
        avail = trust if avail is None else (avail & trust)
    win, info = scheme.select(state, cfg, key, winners_impl=winners_impl,
                              avail=avail)
    bids = info["bids"]
    client_r, server_r = round_rewards(win, bids, state.local_sizes, cfg)
    new_state = SEL.update_after_round(state, win, cfg)
    scheme_state, scheme_metrics = scheme.update_state(
        state, new_state, cfg, win, info, client_r)
    new_state = dataclasses.replace(new_state, scheme_state=scheme_state)

    dev = bids.device
    nwin = win.sum()
    winning_bids = torch.where(win, bids, torch.zeros_like(bids))
    metrics: Metrics = {
        "num_winners": nwin,
        "mean_bid": torch.where(
            nwin > 0, winning_bids.sum() / torch.clamp(nwin, min=1),
            torch.zeros((), device=dev)),
        "client_reward_sum": client_r.sum(),
        "server_reward": server_r.float(),
        "s_min": (info["s_min"].to(torch.int32) if "s_min" in info
                  else torch.zeros((), dtype=torch.int32, device=dev)),
        "vds_gap": (virtual_dataset_gap_device(win, count_hists, global_hist)
                    if count_hists is not None
                    else torch.zeros((), device=dev)),
        "fairness_hist_std": new_state.history.float().std(correction=0),
    }
    metrics.update(E.energy_stats(new_state.residual))
    metrics.update(scheme_metrics)
    if state.strikes is not None:
        metrics["num_banned"] = (state.strikes >= cfg.strike_threshold).sum()
        trust_score = 1.0 / (1.0 + state.strikes)
        metrics["trust_mean"] = trust_score.mean()
        metrics["trust_min"] = trust_score.min()
    return new_state, win, metrics


def _hists(count_hists, global_hist, device):
    """The label histograms as float32 tensors on ``device`` (or None)."""
    def put(a):
        return (None if a is None else
                torch.as_tensor(np.asarray(a, np.float32), device=device))
    return put(count_hists), put(global_hist)


def make_round_step(cfg: FLConfig,
                    count_hists: Optional[np.ndarray] = None,
                    global_hist: Optional[np.ndarray] = None,
                    winners_impl: str = "segmented",
                    dynamics: bool = False, device="cuda"):
    """A ``(state, key) -> (new_state, win, metrics)`` round step for the
    live FL loop.  ``count_hists`` is the (N, num_classes) per-client
    label-count matrix; with it the vds-gap is computed on the device,
    otherwise it logs 0.  The histograms are cast to float32 and moved to
    ``device`` once, here."""
    if dynamics:
        raise NotImplementedError(
            "the fleet-dynamics round step is not ported yet (ROADMAP.md, "
            "queue 1: fleet dynamics)")
    ch, gh = _hists(count_hists, global_hist, resolve_device(device))

    def round_step(state: SEL.SelectionState, key):
        return _round_body(state, key, cfg, ch, gh, winners_impl)

    return round_step


# ----------------------------------------------------------------------
# selection-only simulation over rounds
# ----------------------------------------------------------------------

def simulate_rounds(state: SEL.SelectionState, cfg: FLConfig, key,
                    rounds: int,
                    count_hists: Optional[np.ndarray] = None,
                    global_hist: Optional[np.ndarray] = None,
                    record_wins: bool = False):
    """Run ``rounds`` rounds of the selection/auction/energy dynamics (no
    stage-3 training) on the JAX key chain (``key, k = split(key)`` a
    round).  Returns ``(final_state, metrics, wins)``: ``metrics`` maps
    each round metric to a (rounds,) tensor on the state's device, for
    the caller to fetch once; ``wins`` is the (rounds, N) bool winner
    masks when ``record_wins`` (at N = 1M x T = 1k that is 1 GB), else
    None."""
    ch, gh = _hists(count_hists, global_hist, state.clusters.device)
    rows, wins = [], []
    for _ in range(int(rounds)):
        key, k = rng.split(key)
        state, win, metrics = _round_body(state, k, cfg, ch, gh,
                                          "segmented")
        rows.append(metrics)
        if record_wins:
            wins.append(win)
    stacked = ({name: torch.stack([m[name] for m in rows])
                for name in rows[0]} if rows else {})
    if not record_wins:
        return state, stacked, None
    return state, stacked, (torch.stack(wins) if wins else torch.zeros(
        (0, state.clusters.shape[0]), dtype=torch.bool,
        device=state.clusters.device))


def simulate_rounds_reference(state: SEL.SelectionState, cfg: FLConfig,
                              key, rounds: int,
                              count_hists: Optional[np.ndarray] = None,
                              global_hist: Optional[np.ndarray] = None,
                              record_wins: bool = False):
    """The per-round oracle of :func:`simulate_rounds`: the per-cluster
    winner loop (``winners_impl="loop"``) and every round's metrics
    fetched to the host as it ends.  Same signature; returns numpy
    metrics (and numpy winner masks)."""
    ch, gh = _hists(count_hists, global_hist, state.clusters.device)
    rows, wins = [], []
    for _ in range(int(rounds)):
        key, k = rng.split(key)
        state, win, metrics = _round_body(state, k, cfg, ch, gh, "loop")
        rows.append({name: v.cpu().numpy() for name, v in metrics.items()})
        if record_wins:
            wins.append(win.cpu().numpy())
    metrics_np = ({name: np.stack([m[name] for m in rows])
                   for name in rows[0]} if rows else {})
    if not record_wins:
        return state, metrics_np, None
    return state, metrics_np, (np.stack(wins) if wins else np.zeros(
        (0, state.clusters.shape[0]), bool))


def synthetic_fleet(cfg: FLConfig, key, size_low: int = 100,
                    size_high: int = 1200,
                    device="cuda") -> SEL.SelectionState:
    """A SelectionState for selection-only runs at any N, built on the
    device: uniform cluster ids, local sizes uniform in [size_low,
    size_high] (the paper's MNIST range at N = 100), the initial energy
    of ``cfg.init_energy_mode`` and a fresh scheme state."""
    device = resolve_device(device)
    k_cl, k_en, k_sz = rng.split(key, 3)
    n = cfg.num_clients
    return SEL.SelectionState(
        clusters=rng.randint(k_cl, (n,), 0, cfg.num_clusters,
                             device).to(torch.int32),
        residual=E.init_energy(cfg, k_en, device),
        history=torch.zeros(n, dtype=torch.int32, device=device),
        local_sizes=rng.randint(k_sz, (n,), size_low, size_high + 1,
                                device).to(torch.int32),
        scheme_state=SCH.init_scheme_state(cfg, device),
    )
