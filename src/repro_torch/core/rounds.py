"""Round control plane: the paper's per-round stage-2 pipeline (cost ->
Nash bids -> s_min -> per-cluster reverse auction -> rewards ->
energy/history update -> metrics) as one function of (state, key).

Every metric the RoundLog needs is computed on the state's device and
returned as 0-d tensors, so the server fetches them in one batch at its
logging boundaries.  The fleet-dynamics round (fault model, staleness)
is not ported yet (ROADMAP.md, queue 1: fleet dynamics).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

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
        "s_min": torch.as_tensor(info.get("s_min", 0), dtype=torch.int32,
                                 device=dev),
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
    device = resolve_device(device)
    ch = (None if count_hists is None else
          torch.as_tensor(np.asarray(count_hists, np.float32), device=device))
    gh = (None if global_hist is None else
          torch.as_tensor(np.asarray(global_hist, np.float32), device=device))

    def round_step(state: SEL.SelectionState, key):
        return _round_body(state, key, cfg, ch, gh, winners_impl)

    return round_step
