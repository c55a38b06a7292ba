"""Per-round client selection (Algorithm 1, lines 10-25) for the paper's
scheme, ``gradient_cluster_auction``: a per-cluster reverse auction with
Nash-equilibrium bids and the s_min sample threshold.  The paper's
baseline schemes are not ported yet (ROADMAP.md, queue 1)."""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

import torch

from repro_torch import rng
from repro_torch.configs.base import FLConfig
from repro_torch.core import auction as A
from repro_torch.core import energy as E


@dataclass
class SelectionState:
    """Struct-of-arrays client state used by the selector."""

    clusters: torch.Tensor       # (N,) int32 cluster id
    residual: torch.Tensor       # (N,) float32 energy percent
    history: torch.Tensor        # (N,) int32 participation rounds so far
    local_sizes: torch.Tensor    # (N,) int32 |xi_k|
    # fleet dynamics, reputation and scheme state: None on the ported path
    staleness: Optional[torch.Tensor] = None
    strikes: Optional[torch.Tensor] = None
    scheme_state: Optional[object] = None


def k_per_cluster(cfg: FLConfig) -> int:
    k_total = max(int(round(cfg.select_ratio * cfg.num_clients)), 1)
    return max(k_total // cfg.num_clusters, 1)


def _check_scheme(cfg: FLConfig) -> None:
    if cfg.scheme != "gradient_cluster_auction":
        raise NotImplementedError(
            f"scheme {cfg.scheme!r} is not ported yet (ROADMAP.md, queue 1: "
            "the paper's baseline schemes); only "
            "'gradient_cluster_auction' runs")


def _sample_threshold(key, state: SelectionState, cfg: FLConfig,
                      bids: torch.Tensor) -> torch.Tensor:
    """s_min: the server picks a random cluster js; among its K_j lowest
    bidders take the minimum local size (0 if js is empty).  Gates auction
    entry so selected data sizes stay at one level."""
    kj = k_per_cluster(cfg)
    js = rng.randint(key, (), 0, cfg.num_clusters, state.clusters.device)
    in_js = state.clusters == js
    win_js = A.select_lowest_bids(
        torch.where(in_js, bids, torch.full_like(bids, A.INF)), in_js, kj)
    sizes = torch.where(win_js, state.local_sizes,
                        torch.full_like(state.local_sizes, 2 ** 30))
    return torch.where(win_js.any(), sizes.min(),
                       torch.zeros_like(sizes[0]))


def select_round(state: SelectionState, cfg: FLConfig, key,
                 winners_impl: str = "segmented",
                 avail: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Run one round of selection. Returns (winner mask (N,) bool, info).
    ``avail`` is an eligibility mask (None = everyone may bid)."""
    _check_scheme(cfg)
    keys = rng.split(key, 4)
    kj = k_per_cluster(cfg)
    c, bids = A.price_round(state.clusters, state.residual,
                            state.local_sizes, state.history, kj, cfg)
    # step 1: probe cluster js fixes the sample threshold
    smin = _sample_threshold(keys[0], state, cfg, bids)
    eligible = (state.local_sizes >= smin) & (c < A.INF)
    if avail is not None:
        eligible = eligible & avail
    # step 2: per-cluster reverse auction among eligible clients
    cs = A.service_cost(state.local_sizes, state.history, cfg)
    win = A.cluster_winners(A.effective_bids(bids, state.strikes, cfg),
                            state.clusters, eligible, kj,
                            cfg.num_clusters, tie_break=cs,
                            impl=winners_impl)
    return win, {"bids": bids, "costs": c, "s_min": smin,
                 "revenue": A.revenue(bids, c, win)}


def update_after_round(state: SelectionState, win: torch.Tensor,
                       cfg: FLConfig) -> SelectionState:
    new = replace(
        state,
        residual=E.apply_round(state.residual, win, state.local_sizes, cfg),
        history=state.history + win.to(state.history.dtype),
    )
    if state.strikes is not None:
        new = replace(new, strikes=state.strikes * cfg.strike_decay)
    return new
