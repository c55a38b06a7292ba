"""Per-round client selection (Algorithm 1, lines 10-25) for the four
schemes the paper compares (``cfg.scheme``):

  * ``gradient_cluster_auction`` — the paper's scheme: a per-cluster
    reverse auction with Nash-equilibrium bids and the s_min sample
    threshold.
  * ``gradient_cluster_random`` — the paper's clustering with uniform
    in-cluster picks (plus the §III-C sample threshold).
  * ``weights_cluster_random`` — the Wang et al. baseline: clusters from
    local weight-delta features, uniform in-cluster picks.
  * ``random`` — FedAvg/FedProx random-K selection.

Every branch reads the same slot of the round key's 4-way split as the
JAX package, so a seeded run draws the same winners."""
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


def _sample_threshold(key, state: SelectionState, cfg: FLConfig,
                      bids: Optional[torch.Tensor]) -> torch.Tensor:
    """s_min: the server picks a random cluster js; among its K_j lowest
    bidders (auction) or one random member (random schemes, ``bids``
    None) take the minimum local size (0 if js is empty).  Gates auction
    entry so selected data sizes stay at one level."""
    kj = k_per_cluster(cfg)
    js = rng.randint(key, (), 0, cfg.num_clusters, state.clusters.device)
    in_js = state.clusters == js
    zero = torch.zeros((), dtype=state.local_sizes.dtype,
                       device=state.local_sizes.device)
    if bids is not None:
        win_js = A.select_lowest_bids(
            torch.where(in_js, bids, torch.full_like(bids, A.INF)), in_js,
            kj)
        sizes = torch.where(win_js, state.local_sizes,
                            torch.full_like(state.local_sizes, 2 ** 30))
        return torch.where(win_js.any(), sizes.min(), zero)
    # random schemes: one random member's size (paper §III-C)
    probs = in_js.float() / torch.clamp(in_js.sum(), min=1)
    pick = rng.choice(rng.fold_in(key, 1), state.clusters.shape[0],
                      p=probs)
    return torch.where(in_js.any(),
                       state.local_sizes.index_select(0, pick.reshape(1))[0],
                       zero)


def _random_per_cluster(key, state: SelectionState, cfg: FLConfig,
                        eligible: torch.Tensor) -> torch.Tensor:
    """K_j uniform picks per cluster among eligible clients: one
    segmented rank pass (lexsort by (cluster, noise), then per-segment
    ranks).  Tied noise falls back to the client index, as ``jnp.lexsort``
    breaks ties; :func:`_random_per_cluster_loop` is the oracle."""
    kj = k_per_cluster(cfg)
    n = state.clusters.shape[0]
    cl = state.clusters.long()
    noise = rng.uniform(key, (n,), device=cl.device)
    # clusters with no eligible member relax to their whole membership
    has_elig = torch.zeros(cfg.num_clusters, dtype=torch.int32,
                           device=cl.device).scatter_reduce_(
        0, cl, eligible.to(torch.int32), reduce="amax")
    e = torch.where(has_elig[cl] > 0, eligible, True)
    keyed = torch.where(e, noise, 2.0)    # ineligible sort after all noise
    order = A.lexsort((keyed, cl))        # cluster-major, noise-minor
    rank_in_cluster = A.segment_ranks(order, cl, cfg.num_clusters)
    win_sorted = (rank_in_cluster < kj) & e[order]
    win = torch.zeros(n, dtype=torch.bool, device=cl.device)
    win[order] = win_sorted
    return win


def _random_per_cluster_loop(key, state: SelectionState, cfg: FLConfig,
                             eligible: torch.Tensor) -> torch.Tensor:
    """Reference oracle for :func:`_random_per_cluster`: a loop over
    clusters, one stable argsort each."""
    kj = k_per_cluster(cfg)
    n = state.clusters.shape[0]
    noise = rng.uniform(key, (n,), device=state.clusters.device)
    win = torch.zeros(n, dtype=torch.bool, device=noise.device)
    for j in range(cfg.num_clusters):
        members = state.clusters == j
        in_j = members & eligible
        in_j = torch.where(in_j.any(), in_j, members)
        keyed = torch.where(in_j, noise, 2.0)
        order = torch.sort(keyed, stable=True).indices
        ranks = torch.empty_like(order)
        ranks[order] = torch.arange(n, device=noise.device)
        win = win | ((ranks < kj) & in_j)
    return win


def select_round(state: SelectionState, cfg: FLConfig, key,
                 winners_impl: str = "segmented",
                 avail: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Run one round of selection under ``cfg.scheme``.  Returns (winner
    mask (N,) bool, info).  ``avail`` is an eligibility mask (None =
    everyone may bid) for the clustered schemes; the pure ``random``
    baseline draws blind, as in the JAX package."""
    n = cfg.num_clients
    dev = state.clusters.device
    keys = rng.split(key, 4)

    if cfg.scheme == "random":
        k_total = max(int(round(cfg.select_ratio * n)), 1)
        idx = rng.choice(keys[0], n, (k_total,), replace=False, device=dev)
        win = torch.zeros(n, dtype=torch.bool, device=dev)
        win.index_fill_(0, idx, True)   # a scalar fill: no host copy
        return win, {"bids": torch.zeros(n, device=dev)}

    if cfg.scheme in ("gradient_cluster_random", "weights_cluster_random"):
        smin = _sample_threshold(keys[0], state, cfg, None)
        eligible = state.local_sizes >= smin
        if avail is not None:
            eligible = eligible & avail
        win = _random_per_cluster(keys[1], state, cfg, eligible)
        return win, {"bids": torch.zeros(n, device=dev), "s_min": smin}

    # gradient_cluster_auction, the paper's scheme
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
