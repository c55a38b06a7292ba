"""Auction mechanism (paper §IV): cost function, Nash-equilibrium bids,
winner selection and reward models, vectorized over clients.

The server is the *auctioneer*; edge clients are *bidders* selling data
and compute.  Within each cluster the K_j lowest bids win (reverse
auction).  Winner ranking reproduces the reference's sort order exactly:
``jnp.lexsort`` becomes chained stable sorts from the least significant
key, and ``lax.top_k``'s lower-index-first tie rule becomes a stable
ascending argsort (``torch.topk`` promises no order on ties).

Nothing here copies from the host to the device or reads a device value
back (constants enter as Python numbers, segment sizes come from
``index_add_`` rather than ``bincount``, masks are written with index
tensors rather than boolean indexing), so a round of the control plane
runs without a host synchronisation.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core import energy as E

INF = 1e9


def lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """``jnp.lexsort``: the LAST key is primary; ties fall through to the
    earlier keys, then to the index (every pass is a stable sort)."""
    order = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in keys:
        order = order[torch.sort(k[order], stable=True).indices]
    return order


# ----------------------------------------------------------------------
# cost function (eq 12-14)
# ----------------------------------------------------------------------

def resource_cost(residual: torch.Tensor, e_cp: torch.Tensor,
                  cfg: FLConfig) -> torch.Tensor:
    """Cr_{i,t} = phi^(E_res - E_cp) on the battery *fraction* if the
    client can afford the round, else +inf (eq 12; the fraction scale is
    recorded in DESIGN.md)."""
    margin = (residual - e_cp) / 100.0
    cr = torch.pow(float(np.float32(cfg.phi)), margin)
    return torch.where(margin > 0, cr, torch.full_like(cr, INF))


def service_cost(local_sizes: torch.Tensor, history: torch.Tensor,
                 cfg: FLConfig) -> torch.Tensor:
    """Cs_{i,t} = chi * vartheta^Ns + zeta * (log_a(co + a) - 1) (eq 13,
    with the intended sign; ``cfg.history_verbatim`` restores the printed
    one — see DESIGN.md §Paper-deviations)."""
    sample_term = torch.pow(float(np.float32(cfg.vartheta)),
                            local_sizes.float())
    # float32 log of the constant, taken on the host
    log_a = float(torch.log(torch.tensor(cfg.log_a, dtype=torch.float32)))
    hist = torch.log(history.float() + cfg.log_a) / log_a
    sign = -1.0 if cfg.history_verbatim else 1.0
    return cfg.chi * sample_term + cfg.zeta * sign * (hist - 1.0)


def cost(residual, local_sizes, history, cfg: FLConfig) -> torch.Tensor:
    """c_{i,t} = alpha*Cs + gamma*Cr (eq 14), clipped into the bid domain
    [0, 1]; +inf (can't afford) stays +inf."""
    e_cp = E.compute_cost_energy(local_sizes, cfg)
    cr = resource_cost(residual, e_cp, cfg)
    cs = service_cost(local_sizes, history, cfg)
    c = cfg.alpha * cs + cfg.gamma * cr
    return torch.where(cr >= INF, torch.full_like(c, INF),
                       torch.clamp(c, 0.0, 1.0))


# ----------------------------------------------------------------------
# optimal bid (Theorem 2)
# ----------------------------------------------------------------------

def optimal_bid(c: torch.Tensor, n_j, k_j) -> torch.Tensor:
    """b* = 1/(N_j-K_j+1) + (N_j-K_j)/(N_j-K_j+1) * c — the symmetric
    Nash-equilibrium bid of Theorem 2 (n_j/k_j scalars or per client)."""
    def f32(v):     # a scalar is filled on the device, not copied there
        if isinstance(v, torch.Tensor):
            return v.to(device=c.device, dtype=torch.float32)
        return torch.full((), float(v), dtype=torch.float32,
                          device=c.device)

    d = torch.clamp(f32(n_j) - f32(k_j), min=0.0)
    bid = 1.0 / (d + 1.0) + d / (d + 1.0) * c
    return torch.where(c >= INF, torch.full_like(bid, INF), bid)


def revenue(bid: torch.Tensor, c: torch.Tensor,
            won: torch.Tensor) -> torch.Tensor:
    """U_i = b - c if the client wins else 0 (eq 18)."""
    return torch.where(won, bid - c, torch.zeros_like(bid))


def price_round(clusters: torch.Tensor, residual: torch.Tensor,
                local_sizes: torch.Tensor, history: torch.Tensor,
                k_j: int, cfg: FLConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pricing half of one auction round: per-client cost (eq 14) and
    symmetric Nash bids (Theorem 2) under the current cluster sizes."""
    nj = torch.zeros(cfg.num_clusters, device=clusters.device).index_add_(
        0, clusters.long(), torch.ones_like(residual))
    n_of = nj[clusters.long()]
    c = cost(residual, local_sizes, history, cfg)
    return c, optimal_bid(c, n_of, float(k_j))


def effective_bids(bids: torch.Tensor, strikes: Optional[torch.Tensor],
                   cfg: FLConfig) -> torch.Tensor:
    """Reputation-priced bid ``b * (1 + gain * strikes)`` at the ranking
    step; with pricing off (ban mode, or no strikes) the bids themselves."""
    if strikes is None or cfg.reputation_mode != "price":
        return bids
    return torch.where(bids >= INF, torch.full_like(bids, INF),
                       bids * (1.0 + cfg.rep_price_gain * strikes))


# ----------------------------------------------------------------------
# winner selection
# ----------------------------------------------------------------------

def segment_ranks(order: torch.Tensor, clusters: torch.Tensor,
                  num_clusters: int) -> torch.Tensor:
    """Within-cluster rank of each position of a cluster-major sort."""
    cl = clusters.long()
    sizes = torch.zeros(num_clusters, dtype=torch.int64,
                        device=cl.device).index_add_(0, cl,
                                                     torch.ones_like(cl))
    starts = torch.cumsum(sizes, 0) - sizes
    return torch.arange(order.shape[0], device=order.device) \
        - starts[cl[order]]


def select_lowest_bids(bids: torch.Tensor, eligible: torch.Tensor, k: int,
                       tie_break: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Boolean winner mask: k lowest eligible bids, ties broken by
    ``tie_break`` (exactly-equal bids only), then by client index."""
    n = bids.shape[0]
    key = torch.where(eligible, bids, torch.full_like(bids, INF))
    if tie_break is None:
        # lax.top_k(-key) order: lowest key first, lower index on ties
        idx = torch.sort(key, stable=True).indices[:min(k, n)]
        win = torch.zeros(n, dtype=torch.bool, device=bids.device)
        return win.index_put_((idx,), key[idx] < INF)
    order = lexsort((torch.clamp(tie_break, 0.0, 1.0), key))
    ranks = torch.empty_like(order)
    ranks[order] = torch.arange(n, device=bids.device)
    return (ranks < k) & eligible & (key < INF)


def cluster_winners(bids: torch.Tensor, clusters: torch.Tensor,
                    eligible: torch.Tensor, k_per_cluster: int,
                    num_clusters: int,
                    tie_break: Optional[torch.Tensor] = None,
                    impl: str = "segmented") -> torch.Tensor:
    """Winner mask over all clients: K_j lowest eligible bids per cluster,
    ties broken by ``tie_break`` then client index.  ``segmented`` is one
    lexsort by (cluster, bid, tie-break) plus per-segment ranks; ``loop``
    is the per-cluster oracle (bit-identical winner sets)."""
    if impl == "loop":
        return cluster_winners_loop(bids, clusters, eligible, k_per_cluster,
                                    num_clusters, tie_break)
    if impl != "segmented":
        raise ValueError(impl)
    n = bids.shape[0]
    key = torch.where(eligible, bids, torch.full_like(bids, INF))
    tb = (torch.zeros_like(key) if tie_break is None
          else torch.clamp(tie_break, 0.0, 1.0))
    order = lexsort((tb, key, clusters))   # cluster-major, bid, tie
    rank_in_cluster = segment_ranks(order, clusters, num_clusters)
    win_sorted = ((rank_in_cluster < k_per_cluster) & eligible[order]
                  & (key[order] < INF))
    win = torch.zeros(n, dtype=torch.bool, device=bids.device)
    win[order] = win_sorted
    return win


def cluster_winners_loop(bids: torch.Tensor, clusters: torch.Tensor,
                         eligible: torch.Tensor, k_per_cluster: int,
                         num_clusters: int,
                         tie_break: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Reference oracle for :func:`cluster_winners`: one selection per
    cluster."""
    win = torch.zeros_like(eligible)
    for j in range(num_clusters):
        win = win | select_lowest_bids(bids, eligible & (clusters == j),
                                       k_per_cluster, tie_break)
    return win


# ----------------------------------------------------------------------
# reward models (eq 15-17)
# ----------------------------------------------------------------------

def reward_sample_share(won: torch.Tensor, local_sizes: torch.Tensor,
                        cfg: FLConfig) -> torch.Tensor:
    """eq 15: winners split Rg/Nr in proportion to their sample counts; a
    zero-winner round pays exactly zero."""
    per_round = cfg.total_reward / cfg.target_rounds
    w = won.float() * local_sizes.float()
    denom = torch.clamp(w.sum(), min=1e-9)
    return torch.where(won.any(), per_round * w / denom,
                       torch.zeros_like(w))


def reward_bid_share(won: torch.Tensor, bids: torch.Tensor,
                     cfg: FLConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """eq 16: each winner receives bid * Rg/Nr; the server keeps the rest.
    Returns (client_rewards, server_reward); a zero-winner round pays both
    sides exactly zero."""
    per_round = cfg.total_reward / cfg.target_rounds
    r = torch.where(won, torch.clamp(bids, 0.0, 1.0) * per_round,
                    torch.zeros_like(bids))
    nwin = torch.clamp(won.sum(), min=1)
    server = torch.where(won.any(), per_round - r.sum() / nwin,
                         torch.zeros((), device=bids.device))
    return r, server
