"""Selection-scheme registry for the round control plane.

A :class:`SelectionScheme` is three hooks: ``init_state(cfg, device)``
(the carried scheme state, None for stateless schemes), ``select(state,
cfg, key, winners_impl, avail) -> (win, info)`` and ``update_state(state,
new_state, cfg, win, info, client_rewards) -> (new_scheme_state,
metrics)``.  ``avail`` is a hard eligibility mask; ``info`` carries
``bids`` (the reward models read it); the metrics are device scalars that
ride the round's one batched fetch.  The zoo:

  * ``paper`` — ``selection.select_round`` verbatim (itself dispatching
    on ``cfg.scheme``, the paper's own baselines);
  * ``random`` — uniform K_j picks per cluster among available clients;
  * ``fedcs`` — FedCS deadline-constrained selection (Nishio & Yonetani,
    arXiv:1804.08333): the paper's pricing, with bid-time eligibility
    gated on the latency model's predicted round latency
    (``sim/dynamics.round_latency``);
  * ``longterm_auction`` — a long-term budget-feasible auction
    (arXiv:2508.09181): a Lyapunov virtual queue of overspend against
    the per-round budget Rg/Nr caps the admissible bid, and the ledger
    (spent, queue, per-client payments) rides ``scheme_state``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import rng
from repro_torch.configs.base import FLConfig
from repro_torch.core import auction as A
from repro_torch.core import selection as SEL
from repro_torch.device import resolve_device
from repro_torch.sim import dynamics as DYN

Metrics = Dict[str, torch.Tensor]
SelectFn = Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


@dataclass(frozen=True)
class SelectionScheme:
    name: str
    select: SelectFn
    init_state: Callable[..., Optional[Any]]
    update_state: Callable[..., Tuple[Optional[Any], Metrics]]
    # True when init_state returns a state: such a scheme logs its budget
    # scalars every round
    stateful: bool = False


_REGISTRY: Dict[str, SelectionScheme] = {}


def register(scheme: SelectionScheme) -> SelectionScheme:
    if scheme.name in _REGISTRY:
        raise ValueError(f"scheme {scheme.name!r} already registered")
    _REGISTRY[scheme.name] = scheme
    return scheme


def get_scheme(name: str) -> SelectionScheme:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown selection scheme {name!r}; registered "
                       f"schemes: {scheme_names()}") from None


def scheme_names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def stateful_scheme_names() -> Tuple[str, ...]:
    """Schemes that thread a scheme_state."""
    return tuple(sorted(n for n, s in _REGISTRY.items() if s.stateful))


def init_scheme_state(cfg: FLConfig, device="cuda") -> Optional[Any]:
    """The scheme_state for a fresh fleet under ``cfg.scheme_select``."""
    return get_scheme(cfg.scheme_select).init_state(cfg, device)


def _no_state(cfg: FLConfig, device="cuda") -> None:
    return None


def _keep_state(state, new_state, cfg, win, info, client_rewards
                ) -> Tuple[Optional[Any], Metrics]:
    return state.scheme_state, {}


def _auction(state: SEL.SelectionState, cfg: FLConfig, key, winners_impl,
             avail, gate=None):
    """The paper's pricing, s_min probe and per-cluster reverse auction
    with an extra eligibility ``gate(c, bids)`` (a mask, or None)."""
    kj = SEL.k_per_cluster(cfg)
    keys = rng.split(key, 4)
    c, bids = A.price_round(state.clusters, state.residual,
                            state.local_sizes, state.history, kj, cfg)
    smin = SEL._sample_threshold(keys[0], state, cfg, bids)
    eligible = (state.local_sizes >= smin) & (c < A.INF)
    if gate is not None:
        eligible = eligible & gate(c, bids)
    if avail is not None:
        eligible = eligible & avail
    cs = A.service_cost(state.local_sizes, state.history, cfg)
    win = A.cluster_winners(A.effective_bids(bids, state.strikes, cfg),
                            state.clusters, eligible, kj,
                            cfg.num_clusters, tie_break=cs,
                            impl=winners_impl)
    return win, {"bids": bids, "costs": c, "s_min": smin,
                 "revenue": A.revenue(bids, c, win)}


# ----------------------------------------------------------------------
# paper — selection.select_round verbatim
# ----------------------------------------------------------------------

register(SelectionScheme(
    name="paper",
    select=SEL.select_round,
    init_state=_no_state,
    update_state=_keep_state,
))


# ----------------------------------------------------------------------
# random — uniform per-cluster picks among available clients
# ----------------------------------------------------------------------

def random_select(state: SEL.SelectionState, cfg: FLConfig, key,
                  winners_impl: str = "segmented",
                  avail: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Uniform K_j picks per cluster among eligible clients only, from
    ``keys[1]`` of the round key's 4-way split (as ``select_round``'s
    clustered random branch).  ``avail`` is a hard mask: the sampler's
    relaxation of a cluster with no eligible member never re-admits a
    gated client, the conjunction after the pick keeps it out."""
    n = cfg.num_clients
    dev = state.clusters.device
    keys = rng.split(key, 4)
    eligible = (torch.ones(n, dtype=torch.bool, device=dev)
                if avail is None else avail)
    win = SEL._random_per_cluster(keys[1], state, cfg, eligible) & eligible
    return win, {"bids": torch.zeros(n, device=dev)}


register(SelectionScheme(
    name="random",
    select=random_select,
    init_state=_no_state,
    update_state=_keep_state,
))


# ----------------------------------------------------------------------
# fedcs — deadline feasibility on the predicted latency at bid time
# ----------------------------------------------------------------------

# fold_in tag of the bid-time latency prediction (its own stream, apart
# from every other consumer of the round key)
_FEDCS_PRED_TAG = 0xFEDC5


def fedcs_deadline(cfg: FLConfig) -> float:
    """The fault model's ``cfg.deadline`` when it enforces one, else the
    scheme's own bound ``cfg.fedcs_deadline``."""
    return cfg.deadline if cfg.deadline > 0.0 else cfg.fedcs_deadline


def fedcs_predicted_latency(state: SEL.SelectionState, cfg: FLConfig,
                            key) -> torch.Tensor:
    """Bid-time latency prediction: ``dynamics.round_latency`` on the
    round-start state under ``fold_in(key, _FEDCS_PRED_TAG)``."""
    return DYN.round_latency(cfg, rng.fold_in(key, _FEDCS_PRED_TAG),
                             state.residual, state.local_sizes)


def fedcs_select(state: SEL.SelectionState, cfg: FLConfig, key,
                 winners_impl: str = "segmented",
                 avail: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The paper's auction with bid-time eligibility gated on predicted
    latency <= the deadline.  A cluster with no feasible member selects
    no one (never relaxed: an infeasible winner would only be late)."""
    pred_lat = fedcs_predicted_latency(state, cfg, key)
    win, info = _auction(state, cfg, key, winners_impl, avail,
                         gate=lambda c, b: pred_lat <= fedcs_deadline(cfg))
    info["pred_latency"] = pred_lat
    return win, info


def _fedcs_update(state, new_state, cfg, win, info, client_rewards
                  ) -> Tuple[Optional[Any], Metrics]:
    nwin = torch.clamp(win.sum(), min=1)
    pred = info["pred_latency"]
    return None, {
        "pred_latency_mean": torch.where(win, pred, 0.0).sum() / nwin,
        "num_feasible": (pred <= fedcs_deadline(cfg)).sum(),
    }


register(SelectionScheme(
    name="fedcs",
    select=fedcs_select,
    init_state=_no_state,
    update_state=_fedcs_update,
))


# ----------------------------------------------------------------------
# longterm_auction — budget and payment ledger carried across rounds
# ----------------------------------------------------------------------

@dataclass
class LongTermState:
    """The long-term auction's carried ledger."""

    spent: torch.Tensor    # () float32 cumulative payout of the run
    queue: torch.Tensor    # () float32 Lyapunov backlog vs Rg/Nr
    paid: torch.Tensor     # (N,) float32 cumulative payment per client


def _longterm_init(cfg: FLConfig, device="cuda") -> LongTermState:
    device = resolve_device(device)
    return LongTermState(
        spent=torch.zeros((), device=device),
        queue=torch.zeros((), device=device),
        paid=torch.zeros(cfg.num_clients, device=device))


def _ledger(state: SEL.SelectionState) -> LongTermState:
    if state.scheme_state is None:
        raise ValueError(
            "scheme_select='longterm_auction' needs scheme_state — build "
            "states via rounds.synthetic_fleet / FederatedServer, or set "
            "state.scheme_state = schemes.init_scheme_state(cfg)")
    return state.scheme_state


def longterm_bid_cap(cfg: FLConfig, queue):
    """Backlog-adaptive admissible-bid cap: 1 at zero backlog, shrinking
    as the virtual queue grows."""
    per_round = cfg.total_reward / cfg.target_rounds
    return 1.0 / (1.0 + queue / per_round)


def longterm_select(state: SEL.SelectionState, cfg: FLConfig, key,
                    winners_impl: str = "segmented",
                    avail: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The paper's auction gated by the carried ledger: a run whose
    payout has exhausted the total budget Rg selects no one, and the
    backlog caps the admissible bid."""
    ss = _ledger(state)
    remaining = cfg.total_reward - ss.spent
    cap = longterm_bid_cap(cfg, ss.queue)
    return _auction(state, cfg, key, winners_impl, avail,
                    gate=lambda c, bids: (bids <= cap) & (remaining > 0.0))


def _longterm_update(state, new_state, cfg, win, info, client_rewards
                     ) -> Tuple[LongTermState, Metrics]:
    """Advance the ledger by the round's actual payout: ``spent`` grows,
    the queue is ``max(q + spend - Rg/Nr, 0)``."""
    ss = _ledger(state)
    per_round = cfg.total_reward / cfg.target_rounds
    spend = client_rewards.sum()
    new_ss = LongTermState(
        spent=ss.spent + spend,
        queue=torch.clamp(ss.queue + spend - per_round, min=0.0),
        paid=ss.paid + client_rewards)
    return new_ss, {
        "budget_spent": spend,
        "budget_remaining": cfg.total_reward - new_ss.spent,
        "budget_queue": new_ss.queue,
    }


register(SelectionScheme(
    name="longterm_auction",
    select=longterm_select,
    init_state=_longterm_init,
    update_state=_longterm_update,
    stateful=True,
))


# ----------------------------------------------------------------------
# host-side hooks (server dynamics plumbing)
# ----------------------------------------------------------------------

def host_replacement_mask(cfg: FLConfig, host_sizes: np.ndarray
                          ) -> Optional[np.ndarray]:
    """Scheme-aware filter for the server's retry-or-replace candidate
    pool (``FederatedServer._resample_dropped``): fedcs substitutes must
    themselves be plausibly deadline-feasible, or the replacement just
    turns a DROPPED slot into a LATE one.  On the host and deterministic
    (the latency model's size-driven compute term at the fastest
    straggler factor), so replacement draws stay a pure function of
    (seed, outcome stream).  None = no scheme constraint."""
    if cfg.scheme_select != "fedcs":
        return None
    sizes = host_sizes.astype(np.float64)
    compute = sizes / max(sizes.mean(), 1.0)
    # fastest profile factor: 1.0 base x the 0.9 jitter floor (energy),
    # 0.5 (uniform); 'lognormal'/'none' can reach ~0 slowdown -> 1.0x
    floor = {"energy": 0.9, "uniform": 0.5}.get(cfg.straggler_profile, 0.0)
    return compute * floor + 0.05 <= fedcs_deadline(cfg)
