"""Federated server: the full Algorithm 1 loop (the synchronous,
undefended, dynamics-free path) for every ``cfg.scheme`` and every
``cfg.scheme_select`` of the registry.

Stage 1  (once)    : clustering of all clients by their initial gradients
                      (``weights_cluster_random``: by one-epoch weight
                      deltas; ``random``: none).
Stage 2  (per round): cost -> Nash bids -> s_min threshold -> per-cluster
                      winners, rewards, energy/history update and round
                      metrics in one round step (repro_torch.core.rounds).
Stage 3  (per round): winners run I local epochs, the server aggregates
                      w_{t+1} = sum_k p_k w^k_{t+1} (FedAvg or FedProx).

The round loop fetches only the winner mask every round (stage 3's
host-seeded shuffles need it); the round metrics and the eval pair stay
on the device in a pending buffer and are fetched in one batched copy at
logging boundaries, with the scheme's own round scalars (FedCS's
predicted latency, the long-term auction's budget ledger), which each
RoundLog keeps in ``scheme_metrics``.  Fleet dynamics, the defended
aggregation path, the divergence watchdog and checkpoints are not ported
yet (ROADMAP.md, queue 1): a config that would need them raises
``NotImplementedError`` instead of silently running the plain path.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import obs, rng
from repro_torch.configs.base import FLConfig
from repro_torch.core import clustering as CL
from repro_torch.core import energy as EN
from repro_torch.core import rounds as RND
from repro_torch.core import schemes as SCH
from repro_torch.core import selection as SEL
from repro_torch.core.adapters import ModelAdapter
from repro_torch.core.virtual_dataset import client_count_histograms
from repro_torch.data.partition import global_histogram
from repro_torch.device import resolve_device
from repro_torch.optim import apply_updates, sgd
from repro_torch.sim.runtime import make_runtime

# round scalars the scheme zoo adds (fairness_hist_std from every scheme,
# the budget ledger from longterm_auction, the latency ones from fedcs),
# fetched with the round's other metrics
SCHEME_METRIC_KEYS = ("fairness_hist_std", "budget_spent",
                      "budget_remaining", "budget_queue",
                      "pred_latency_mean", "num_feasible")


@dataclass
class RoundLog:
    round: int
    selected: np.ndarray
    test_acc: float            # NaN on rounds skipped by cfg.eval_every
    test_loss: float
    energy_std: float
    mean_bid: float
    server_reward: float
    client_reward_sum: float
    vds_gap: float
    eval_skipped: bool = False
    # the SCHEME_METRIC_KEYS the round's scheme emits
    scheme_metrics: Dict[str, float] = field(default_factory=dict)


@dataclass
class _PendingRound:
    """A dispatched round whose device scalars are not fetched yet."""

    round: int
    selected: np.ndarray
    metrics: Dict[str, torch.Tensor]
    eval_pair: Optional[tuple]


def check_supported(cfg: FLConfig) -> None:
    """Refuse every config the JAX server would route to code the port
    does not have yet (ROADMAP.md, queue 1)."""
    unported = []
    if cfg.dynamics_enabled:
        unported.append("fleet dynamics (churn/deadline)")
    if cfg.defended:
        unported.append("the defended aggregation path (defense/attack)")
    if cfg.watchdog_enabled:
        unported.append("the divergence watchdog")
    if unported:
        raise NotImplementedError(
            "not ported yet (ROADMAP.md, queue 1): " + ", ".join(unported))


class FederatedServer:
    def __init__(self, cfg: FLConfig, adapter: ModelAdapter,
                 x: np.ndarray, y: np.ndarray, clients,
                 test_batch: Dict[str, np.ndarray],
                 assign_fn=None, seed: Optional[int] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        check_supported(cfg)
        self.cfg = cfg
        self.adapter = adapter
        self.clients = clients
        self.assign_fn = assign_fn
        self.key = rng.PRNGKey(cfg.seed if seed is None else seed)
        self.params = adapter.init(self._next_key())
        self.logs: List[RoundLog] = []
        self.runtime = make_runtime(cfg, adapter, x, y, clients, self.device)
        n = cfg.num_clients
        self.state = SEL.SelectionState(
            clusters=torch.zeros(n, dtype=torch.int32, device=self.device),
            residual=EN.init_energy(cfg, self._next_key(), self.device),
            history=torch.zeros(n, dtype=torch.int32, device=self.device),
            local_sizes=torch.tensor([c.size for c in clients],
                                     dtype=torch.int32, device=self.device),
            scheme_state=SCH.init_scheme_state(cfg, self.device),
        )
        self.global_hist = global_histogram(y, cfg.num_classes)
        self.client_labels = [y[c.train_idx] for c in clients]
        self.total_client_reward = 0.0
        self._round_step = RND.make_round_step(
            cfg, client_count_histograms(self.client_labels,
                                         cfg.num_classes),
            self.global_hist, device=self.device)
        # host mirror of participation counts (seeds stage-3 shuffles)
        self._host_history = np.zeros((n,), np.int64)
        self._test = {k: torch.tensor(np.asarray(v), device=self.device)
                      for k, v in test_batch.items()}
        self._pending: List[_PendingRound] = []
        self._last_eval = (float("nan"), float("nan"))

    # ------------------------------------------------------------------
    def _next_key(self):
        self.key, k = rng.split(self.key)
        return k

    def cluster(self) -> None:
        """Stage 1: cluster clients by the scheme's feature (none for
        ``random``, which returns before drawing a key, so the round keys
        stay the JAX package's).

        K-means runs through the fused Lloyd step unless ``assign_fn``
        (for example ``ops.kmeans_assign``'s labels) overrides the
        assignment."""
        cfg = self.cfg
        if cfg.scheme == "random":
            return
        feature_kind = ("weights" if cfg.scheme == "weights_cluster_random"
                        else "gradient")
        key = self._next_key()
        # the batched runtimes compute the features in one pass; None
        # means the per-client loop of cluster_clients
        feats = self.runtime.cluster_features(self.params, key, feature_kind)
        data = ([self.runtime.local_data(i) for i in range(len(self.clients))]
                if feats is None else None)
        labels, _, _ = CL.cluster_clients(
            self.adapter.grad, self.params, data, cfg, key,
            feature_kind=feature_kind, local_steps_fn=self._weight_delta,
            assign_fn=self.assign_fn, precomputed_feats=feats)
        self.state.clusters = labels.to(torch.int32)

    def _weight_delta(self, params, x, y, key) -> torch.Tensor:
        """The Wang et al. feature: the flat model delta after one
        in-order epoch of plain SGD at batch min(32, n), the tail batch
        dropped, leaves in the JAX package's order."""
        init, upd = sgd(self.cfg.lr)
        opt, p = init(params), params
        bs = min(32, x.shape[0])
        for i in range(0, x.shape[0] - bs + 1, bs):
            g = self.adapter.grad(p, {"x": x[i:i + bs], "y": y[i:i + bs]})
            u, opt = upd(g, opt, p)
            p = apply_updates(p, u)
        return CL.flatten_tree({k: p[k] - params[k] for k in p})

    def local_train(self, client_idx: int, global_params):
        return self.runtime.train_client(
            global_params, client_idx, int(self._host_history[client_idx]))

    # ------------------------------------------------------------------
    def _eval_due(self, t: int, final: bool = False) -> bool:
        return final or self.cfg.eval_every <= 1 \
            or t % self.cfg.eval_every == 0

    @torch.no_grad()
    def _eval_step(self, params):
        return (self.adapter.accuracy(params, self._test),
                self.adapter.loss(params, self._test))

    def _dispatch_round(self, t: int, eval_now: bool) -> None:
        """Dispatch one FL round; only the winner mask is fetched."""
        with obs.span("round/select"):
            new_state, win, metrics = self._round_step(self.state,
                                                       self._next_key())
            sel_idx = np.nonzero(win.cpu().numpy())[0]
        with obs.span("round/train"):
            new_params = self.runtime.train_cohort(
                self.params, sel_idx, self._host_history)
        if new_params is not None:
            self.params = new_params
        # else: a zero-winner round leaves the params unchanged
        self.state = new_state
        self._host_history[sel_idx] += 1
        ev = self._eval_step(self.params) if eval_now else None
        self._pending.append(_PendingRound(round=t, selected=sel_idx,
                                           metrics=metrics, eval_pair=ev))

    def _flush_pending(self) -> None:
        """Fetch every pending round's scalars in one copy and turn each
        entry into a RoundLog."""
        if not self._pending:
            return
        flat = []
        for p in self._pending:
            flat.extend(p.metrics.values())
            if p.eval_pair is not None:
                flat.extend(p.eval_pair)
        host = torch.stack([v.float().reshape(()) for v in flat]).cpu()
        vals = iter(host.tolist())
        for p in self._pending:
            m = {k: next(vals) for k in p.metrics}
            skipped = p.eval_pair is None
            acc, loss = ((next(vals), next(vals)) if not skipped
                         else (float("nan"), float("nan")))
            if not skipped:
                self._last_eval = (acc, loss)
            self.total_client_reward += m["client_reward_sum"]
            self.logs.append(RoundLog(
                round=p.round, selected=p.selected, test_acc=acc,
                test_loss=loss, energy_std=m["energy_std"],
                mean_bid=m["mean_bid"], server_reward=m["server_reward"],
                client_reward_sum=m["client_reward_sum"],
                vds_gap=m["vds_gap"], eval_skipped=skipped,
                scheme_metrics={k: m[k] for k in SCHEME_METRIC_KEYS
                                if k in m}))
        self._pending.clear()

    def run_round(self, t: int) -> RoundLog:
        """One synchronous FL round (dispatch + immediate flush)."""
        self._dispatch_round(t, self._eval_due(t))
        self._flush_pending()
        return self.logs[-1]

    def run(self, rounds: Optional[int] = None,
            verbose: bool = False) -> List[RoundLog]:
        """Stage 1, then ``rounds`` rounds (default ``cfg.rounds``).
        ``verbose`` prints a progress line every 5 rounds with the last
        drained eval; it never changes the eval cadence."""
        with obs.span("run/cluster"):
            self.cluster()
        warmup = getattr(self.runtime, "warmup", None)
        if warmup is not None:    # device runtime: meet every class shape
            with obs.span("run/warmup"):
                warmup(self.params)
        T = rounds if rounds is not None else self.cfg.rounds
        for t in range(T):
            final = t == T - 1
            self._dispatch_round(t, self._eval_due(t, final=final))
            if verbose and (t % 5 == 0 or final):
                self._flush_pending()
                log = self.logs[-1]
                acc, loss = self._last_eval
                obs.log(f"  round {t:3d} acc={acc:.3f} loss={loss:.3f} "
                        f"E_std={log.energy_std:.3f} "
                        f"bid={log.mean_bid:.3f} "
                        f"vds_gap={log.vds_gap:.3f}")
        self._flush_pending()
        return self.logs
