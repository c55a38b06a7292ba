"""Federated server: the full Algorithm 1 loop (the synchronous,
undefended, dynamics-free path).

Stage 1  (once)    : gradient clustering of all clients.
Stage 2  (per round): cost -> Nash bids -> s_min threshold -> per-cluster
                      winners, rewards, energy/history update and round
                      metrics in one round step (repro_torch.core.rounds).
Stage 3  (per round): winners run I local epochs, the server aggregates
                      w_{t+1} = sum_k p_k w^k_{t+1} (FedAvg or FedProx).

The round loop fetches only the winner mask every round (stage 3's
host-seeded shuffles need it); the round metrics and the eval pair stay
on the device in a pending buffer and are fetched in one batched copy at
logging boundaries.  Fleet dynamics, the defended aggregation path, the
divergence watchdog and checkpoints are not ported yet (ROADMAP.md,
queue 1): a config that would need them raises ``NotImplementedError``
instead of silently running the plain path.
"""
from __future__ import annotations

from dataclasses import dataclass
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
from repro_torch.sim.runtime import make_runtime


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
    SEL._check_scheme(cfg)


class FederatedServer:
    def __init__(self, cfg: FLConfig, adapter: ModelAdapter,
                 x: np.ndarray, y: np.ndarray, clients,
                 test_batch: Dict[str, np.ndarray],
                 seed: Optional[int] = None, device="cuda"):
        self.device = resolve_device(device)
        check_supported(cfg)
        self.cfg = cfg
        self.adapter = adapter
        self.clients = clients
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
            scheme_state=SCH.init_scheme_state(cfg),
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
        """Stage 1: cluster clients by their mean initial gradients."""
        data = [self.runtime.local_data(i) for i in range(len(self.clients))]
        key = self._next_key()
        feats = self.runtime.cluster_features(self.params, key, "gradient")
        labels, _, _ = CL.cluster_clients(
            self.adapter.grad, self.params, data, self.cfg, key,
            precomputed_feats=feats)
        self.state.clusters = labels.to(torch.int32)

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
                vds_gap=m["vds_gap"], eval_skipped=skipped))
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
