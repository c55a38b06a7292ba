"""Federated server: the full Algorithm 1 loop for every ``cfg.scheme``
and every ``cfg.scheme_select`` of the registry, with fleet dynamics,
checkpoints and the event stream.

Stage 1  (once)    : clustering of all clients by their initial gradients
                      (``weights_cluster_random``: by one-epoch weight
                      deltas; ``random``: none).
Stage 2  (per round): cost -> Nash bids -> s_min threshold -> per-cluster
                      winners, rewards, energy/history update and round
                      metrics in one round step (repro_torch.core.rounds).
Stage 3  (per round): winners run I local epochs, the server aggregates
                      w_{t+1} = sum_k p_k w^k_{t+1} (FedAvg or FedProx).

The round loop fetches only the winner mask every round (stage 3's
host-seeded shuffles need it), through the counted ``obs.device_get``;
the round metrics and the eval pair stay on the device in a pending
buffer and are fetched in one batched copy at logging boundaries, where
each round becomes a RoundLog and a ``round`` row of the event stream
(``repro_torch.obs``).

With fleet dynamics on (``cfg.dynamics_enabled``: any churn or a positive
deadline) the round step also runs the fault model
(``sim/dynamics.py``) and aggregation degrades gracefully: only
COMPLETED winners, plus retry-or-replace substitutes for DROPPED ones,
aggregate synchronously (FedAvg re-weights over whatever cohort it is
handed); a zero-survivor round leaves the params untouched and logs a
``round/empty`` dynamics event.  Under ``--aggregation buffered`` LATE
winners still train, their aggregate lands in a buffer as a delta, and
it folds into the global model FedBuff-style at goal-count or timeout
boundaries.  With dynamics off both aggregation modes take the plain
path, so churn-0 runs stay bit-identical.

With ``cfg.defended`` (any ``--defense``, or an active ``--attack``)
stage 3 is the Byzantine-tolerant path: the runtime returns the cohort's
per-client flat deltas, and one screened step (``core/aggregation.py``)
corrupts the adversaries' rows (``sim/dynamics.corrupt_updates``),
quarantines, screens, aggregates and scatters strikes into
``SelectionState.strikes``, which the round step turns into bans or
priced bids.  With ``--watchdog on`` a divergence watchdog keeps a ring
of the last healthy snapshots (the checkpoint tree, held by reference),
judges every drained eval, and on a divergence restores the newest
healthy entry, tightens the defense, decays the server step and perturbs
the key chain.  The ring holds tensors by reference, as the JAX package
holds its immutable arrays: nothing on the round path writes into a
tensor the server already holds (every in-place op is on a fresh one),
so a snapshot stays as it was taken.

``run(checkpoint_every=, checkpoint_path=, resume=)`` snapshots and
restores the server in the JAX package's checkpoint format
(``checkpoint/io.py``), defense state, server step and rollback count
included.
"""
from __future__ import annotations

import json
import os
from collections import deque
from copy import deepcopy
from dataclasses import dataclass, field, replace as dc_replace
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs, rng
from repro_torch.configs.base import FLConfig
from repro_torch.core import aggregation as AGG
from repro_torch.core import clustering as CL
from repro_torch.core import energy as EN
from repro_torch.core import rounds as RND
from repro_torch.core import schemes as SCH
from repro_torch.core import selection as SEL
from repro_torch.core.adapters import ModelAdapter
from repro_torch.core.virtual_dataset import client_count_histograms
from repro_torch.data.partition import global_histogram
from repro_torch.device import resolve_device, synchronize
from repro_torch.optim import apply_updates, sgd
from repro_torch.sim import dynamics as DYN
from repro_torch.sim.runtime import make_runtime

# round scalars the scheme zoo adds (fairness_hist_std from every scheme,
# the budget ledger from longterm_auction, the latency ones from fedcs),
# fetched with the round's other metrics
SCHEME_METRIC_KEYS = ("fairness_hist_std", "budget_spent",
                      "budget_remaining", "budget_queue",
                      "pred_latency_mean", "num_feasible")

# round scalars the dynamics round step adds, mirrored into the round row
DYN_METRIC_KEYS = ("num_completed", "num_late", "num_dropped",
                   "staleness_mean", "staleness_max", "mean_latency",
                   "num_avail")

# round scalars the defended round step adds (SelectionState carries
# strikes): the ban count and the trust score the price mode bids against
DEF_METRIC_KEYS = ("num_banned", "trust_mean", "trust_min")


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
    """A dispatched round whose device scalars are not fetched yet;
    ``dyn`` holds the host-side dynamics scalars (replacements, buffer
    depth), None with dynamics off."""

    round: int
    selected: np.ndarray
    metrics: Dict[str, torch.Tensor]
    eval_pair: Optional[tuple]
    dyn: Optional[Dict[str, float]] = None
    # the screened step's reports of every defended sub-cohort the round
    # dispatched (late first, main last), fetched with the metrics
    defense: Optional[List[Dict[str, torch.Tensor]]] = None


@dataclass
class _BufferedUpdate:
    """One late update in the FedBuff buffer: ``delta`` is the late
    sub-cohort's aggregated param delta against the globals it trained
    from, ``mass`` its data mass (sum of local sizes), ``round`` the
    dispatch round and ``arrival`` the first round the server can fold
    it (dispatch + 1: late means after the deadline).  ``mass_scale`` is
    the screened report's survivor fraction (a 0-d device tensor, None
    undefended): the fold scales the mass by it, so a fully quarantined
    late cohort folds with zero mass."""

    delta: Dict[str, torch.Tensor]
    mass: float
    round: int
    arrival: int
    mass_scale: Optional[torch.Tensor] = None


@dataclass
class _RingEntry:
    """One watchdog snapshot: ``tree`` is the :meth:`FederatedServer.
    _ckpt_tree` of the moment (tensors by reference), plus the host state
    a rollback restores as it was."""

    round: int
    tree: Dict[str, Any]
    reward: float
    last_eval: Tuple[float, float]
    dyn_rng_state: Optional[dict] = None
    host_avail: Optional[np.ndarray] = None


def _key_words(key: torch.Tensor) -> np.ndarray:
    """A key as the uint32 pair JAX stores (the port keeps int64)."""
    return key.numpy().astype(np.uint32)


def _key_from_words(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(words).astype(np.int64))


class FederatedServer:
    def __init__(self, cfg: FLConfig, adapter: ModelAdapter,
                 x: np.ndarray, y: np.ndarray, clients,
                 test_batch: Dict[str, np.ndarray],
                 assign_fn=None, seed: Optional[int] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.adapter = adapter
        self.clients = clients
        self.assign_fn = assign_fn
        self.key = rng.PRNGKey(cfg.seed if seed is None else seed)
        self.params = adapter.init(self._next_key())
        self.logs: List[RoundLog] = []
        self.runtime = make_runtime(cfg, adapter, x, y, clients, self.device)
        n = cfg.num_clients
        self.dynamics = cfg.dynamics_enabled
        self.defended = cfg.defended
        self.state = SEL.SelectionState(
            clusters=torch.zeros(n, dtype=torch.int32, device=self.device),
            residual=EN.init_energy(cfg, self._next_key(), self.device),
            history=torch.zeros(n, dtype=torch.int32, device=self.device),
            local_sizes=torch.tensor([c.size for c in clients],
                                     dtype=torch.int32, device=self.device),
            # None with dynamics off, so the plain round is unchanged
            staleness=(torch.zeros(n, dtype=torch.int32, device=self.device)
                       if self.dynamics else None),
            # the reputation ledger, only on the defended path
            strikes=(torch.zeros(n, dtype=torch.float32, device=self.device)
                     if self.defended else None),
            scheme_state=SCH.init_scheme_state(cfg, self.device),
        )
        self.global_hist = global_histogram(y, cfg.num_classes)
        self.client_labels = [y[c.train_idx] for c in clients]
        self.total_client_reward = 0.0
        self._round_step = RND.make_round_step(
            cfg, client_count_histograms(self.client_labels,
                                         cfg.num_classes),
            self.global_hist, dynamics=self.dynamics, device=self.device)
        if self.dynamics:
            # the dedicated dynamics chain: churn-0 runs consume the
            # selection chain exactly as plain runs do
            self._dyn_key = DYN.dynamics_key(cfg)
            self.dyn_state = DYN.init_dynamics(cfg, self.device)
            # host mirrors the replacement sampler reads: round-start
            # availability and (after stage 1) cluster ids
            self._host_avail = np.ones((n,), bool)
            self._host_clusters = np.zeros((n,), np.int64)
            self._host_sizes = np.asarray([c.size for c in clients],
                                          np.int64)
            # replacement draws come from their own host rng chain, so
            # they are a pure function of (seed, outcome stream) and
            # identical across cohort runtimes
            self._dyn_rng = np.random.default_rng(
                np.uint32(cfg.seed) + 0x5D7A)
            m = SCH.host_replacement_mask(cfg, self._host_sizes)
            self._host_feasible = (np.ones((n,), bool)
                                   if m is None else np.asarray(m, bool))
            self.outcome_log: List[np.ndarray] = []   # per-round codes
            self._late_buffer: List[_BufferedUpdate] = []
        if self.defended:
            # the adversary chain and the Byzantine set are fixed at init
            # (pure functions of cfg); one screened step takes every
            # cohort, padded to the static capacity
            self._adv_root = DYN.adversary_key(cfg)
            self._adv_mask = np.asarray(obs.device_get(
                DYN.adversary_mask(cfg, self.device)), bool)
            self._screen_cap = AGG.screen_capacity(cfg)
            self._screen_step = AGG.make_screened_step(cfg)
            self._defense_state = AGG.init_defense_state(cfg, self.device)
            # host tallies, filled at flush boundaries
            self.defense_totals: Dict[str, int] = {
                "quarantined": 0, "screened": 0, "banned_final": 0}
        self._watchdog = cfg.watchdog_enabled
        if self._watchdog:
            # the divergence watchdog: a ring of the last healthy
            # snapshots, a detector over the drained evals, and the server
            # step (a float32 value; exactly 1.0 until a rollback, where
            # scaling by it and blending with it are the identity)
            self._wd_ring: deque = deque(maxlen=max(int(cfg.watchdog_ring),
                                                    1))
            self._srv_lr = 1.0
            self._wd_loss_ema: Optional[float] = None
            self._wd_acc_peak = float("-inf")
            self._wd_healthy = False     # a healthy eval since the rollback
            self._wd_rollbacks = 0
            self.watchdog_totals: Dict[str, int] = {"rollbacks": 0,
                                                    "snapshots": 0}
        # host mirror of participation counts (seeds stage-3 shuffles)
        self._host_history = np.zeros((n,), np.int64)
        self._test = obs.device_put(
            {k: np.asarray(v) for k, v in test_batch.items()}, self.device)
        self._pending: List[_PendingRound] = []
        self._last_eval = (float("nan"), float("nan"))

    # ------------------------------------------------------------------
    def _next_key(self):
        self.key, k = rng.split(self.key)
        return k

    def _next_dyn_key(self):
        self._dyn_key, k = rng.split(self._dyn_key)
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
        if self.dynamics:
            self._host_clusters = np.asarray(obs.device_get(labels),
                                             np.int64)

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

    def _dispatch_round(self, t: int, eval_now: bool,
                        final: bool = False) -> None:
        """Dispatch one FL round; only the winner mask is fetched.  With
        fleet dynamics on, :meth:`_dispatch_round_dyn` does it."""
        if self.dynamics:
            return self._dispatch_round_dyn(t, eval_now, final)
        with obs.span("round/dispatch", round=t):
            with obs.span("round/select", round=t):
                new_state, win, metrics = self._round_step(
                    self.state, self._next_key())
                # the one per-round fetch (explicit, counted)
                sel_idx = np.nonzero(obs.device_get(win))[0]
            with obs.span("round/train", round=t,
                          cohort=int(sel_idx.size)):
                new_params, new_state, defense = self._train_round(
                    self.params, sel_idx, t, new_state)
            if new_params is not None:
                self.params = new_params
            else:
                # zero-winner (or all-zero-size) round: params pass
                # through unchanged and the event is visible in the log
                self._log_empty_round(t)
            self.state = new_state
            self._host_history[sel_idx] += 1
            self._pending.append(_PendingRound(
                round=t, selected=sel_idx, metrics=metrics,
                eval_pair=self._maybe_eval(t, eval_now),
                defense=[defense] if defense is not None else None))

    def _train_round(self, params0, train_idx: np.ndarray, t: int,
                     new_state: SEL.SelectionState):
        """Stage 3 of a (sub-)cohort that aggregates now: returns
        ``(new_params or None, new_state, report or None)``.  Defended,
        the screened step's strikes go into ``new_state``; undefended
        with the watchdog on, the FedAvg result is blended with the
        server step (the identity at 1.0)."""
        if self.defended:
            new_params, rep, strikes = self._train_defended(
                params0, train_idx, t, 0, new_state.strikes)
            return new_params, dc_replace(new_state, strikes=strikes), rep
        new_params = self.runtime.train_cohort(params0, train_idx,
                                               self._host_history)
        if new_params is not None and self._watchdog:
            s = self._srv_lr - 1.0
            new_params = {k: b + s * (b - params0[k])
                          for k, b in new_params.items()}
        return new_params, new_state, None

    def _train_defended(self, params0, train_idx: np.ndarray, t: int,
                        chan: int, strikes):
        """The defended stage 3: the runtime's per-client flat deltas go
        through the screened step, whose aggregate delta (times the
        server step with the watchdog on) is applied to ``params0``.
        ``chan`` separates the round's adversary keys of the main (0) and
        the buffered late (1) sub-cohorts.  Returns ``(new_params, report,
        new_strikes)``, ``(None, None, strikes)`` for an empty cohort."""
        upd = self.runtime.train_cohort_updates(params0, train_idx,
                                                self._host_history)
        if upd is None:
            return None, None, strikes
        ids = np.asarray(upd.client_idx, np.int32)
        real = np.flatnonzero(ids >= 0)
        if real.size == 0:
            return None, None, strikes
        cap = self._screen_cap
        assert real.size <= cap, (f"a cohort of {real.size} exceeds the "
                                  f"screen capacity {cap}")
        # one gather by a host-built plan drops the runtimes' padding rows
        # and pads to the static capacity (padding slots gather row 0 and
        # are masked by valid=False); the plan arrays are the step's only
        # uploads, in one counted copy
        gidx = np.zeros((cap,), np.int64)
        gidx[:real.size] = real
        w = np.zeros((cap,), np.float32)
        w[:real.size] = np.asarray(upd.weights, np.float32)[real]
        idp = np.full((cap,), -1, np.int32)
        idp[:real.size] = ids[real]
        valid = idp >= 0
        adv = valid & self._adv_mask[np.clip(idp, 0, None)]
        gd, wd, vd, ad, idd, rnd = obs.device_put(
            (gidx, w, valid, adv, idp, np.int32(t)), self.device)
        key = rng.fold_in(self._adv_root, 2 * t + chan + 1)
        agg, new_strikes, self._defense_state, report = self._screen_step(
            upd.deltas.index_select(0, gd), wd, vd, ad, idd, strikes,
            self._defense_state, rnd, key)
        if self._watchdog:
            agg = agg * self._srv_lr
        return AGG.apply_delta(params0, agg), report, new_strikes

    def _maybe_eval(self, t: int, eval_now: bool) -> Optional[tuple]:
        if not eval_now:
            return None
        with obs.span("round/eval", round=t):
            return self._eval_step(self.params)

    # -- fleet dynamics ------------------------------------------------
    def _log_empty_round(self, t: int) -> None:
        """A round whose synchronous aggregate had no survivors: params
        pass through unchanged (never a division by a zero weight sum)
        and the event lands in the log for the schema validator."""
        obs.OBS.counter("round/empty")
        obs.OBS.event("dynamics", name="round/empty", round=t)

    def _resample_dropped(self, dropped: np.ndarray,
                          win_np: np.ndarray) -> np.ndarray:
        """Retry-or-replace: each DROPPED winner's slot is refilled by a
        uniform draw among its cluster's currently-available non-winners
        with local data (an empty candidate pool forfeits the slot),
        restricted under ``--scheme-select fedcs`` to plausibly
        deadline-feasible clients (``schemes.host_replacement_mask``).
        Draws come from the dedicated host dynamics rng, so picks are a
        pure function of (seed, outcome stream), identical across cohort
        runtimes and to the JAX package's."""
        chosen: List[int] = []
        taken = win_np.copy()
        for gid in dropped:
            cand = np.nonzero(
                (self._host_clusters == self._host_clusters[int(gid)])
                & self._host_avail & ~taken & (self._host_sizes > 0)
                & self._host_feasible)[0]
            if cand.size == 0:
                continue
            pick = int(cand[self._dyn_rng.integers(cand.size)])
            taken[pick] = True
            chosen.append(pick)
        return np.asarray(chosen, np.int64)

    def _maybe_fold_buffer(self, t: int, force: bool = False) -> int:
        """Fold the arrived late updates into the global model when the
        FedBuff boundary hits: goal-count reached, the oldest arrived
        entry timed out, or ``force`` (the final round folds whatever has
        arrived; updates still in flight when the run ends are lost).
        Each entry's delta is scaled by its staleness discount times its
        share of the folded data mass: a staleness-weighted FedAvg over
        the buffer."""
        arrived = [e for e in self._late_buffer if e.arrival <= t]
        if not arrived:
            return 0
        oldest = min(e.round for e in arrived)
        if not (force or len(arrived) >= self.cfg.buffer_goal
                or t - oldest >= self.cfg.buffer_timeout):
            return 0
        # defended entries carry their survivor fraction on the device:
        # one counted fetch scales the masses, so quarantined rows carry
        # no weight in the fold
        if any(e.mass_scale is not None for e in arrived):
            scales = obs.device_get(
                [e.mass_scale if e.mass_scale is not None
                 else np.float32(1.0) for e in arrived])
            masses = [e.mass * float(s) for e, s in zip(arrived, scales)]
        else:
            masses = [e.mass for e in arrived]
        total = sum(masses)
        if total <= 0.0:
            # every arrived row was quarantined: drop the entries loudly
            # instead of folding a 0/0 into the params
            self._late_buffer = [e for e in self._late_buffer
                                 if e.arrival > t]
            obs.OBS.counter("dyn/buffer_all_quarantined")
            obs.OBS.event("dynamics", name="buffer/all_quarantined",
                          round=t, entries=len(arrived))
            return 0
        with obs.span("round/buffer_fold", round=t, entries=len(arrived)):
            p = self.params
            for e, mass in zip(arrived, masses):
                # the coefficient enters as a float32 scalar, as in JAX
                c = float(np.float32(
                    DYN.staleness_weight(self.cfg, t - e.round)
                    * mass / total))
                p = {k: v + c * e.delta[k] for k, v in p.items()}
            self.params = p
        self._late_buffer = [e for e in self._late_buffer if e.arrival > t]
        obs.OBS.counter("dyn/buffer_folds")
        obs.OBS.event("dynamics", name="buffer/fold", round=t,
                      entries=len(arrived), oldest=oldest)
        return len(arrived)

    def _dispatch_round_dyn(self, t: int, eval_now: bool,
                            final: bool = False) -> None:
        """The dynamics-aware dispatch: one round step (selection + fault
        model), then aggregation over the outcome mask — COMPLETED
        winners plus retry-or-replace substitutes aggregate now, LATE
        winners feed the buffered path, DROPPED ones only burned energy.
        The extra host traffic over the plain loop is the outcome codes
        and the next availability mask, fetched with the winner mask in
        one counted copy."""
        cfg = self.cfg
        with obs.span("round/dispatch", round=t):
            with obs.span("round/select", round=t):
                (new_state, new_dyn, win, outcome,
                 metrics) = self._round_step(self.state, self.dyn_state,
                                             self._next_key(),
                                             self._next_dyn_key())
                win_np, out_np, next_avail = obs.device_get(
                    (win, outcome, new_dyn.avail))
                sel_idx = np.nonzero(win_np)[0]
            completed, late, dropped = DYN.split_outcomes(sel_idx, out_np)
            self.outcome_log.append(out_np[sel_idx])
            repl = (self._resample_dropped(dropped, win_np)
                    if cfg.replace_dropped and dropped.size
                    else np.empty((0,), np.int64))
            train_idx = np.concatenate([completed.astype(np.int64), repl])
            dyn_row: Dict[str, float] = {"num_replaced": int(repl.size)}
            if dropped.size:
                obs.OBS.counter("dyn/dropped", int(dropped.size))
            if late.size:
                obs.OBS.counter("dyn/deadline_miss", int(late.size))
            if repl.size:
                obs.OBS.counter("dyn/replaced", int(repl.size))

            params0 = self.params
            buffered = cfg.aggregation == "buffered"
            defense: List[Dict[str, torch.Tensor]] = []
            if buffered and late.size:
                # the late sub-cohort trains from the same globals it was
                # dispatched with; its aggregate becomes a buffered delta
                rep = None
                with obs.span("round/train_late", round=t,
                              cohort=int(late.size)):
                    if self.defended:
                        late_agg, rep, strikes = self._train_defended(
                            params0, late, t, 1, new_state.strikes)
                        new_state = dc_replace(new_state, strikes=strikes)
                        if rep is not None:
                            defense.append(rep)
                    else:
                        late_agg = self.runtime.train_cohort(
                            params0, late, self._host_history)
                if late_agg is not None:
                    self._late_buffer.append(_BufferedUpdate(
                        delta={k: late_agg[k] - params0[k]
                               for k in params0},
                        mass=float(self._host_sizes[late].sum()),
                        round=t, arrival=t + 1,
                        mass_scale=(rep["survivor_frac"]
                                    if rep is not None else None)))
            with obs.span("round/train", round=t,
                          cohort=int(train_idx.size)):
                new_params, new_state, rep = self._train_round(
                    params0, train_idx, t, new_state)
                if rep is not None:
                    defense.append(rep)
            if new_params is not None:
                self.params = new_params
            else:
                self._log_empty_round(t)

            self.state = new_state
            self.dyn_state = new_dyn
            self._host_avail = np.asarray(next_avail, bool)
            # the shuffle-seed mirror advances for every client whose
            # local pass ran this round (survivors, substitutes and,
            # buffered, the late trainers); the device-side history keeps
            # the control plane's commitment accounting
            trained = (np.concatenate([train_idx, late.astype(np.int64)])
                       if buffered else train_idx)
            self._host_history[trained] += 1
            folded = self._maybe_fold_buffer(t, force=final)
            dyn_row["buffer_len"] = len(self._late_buffer)
            dyn_row["buffer_folded"] = folded
            self._pending.append(_PendingRound(
                round=t, selected=sel_idx, metrics=metrics,
                eval_pair=self._maybe_eval(t, eval_now), dyn=dyn_row,
                defense=defense or None))

    def _flush_pending(self) -> None:
        """Fetch every pending round's scalars (metrics, eval pair,
        screened reports) in one counted copy, turn each entry into a
        RoundLog and a ``round`` row of the event stream, run the
        watchdog over the drained evals, and flush the stream (the
        logging boundary)."""
        if not self._pending:
            return
        with obs.span("round/drain", rounds=len(self._pending),
                      first=self._pending[0].round):
            flat = []
            for p in self._pending:
                flat.extend(p.metrics.values())
                if p.eval_pair is not None:
                    flat.extend(p.eval_pair)
                for d in p.defense or ():
                    flat.extend(d.values())
            vals = iter(obs.device_get(torch.stack(
                [v.float().reshape(()) for v in flat])).tolist())
        # the watchdog's first trigger in this drain: at most one rollback
        # a flush (later evals ran against the already-poisoned params)
        wd_trigger: Optional[Tuple[str, int]] = None
        wd_healthy_seen = False
        for p in self._pending:
            m = {k: next(vals) for k in p.metrics}
            skipped = p.eval_pair is None
            acc, loss = ((next(vals), next(vals)) if not skipped
                         else (float("nan"), float("nan")))
            defs = [{k: next(vals) for k in d} for d in p.defense or ()]
            if not skipped:
                self._last_eval = (acc, loss)
                if not (np.isfinite(acc) and np.isfinite(loss)):
                    # the eval ran and came back non-finite: the model
                    # diverged, which is not an off-cadence skip
                    obs.OBS.counter("round/diverged")
                    obs.OBS.event("defense", name="round/diverged",
                                  round=p.round)
                if self._watchdog and wd_trigger is None:
                    reason = self._wd_detect(acc, loss)
                    if reason is not None:
                        wd_trigger = (reason, p.round)
                    else:
                        wd_healthy_seen = True
                        self._wd_healthy = True
            self.total_client_reward += m["client_reward_sum"]
            scheme = {k: m[k] for k in SCHEME_METRIC_KEYS if k in m}
            self.logs.append(RoundLog(
                round=p.round, selected=p.selected, test_acc=acc,
                test_loss=loss, energy_std=m["energy_std"],
                mean_bid=m["mean_bid"], server_reward=m["server_reward"],
                client_reward_sum=m["client_reward_sum"],
                vds_gap=m["vds_gap"], eval_skipped=skipped,
                scheme_metrics=scheme))
            # the round's series row: host floats from the fetch above
            extra = {k: m[k] for k in DYN_METRIC_KEYS + DEF_METRIC_KEYS
                     if k in m}
            extra.update(scheme)
            if p.dyn is not None:
                extra.update({k: float(v) for k, v in p.dyn.items()})
            if "num_banned" in extra:
                self.defense_totals["banned_final"] = int(
                    extra["num_banned"])
            if defs:
                self._record_defense(p.round, defs, extra)
            obs.OBS.record_round(
                p.round, test_acc=acc, test_loss=loss,
                energy_std=m["energy_std"], mean_bid=m["mean_bid"],
                server_reward=m["server_reward"],
                client_reward_sum=m["client_reward_sum"],
                vds_gap=m["vds_gap"], num_selected=int(p.selected.size),
                eval_skipped=skipped, **extra)
        self._pending.clear()
        if self._watchdog:
            if wd_trigger is not None:
                self._wd_rollback(*wd_trigger)
            elif wd_healthy_seen:
                # the newest drained eval vouches for the current params
                self._wd_snapshot(self.logs[-1].round if self.logs else 0)
        obs.flush()        # the logging boundary: sinks see I/O only here

    def _record_defense(self, t: int, defs: List[Dict[str, float]],
                        extra: Dict[str, float]) -> None:
        """Fold one round's fetched screened reports (late first, main
        last) into the totals, the round row and the event stream."""
        nq = sum(d["num_quarantined"] for d in defs)
        ns = sum(d["num_screened"] for d in defs)
        self.defense_totals["quarantined"] += int(nq)
        self.defense_totals["screened"] += int(ns)
        main = defs[-1]     # the synchronous cohort's report
        extra.update(num_quarantined=nq, num_screened=ns,
                     **{k: main[k] for k in (
                         "num_survivors", "survivor_frac", "clipped_frac",
                         "update_norm_p50", "update_norm_p99",
                         "defense_pressure")})
        if nq > 0:
            obs.OBS.counter("defense/quarantined", int(nq))
            obs.OBS.event("defense", name="quarantine", round=t,
                          quarantined=int(nq))
        if ns > 0:
            obs.OBS.counter("defense/screened", int(ns))
            obs.OBS.event("defense", name="band_screen", round=t,
                          screened=int(ns))

    # -- divergence watchdog -------------------------------------------
    def _wd_detect(self, acc: float, loss: float) -> Optional[str]:
        """Judge one drained eval: None when healthy (the detector state
        advances), else the reason.  Loss against a slow EMA (a spike is
        ``watchdog_loss_mult`` x the EMA + 0.1), accuracy against its
        running peak."""
        cfg = self.cfg
        if not (np.isfinite(acc) and np.isfinite(loss)):
            return "non_finite_eval"
        if (self._wd_loss_ema is not None
                and loss > cfg.watchdog_loss_mult * self._wd_loss_ema + 0.1):
            return "loss_spike"
        if acc < self._wd_acc_peak - cfg.watchdog_acc_drop:
            return "acc_collapse"
        self._wd_loss_ema = (loss if self._wd_loss_ema is None
                             else 0.5 * self._wd_loss_ema + 0.5 * loss)
        self._wd_acc_peak = max(self._wd_acc_peak, acc)
        return None

    def _wd_snapshot(self, t: int) -> None:
        """Push the current server state onto the ring: the checkpoint
        tree by reference, no copy of any tensor."""
        self._wd_ring.append(_RingEntry(
            round=t, tree=self._ckpt_tree(),
            reward=self.total_client_reward, last_eval=self._last_eval,
            dyn_rng_state=(deepcopy(self._dyn_rng.bit_generator.state)
                           if self.dynamics else None),
            host_avail=(self._host_avail.copy() if self.dynamics
                        else None)))
        self.watchdog_totals["snapshots"] += 1

    def _wd_rollback(self, reason: str, bad_round: int) -> None:
        """Restore the newest healthy ring entry, escalate the defense's
        tightening from its current value, decay the server step and fold
        the key chain with ``0x5AFE + rollbacks`` so the retried rounds
        take another path.  When the previous rollback never saw a
        healthy eval, the newest entry is suspect and the next older one
        restores instead."""
        cfg = self.cfg
        if not self._wd_ring:
            return
        if not self._wd_healthy and len(self._wd_ring) > 1:
            self._wd_ring.pop()
        e = self._wd_ring[-1]
        tree = e.tree
        self._wd_rollbacks += 1
        self.params = tree["params"]
        self.state = tree["state"]
        self.key = rng.fold_in(_key_from_words(tree["key"]),
                               0x5AFE + self._wd_rollbacks)
        self._host_history = np.asarray(tree["host_history"],
                                        np.int64).copy()
        if self.dynamics:
            self.dyn_state = DYN.DynamicsState(avail=tree["dyn_avail"])
            self._dyn_key = _key_from_words(tree["dyn_key"])
            self._host_avail = e.host_avail.copy()
            self._dyn_rng.bit_generator.state = deepcopy(e.dyn_rng_state)
            # in-flight late updates trained from abandoned params
            self._late_buffer = []
        if self.defended:
            ds = tree["defense_state"]
            if ds.tighten is not None:
                ds = dc_replace(ds, tighten=self._defense_state.tighten
                                * float(np.float32(cfg.watchdog_tighten)))
            self._defense_state = ds
        self._srv_lr = float(np.float32(self._srv_lr)
                             * np.float32(cfg.watchdog_lr_decay))
        self.total_client_reward = e.reward
        self._last_eval = e.last_eval
        self._wd_loss_ema = None
        self._wd_acc_peak = float("-inf")
        self._wd_healthy = False
        self.watchdog_totals["rollbacks"] = self._wd_rollbacks
        obs.OBS.counter("watchdog/rollbacks")
        obs.OBS.event("watchdog", name="rollback", round=bad_round,
                      restored_round=e.round, reason=reason,
                      rollbacks=self._wd_rollbacks)

    # -- crash tolerance -----------------------------------------------
    def _ckpt_tree(self) -> Dict[str, Any]:
        """Everything array-valued the round loop's future depends on, in
        the JAX server's layout (its key strings; keys as uint32 pairs,
        the history mirror as int32).  The in-flight late buffer is not
        saved: a crash loses updates that never folded into the model,
        FedBuff's semantics for a server restart."""
        tree: Dict[str, Any] = {
            "params": self.params, "state": self.state,
            "key": _key_words(self.key),
            "host_history": self._host_history.astype(np.int32)}
        if self.dynamics:
            tree["dyn_avail"] = self.dyn_state.avail
            tree["dyn_key"] = _key_words(self._dyn_key)
        if self.defended:
            tree["defense_state"] = self._defense_state
        if self._watchdog:
            tree["server_lr"] = np.float32(self._srv_lr)
        return tree

    def save_checkpoint(self, path: str, step: int) -> None:
        """Persist params and selection/dynamics state so a crashed run
        resumes from the last boundary; the reward tally, the selection
        scheme and the replacement sampler's host rng state ride the
        manifest."""
        from repro_torch.checkpoint import io as CKPT
        extra: Dict[str, Any] = {
            "total_client_reward": self.total_client_reward,
            "scheme_select": self.cfg.scheme_select}
        if self._watchdog:
            extra["watchdog_rollbacks"] = self._wd_rollbacks
        if self.dynamics:
            extra["dyn_rng_state"] = self._dyn_rng.bit_generator.state
        with obs.span("run/checkpoint", step=step):
            CKPT.save(path, self._ckpt_tree(), step=step, extra=extra)

    def load_checkpoint(self, path: str) -> int:
        """Restore a :meth:`save_checkpoint` snapshot (the port's or the
        JAX server's) and return the next round index.  Stage 1 must not
        run again afterwards: the restored key already reflects its chain
        consumption and the cluster ids live in the restored state.

        Raises ValueError when the manifest records another selection
        scheme than ``cfg.scheme_select`` (checked first: the scheme
        state and the key chain are scheme-shaped)."""
        from repro_torch.checkpoint import io as CKPT
        manifest = path.removesuffix(".npz") + ".json"
        extra: Dict[str, Any] = {}
        if os.path.exists(manifest):
            with open(manifest) as f:
                extra = json.load(f).get("extra") or {}
            saved = extra.get("scheme_select", "paper")
            if saved != self.cfg.scheme_select:
                raise ValueError(
                    f"checkpoint {path!r} was written by selection scheme "
                    f"{saved!r} but this run uses --scheme-select "
                    f"{self.cfg.scheme_select!r}; resume with "
                    f"--scheme-select {saved} or start a fresh run")
        with obs.span("run/restore"):
            tree, step = CKPT.restore(path, self._ckpt_tree())
        self.params = tree["params"]
        self.state = tree["state"]
        self.key = _key_from_words(tree["key"])
        self._host_history = np.asarray(tree["host_history"], np.int64)
        if self.dynamics:
            self.dyn_state = DYN.DynamicsState(avail=tree["dyn_avail"])
            self._dyn_key = _key_from_words(tree["dyn_key"])
            avail, clusters = obs.device_get(
                (tree["dyn_avail"], self.state.clusters))
            self._host_avail = np.asarray(avail, bool)
            self._host_clusters = np.asarray(clusters, np.int64)
        if self.defended:
            self._defense_state = tree["defense_state"]
        if self._watchdog:
            self._srv_lr = float(tree["server_lr"])
            self._wd_rollbacks = int(extra.get("watchdog_rollbacks", 0))
            self.watchdog_totals["rollbacks"] = self._wd_rollbacks
        self.total_client_reward = float(
            extra.get("total_client_reward", 0.0))
        st = extra.get("dyn_rng_state")
        if self.dynamics and st is not None:
            self._dyn_rng.bit_generator.state = st
        return step

    def run_round(self, t: int) -> RoundLog:
        """One synchronous FL round (dispatch + immediate flush)."""
        self._dispatch_round(t, self._eval_due(t))
        self._flush_pending()
        return self.logs[-1]

    def run(self, rounds: Optional[int] = None, verbose: bool = False,
            audit_sync: bool = False, audit_warm_rounds: int = 2,
            checkpoint_every: int = 0,
            checkpoint_path: Optional[str] = None,
            resume: bool = False) -> List[RoundLog]:
        """Stage 1, then rounds up to ``rounds`` (default ``cfg.rounds``).
        ``verbose`` prints a progress line every 5 rounds with the last
        drained eval; it never changes the eval cadence.  ``audit_sync``
        runs every dispatch from round ``audit_warm_rounds`` on under the
        sync auditor (``obs.sync_audit``): an implicit synchronisation
        with the card raises at the offending op.

        ``checkpoint_every`` > 0 with a ``checkpoint_path`` snapshots the
        server every that many rounds; ``resume`` restores an existing
        snapshot and skips stage 1 (the restored state carries its
        result), so the remaining rounds run as in an uninterrupted
        run."""
        start = 0
        if resume and checkpoint_path is not None and os.path.exists(
                checkpoint_path.removesuffix(".npz") + ".npz"):
            start = self.load_checkpoint(checkpoint_path)
            obs.log(f"resumed checkpoint {checkpoint_path!r} "
                    f"at round {start}")
        if start == 0:
            with obs.span("run/cluster", scheme=self.cfg.scheme):
                self.cluster()
                synchronize(self.device)
        warmup = getattr(self.runtime, "warmup", None)
        if warmup is not None:    # device runtime: meet every class shape
            with obs.span("run/warmup"):
                warmup(self.params)
        if self._watchdog and not self._wd_ring:
            # the pre-training state, so even a round-0 divergence has a
            # healthy entry to roll back to
            self._wd_snapshot(start - 1)
        T = rounds if rounds is not None else self.cfg.rounds
        for t in range(start, T):
            final = t == T - 1
            printing = verbose and (t % 5 == 0 or final)
            eval_now = self._eval_due(t, final=final)
            if audit_sync and t >= audit_warm_rounds:
                with obs.sync_audit():
                    self._dispatch_round(t, eval_now, final=final)
            else:
                self._dispatch_round(t, eval_now, final=final)
            if self._watchdog and eval_now and not printing:
                # with the watchdog on every eval round is a flush
                # boundary, so a divergence is caught within one cadence
                self._flush_pending()
            if printing:
                self._flush_pending()
                log = self.logs[-1]
                acc, loss = self._last_eval
                obs.log(f"  round {t:3d} acc={acc:.3f} loss={loss:.3f} "
                        f"E_std={log.energy_std:.3f} "
                        f"bid={log.mean_bid:.3f} "
                        f"vds_gap={log.vds_gap:.3f}")
            if (checkpoint_every > 0 and checkpoint_path is not None
                    and (t + 1) % checkpoint_every == 0 and not final):
                # flush first so the log stream is consistent up to the
                # snapshot boundary a resumed run continues from
                self._flush_pending()
                self.save_checkpoint(checkpoint_path, t + 1)
        self._flush_pending()
        return self.logs
