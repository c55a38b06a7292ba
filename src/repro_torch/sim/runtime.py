"""Stage-3 execution backends (``FLConfig.runtime``).

Only ``sequential`` is ported: the reference per-client loop, one local
SGD step per minibatch, with the JAX package's numpy-seeded shuffles and
size-weighted FedAvg.  The batched runtimes (``vectorized``, ``sharded``,
``device``) are not ported yet (ROADMAP.md, queue 1).  The global pool
lives on the runtime's device once; each step gathers its minibatch
there.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import FLConfig
from repro_torch.core.adapters import ModelAdapter
from repro_torch.device import resolve_device
from repro_torch.optim import apply_updates, fedprox_grad, sgd
from repro_torch.sim.cohort import drop_zero_size_winners, oracle_batch_plan

RUNTIMES = ("sequential", "vectorized", "sharded", "device")

Tree = Dict[str, torch.Tensor]


def tree_weighted_sum(trees: List[Tree], weights: np.ndarray) -> Tree:
    """sum_k p_k * tree_k (the FedAvg reduction).  The host float64
    weights are rounded to float32 first, as the JAX package does."""
    w = [float(v) for v in np.asarray(weights, np.float32)]
    out = {k: v * w[0] for k, v in trees[0].items()}
    for t, wk in zip(trees[1:], w[1:]):
        out = {k: out[k] + t[k] * wk for k in out}
    return out


class SequentialRuntime:
    """Reference oracle: the per-client loop."""

    name = "sequential"

    def __init__(self, cfg: FLConfig, adapter: ModelAdapter,
                 x: np.ndarray, y: np.ndarray, clients, device="cuda"):
        self.cfg = cfg
        self.adapter = adapter
        self.device = resolve_device(device)
        self.x = torch.tensor(np.asarray(x), device=self.device)
        self.y = torch.tensor(np.asarray(y), device=self.device)
        self.clients = clients
        self._init, self._update = sgd(cfg.lr, momentum=cfg.local_momentum)

    def local_data(self, client_idx: int):
        """The client's train shard (x, y) as tensors on the device."""
        idx = torch.as_tensor(self.clients[client_idx].train_idx,
                              device=self.device)
        return self.x[idx], self.y[idx]

    def _local_step(self, params: Tree, opt, batch, global_params: Tree):
        g = self.adapter.grad(params, batch)
        if self.cfg.aggregator == "fedprox":
            g = fedprox_grad(g, params, global_params, self.cfg.fedprox_mu)
        u, opt = self._update(g, opt, params)
        return apply_updates(params, u), opt

    def train_client(self, global_params: Tree, client_idx: int,
                     history_count: int) -> Tree:
        x, y = self.local_data(client_idx)
        n = x.shape[0]
        plan = oracle_batch_plan(
            n, min(32, n), self.cfg.local_epochs,
            np.random.default_rng(int(history_count) * 977 + client_idx))
        plan = torch.as_tensor(plan, device=self.device)
        p, opt = global_params, self._init(global_params)
        for rows in plan:
            p, opt = self._local_step(p, opt, {"x": x[rows], "y": y[rows]},
                                      global_params)
        return p

    def train_cohort(self, global_params: Tree, sel_idx: np.ndarray,
                     history: np.ndarray) -> Optional[Tree]:
        """Local training for the winners and their size-weighted FedAvg
        (None for an empty cohort).  ``history`` is the server's host
        mirror of participation counts (it seeds the shuffles)."""
        history = np.asarray(history)
        sel_idx = drop_zero_size_winners(sel_idx, self.clients)
        if sel_idx.size == 0:
            return None
        with obs.span("cohort/train"):
            locals_ = [self.train_client(global_params, int(i),
                                         int(history[int(i)]))
                       for i in sel_idx]
            sizes = np.array([self.clients[int(i)].size for i in sel_idx],
                             np.float64)
            return tree_weighted_sum(locals_, sizes / sizes.sum())

    def cluster_features(self, global_params, key, feature_kind):
        return None   # the per-client loop in clustering.cluster_clients


def make_runtime(cfg: FLConfig, adapter: ModelAdapter, x, y, clients,
                 device="cuda") -> SequentialRuntime:
    if cfg.runtime == "sequential":
        return SequentialRuntime(cfg, adapter, x, y, clients, device)
    if cfg.runtime in RUNTIMES:
        raise NotImplementedError(
            f"runtime {cfg.runtime!r} is not ported yet (ROADMAP.md, queue "
            "1: batched cohort runtimes); only 'sequential' runs")
    raise ValueError(
        f"unknown FLConfig.runtime={cfg.runtime!r}; expected {RUNTIMES}")
