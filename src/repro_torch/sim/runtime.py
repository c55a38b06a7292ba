"""Stage-3 execution backends (``FLConfig.runtime``).

  * ``sequential`` — the reference per-client loop, one local SGD step
    per minibatch, with the JAX package's numpy-seeded shuffles and
    size-weighted FedAvg.  The global pool lives on the runtime's device
    once; each step gathers its minibatch there.
  * ``vectorized`` — the batched cohort engine (repro_torch.sim.engine):
    the round's winners are packed on the host into size buckets, and
    each bucket trains as one vmapped program per step with the FedAvg
    partial fused in.  Stage 1's gradient features are one batched pass
    too, over windows gathered on the device.
  * ``sharded`` — the vectorized engine over the cohort mesh
    (repro_torch.launch.mesh.make_cohort_mesh, ``--cohort-devices``):
    each bucket's client axis is split over the mesh's ``data`` axis,
    every shard trains on its own device from its copy of the params,
    and the float32 FedAvg partials are summed on the runtime's device.
    On one device it is the same program at a data size of 1.
  * ``device`` — the device-resident fleet (repro_torch.sim.fleet): every
    client's data is packed once at init into static capacity classes on
    the device; a round sends only small index tensors, and
    :meth:`DeviceRuntime.warmup` meets every class shape before round 0.
    On a mesh of more than one device each invocation's client axis is
    split as in ``sharded``, over a store held on every mesh device.

All backends train on the same shuffles, batch boundaries and FedAvg
weights; results agree up to float reassociation, and the selection logs
are identical.  For the defended path each also has
``train_cohort_updates``: the same local training, returning the
cohort's per-client flat deltas (``core/aggregation.UpdateBatch``)
instead of their FedAvg, always on the runtime's device.  The batched
runtimes add their host packing seconds up in ``host_pack_s``.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Protocol

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import FLConfig
from repro_torch.core.adapters import ModelAdapter
from repro_torch.core.aggregation import UpdateBatch, flat_delta
from repro_torch.core.clustering import window_index_table
from repro_torch.device import canonical_device, resolve_device, synchronize
from repro_torch.launch import mesh as MESH
from repro_torch.optim import apply_updates, fedprox_grad, sgd
from repro_torch.sim.cohort import (HostPlanCache, drop_zero_size_winners,
                                    oracle_batch_plan, pack_cohort,
                                    pack_feature_pass)
from repro_torch.sim.engine import CohortEngine
from repro_torch.sim.fleet import ClassBatch, FleetStore

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


class CohortRuntime(Protocol):
    """What FederatedServer needs from an execution backend; each of
    the four runtimes below has it."""

    name: str

    def train_cohort(self, global_params: Tree, sel_idx: np.ndarray,
                     history: np.ndarray) -> Optional[Tree]:
        """Run local training for the winners and return the aggregated
        global params (None for an empty cohort). ``history`` is a HOST
        array (the server's participation mirror): per-winner shuffle
        seeds index it directly, so the control plane never waits on
        the device for them."""
        ...

    def train_client(self, global_params: Tree, client_idx: int,
                     history_count: int) -> Tree:
        """One client's local params after its local epochs."""
        ...

    def train_cohort_updates(self, global_params: Tree, sel_idx: np.ndarray,
                             history: np.ndarray) -> Optional[UpdateBatch]:
        """Defended-path stage 3: the same local training, but instead
        of the fused FedAvg aggregate return the cohort's per-client
        flat param deltas as an UpdateBatch (core/aggregation.py): (C, D)
        deltas on the runtime's device, host weights and client ids,
        padding rows all-zero with id -1, for the server's screened
        aggregation.
        None for an empty cohort."""
        ...

    def cluster_features(self, global_params: Tree, key,
                         feature_kind: str) -> Optional[torch.Tensor]:
        """(N, D) *raw* clustering features, or None to use the
        per-client loop in core/clustering.py.  Either way the blocked JL
        projection and k-means run downstream in
        ``clustering.cluster_clients``, so every runtime shares one code
        path from raw features onward."""
        ...


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
        idx = obs.device_put(np.asarray(self.clients[client_idx].train_idx),
                             self.device)
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
        plan = obs.device_put(plan, self.device)
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

    def train_cohort_updates(self, global_params: Tree, sel_idx: np.ndarray,
                             history: np.ndarray) -> Optional[UpdateBatch]:
        """One flat delta per winner, in ``sel_idx`` order, with the
        size-weighted FedAvg weights (None for an empty cohort)."""
        history = np.asarray(history)
        sel_idx = drop_zero_size_winners(sel_idx, self.clients)
        if sel_idx.size == 0:
            return None
        with obs.span("cohort/train", defended=True):
            rows = [flat_delta(self.train_client(global_params, int(i),
                                                 int(history[int(i)])),
                               global_params)
                    for i in sel_idx]
            sizes = np.array([self.clients[int(i)].size for i in sel_idx],
                             np.float64)
            return UpdateBatch(deltas=torch.stack(rows),
                               weights=(sizes / sizes.sum()).astype(
                                   np.float32),
                               client_idx=np.asarray(sel_idx, np.int32))

    def cluster_features(self, global_params, key, feature_kind):
        return None   # the per-client loop in clustering.cluster_clients


class VectorizedRuntime(SequentialRuntime):
    """Cohort engine backend: each host-packed bucket trains as one
    vmapped program per step.  Inherits the sequential ``train_client``
    (a single client has no batching to exploit)."""

    name = "vectorized"

    def __init__(self, cfg: FLConfig, adapter: ModelAdapter,
                 x: np.ndarray, y: np.ndarray, clients, device="cuda",
                 mesh=None):
        super().__init__(cfg, adapter, x, y, clients, device)
        if mesh is not None and mesh.devices[0] != canonical_device(
                self.device):
            raise ValueError(f"the cohort mesh starts on {mesh.devices[0]}"
                             f", the runtime runs on {self.device}")
        self.engine = CohortEngine(adapter, cfg, mesh=mesh)
        self.host_pack_s = 0.0   # host packing seconds, all rounds
        self.x_host, self.y_host = np.asarray(x), np.asarray(y)
        # memoized plan structure and local shards: packing rebuilds only
        # the shuffle permutations per round
        self.plan_cache = HostPlanCache(self.x_host, self.y_host, clients,
                                        cfg.local_epochs)
        sizes = self.plan_cache.sizes
        shards = np.zeros((len(clients), max(int(sizes.max()), 1)),
                          np.int64)
        for i, s in enumerate(self.plan_cache.shards):
            shards[i, :len(s)] = s
        # (N, max size) pool rows of every client's shard, for stage 1
        self._shards = torch.tensor(shards, device=self.device)
        self._sizes = torch.tensor(sizes, device=self.device)

    def _pack(self, sel_idx, history, client_multiple: int = 1):
        t0 = time.perf_counter()
        with obs.span("cohort/pack"):
            buckets = pack_cohort(self.x_host, self.y_host, self.clients,
                                  sel_idx, history, self.cfg,
                                  client_multiple=client_multiple,
                                  cache=self.plan_cache)
        self.host_pack_s += time.perf_counter() - t0
        return buckets

    def train_cohort(self, global_params: Tree, sel_idx: np.ndarray,
                     history: np.ndarray) -> Optional[Tree]:
        with obs.span("cohort/train"):
            return self.engine.train_cohort(global_params,
                                            self._pack(sel_idx, history))

    def train_cohort_updates(self, global_params: Tree, sel_idx: np.ndarray,
                             history: np.ndarray) -> Optional[UpdateBatch]:
        """Per-bucket flat deltas, concatenated in bucket order (padding
        rows ride along with id -1 and weight 0).  ``sharded`` inherits
        it as it is: the screened reduction downstream takes one
        device's rows, so it packs with ``client_multiple`` 1 and runs
        unsplit."""
        buckets = self._pack(sel_idx, history)
        if not buckets:
            return None
        with obs.span("cohort/train", defended=True):
            return UpdateBatch(
                deltas=torch.cat([self.engine.train_bucket_updates(
                    global_params, b) for b in buckets]),
                weights=np.concatenate(
                    [np.asarray(b.weights, np.float32) for b in buckets]),
                client_idx=np.concatenate(
                    [np.asarray(b.client_idx, np.int32) for b in buckets]))

    def cluster_features(self, global_params: Tree, key,
                         feature_kind: str) -> torch.Tensor:
        """(N, D) raw clustering features as one batched pass."""
        with obs.span("cluster/features"):
            if feature_kind == "weights":
                buckets = pack_feature_pass(
                    self.x_host, self.y_host, self.clients,
                    chunk_width=self.cfg.cohort_vmap_width,
                    cache=self.plan_cache)
                feats = self.engine.weight_features(
                    global_params, buckets, len(self.clients))
            else:
                feats = self.engine.gradient_features(
                    global_params, *self._gather_gradient_windows(key))
            synchronize(self.device)
            return feats

    def _gather_gradient_windows(self, key):
        """The sequential feature pass's sample windows (the same fold_in
        stream as clustering.cluster_clients), gathered on the device
        from the resident pool into (N, T0, window, ...) tensors."""
        cfg = self.cfg
        idx = window_index_table(key, self._sizes, cfg.cluster_resamples,
                                 cfg.sample_window)
        rows = self._shards.gather(1, idx.reshape(idx.shape[0], -1))
        shape = idx.shape
        return (self.x[rows].reshape(shape + self.x.shape[1:]),
                self.y[rows].reshape(shape))


class ShardedRuntime(VectorizedRuntime):
    """The cohort engine over the cohort mesh: each bucket's client axis
    is split over the mesh's ``data`` axis (replicated params, one shard
    a mesh entry, float32 partials summed on the first device).  The
    packer pads every bucket's client axis to a multiple of the
    data-axis size so the split is even; at a data size of 1 it is the
    same program on one device.  The clustering feature passes and the
    defended updates are the vectorized runtime's."""

    name = "sharded"

    def __init__(self, cfg: FLConfig, adapter: ModelAdapter,
                 x: np.ndarray, y: np.ndarray, clients, device="cuda",
                 mesh=None):
        if mesh is None:
            mesh = MESH.make_cohort_mesh(cfg.cohort_mesh_devices, device)
        super().__init__(cfg, adapter, x, y, clients, device, mesh=mesh)

    def train_cohort(self, global_params: Tree, sel_idx: np.ndarray,
                     history: np.ndarray) -> Optional[Tree]:
        with obs.span("cohort/train"):
            buckets = self._pack(sel_idx, history,
                                 client_multiple=self.engine.data_axis_size)
            return self.engine.train_cohort(global_params, buckets)


class DeviceRuntime(VectorizedRuntime):
    """Device-resident fleet backend (repro_torch.sim.fleet): the fleet's
    data lives on the device in static capacity classes, a round's host
    work is assembling small index plans, and every invocation has a
    class shape that :meth:`warmup` has already met.  On a cohort mesh of
    more than one device each invocation's client axis is split over
    ``data``, over a class store held on every mesh device, as in
    ``sharded``; on one device no mesh is kept.  The clustering feature
    passes and the defended updates run on the runtime's device."""

    name = "device"

    def __init__(self, cfg: FLConfig, adapter: ModelAdapter,
                 x: np.ndarray, y: np.ndarray, clients, device="cuda",
                 mesh=None):
        if mesh is None:
            m = MESH.make_cohort_mesh(cfg.cohort_mesh_devices, device)
            # a 1-device mesh would only add the shard loop
            mesh = m if m.shape["data"] > 1 else None
        super().__init__(cfg, adapter, x, y, clients, device, mesh=mesh)
        self.store = FleetStore(self.x_host, self.y_host, clients, cfg,
                                client_multiple=self.engine.data_axis_size,
                                cache=self.plan_cache, device=self.device,
                                mesh=mesh)
        # the class tensors now hold the fleet on the device
        self.plan_cache.drop_local_data()
        self._warmed = False

    def warmup(self, global_params: Tree) -> None:
        """One fully masked invocation per (class, tier), so the round
        loop meets no new shape: of the updates program when
        ``cfg.defended`` (the defended rounds call it instead of the
        fused one).  Idempotent."""
        if self._warmed:
            return
        batches = self.store.warmup_batches()
        if self.cfg.defended:
            for b in batches:
                self.engine.train_class_updates(global_params,
                                                *self._put_batch(b)[:5])
        else:
            params = self._class_params(global_params)
            for b in batches:
                self.engine.train_class(params, *self._class_args(b))
        self._warmed = True

    def _put_batch(self, b: ClassBatch):
        """The class store and one batch's index tensors on the device
        (one counted upload)."""
        c = self.store.classes[b.cls_id]
        rows, plans, mask, w = obs.device_put(
            (np.asarray(b.rows, np.int64), np.asarray(b.plans, np.int64),
             b.step_mask, b.weights), self.device)
        return c.x, c.y, rows, plans, mask, w

    def _class_params(self, global_params: Tree):
        """``train_class``'s params: on a mesh, copied to the mesh
        devices (once for all of a round's batches)."""
        return (global_params if self.engine.mesh is None
                else self.engine.replicate(global_params))

    def _class_args(self, b: ClassBatch) -> tuple:
        """``train_class``'s arguments past the params for one batch: on a
        mesh, the per-shard stores and the host index arrays, which the
        engine splits by ``fleet_class_specs``."""
        if self.engine.mesh is None:
            return self._put_batch(b)
        c = self.store.classes[b.cls_id]
        return (c.xs, c.ys, np.asarray(b.rows, np.int64),
                np.asarray(b.plans, np.int64), b.step_mask, b.weights)

    def _train_classes(self, global_params: Tree,
                       batches: List[ClassBatch]) -> Optional[Tree]:
        """The FedAvg aggregate over the batches (partials add)."""
        if not batches:
            return None
        params = self._class_params(global_params)
        agg = None
        for b in batches:
            part = self.engine.train_class(params, *self._class_args(b))
            agg = part if agg is None else {k: agg[k] + part[k]
                                            for k in agg}
        return agg

    def _assemble(self, sel_idx, history) -> List[ClassBatch]:
        t0 = time.perf_counter()
        with obs.span("cohort/assemble"):
            batches = self.store.assemble(sel_idx, np.asarray(history))
        self.host_pack_s += time.perf_counter() - t0
        return batches

    def train_cohort(self, global_params: Tree, sel_idx: np.ndarray,
                     history: np.ndarray) -> Optional[Tree]:
        batches = self._assemble(sel_idx, history)
        with obs.span("cohort/train"):
            return self._train_classes(global_params, batches)

    def train_cohort_updates(self, global_params: Tree, sel_idx: np.ndarray,
                             history: np.ndarray) -> Optional[UpdateBatch]:
        """Per-class flat deltas, concatenated in batch order (padding
        rows ride along with id -1 and weight 0)."""
        batches = self._assemble(sel_idx, history)
        if not batches:
            return None
        with obs.span("cohort/train", defended=True):
            return UpdateBatch(
                deltas=torch.cat([self.engine.train_class_updates(
                    global_params, *self._put_batch(b)[:5])
                    for b in batches]),
                weights=np.concatenate(
                    [np.asarray(b.weights, np.float32) for b in batches]),
                client_idx=np.concatenate(
                    [np.asarray(b.client_idx, np.int32) for b in batches]))


def make_runtime(cfg: FLConfig, adapter: ModelAdapter, x, y, clients,
                 device="cuda") -> CohortRuntime:
    if cfg.runtime == "sequential":
        return SequentialRuntime(cfg, adapter, x, y, clients, device)
    if cfg.runtime == "vectorized":
        return VectorizedRuntime(cfg, adapter, x, y, clients, device)
    if cfg.runtime == "sharded":
        return ShardedRuntime(cfg, adapter, x, y, clients, device)
    if cfg.runtime == "device":
        return DeviceRuntime(cfg, adapter, x, y, clients, device)
    raise ValueError(
        f"unknown FLConfig.runtime={cfg.runtime!r}; expected {RUNTIMES}")
