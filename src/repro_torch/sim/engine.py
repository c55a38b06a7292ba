"""Batched cohort engine: a bucket's clients train as one program.

Each entry point runs ``torch.func.vmap`` of ``torch.func.grad`` of the
adapter's pure ``loss(params, batch)`` over the client axis, with a
Python loop over the minibatch steps (the JAX engine's ``lax.scan``):

  * :meth:`CohortEngine.train_bucket` / :meth:`train_cohort` — the
    round's local training: every client runs ``local_epochs`` of SGD
    (FedProx-proximal with ``cfg.aggregator == "fedprox"``) from the
    shared global params; a masked (padding) step is the identity on
    params and optimizer state (``torch.where``); the bucket's weighted
    FedAvg partial is fused in (``tensordot`` over the client axis in
    float32).
  * :meth:`CohortEngine.train_class` — the same for the ``device``
    runtime (repro_torch.sim.fleet): it takes a capacity class's resident
    ``(P, n_cap, *feat)`` store, ``index_select``s the winners' rows and
    gathers each step's minibatch on the device by the plan's indices.
  * :meth:`CohortEngine.train_bucket_updates` /
    :meth:`train_class_updates` — the defended path's twins of
    ``train_bucket`` / ``train_class``: the same local steps, returning
    the ``(C, D)`` float32 per-client flat delta matrix the screened
    aggregation (``core/aggregation.py``) takes instead of the FedAvg
    partial (a padding row's params are the globals, so its delta is
    all-zero).
  * :meth:`CohortEngine.gradient_features` — the paper's clustering
    feature: the mean flattened gradient over the T0 sample windows, one
    vmapped gradient over all clients per window index.
  * :meth:`CohortEngine.weight_features` — the weight-delta feature:
    the flat param delta after one in-order epoch of plain SGD.

Only the gradient runs under ``vmap``: the optimizer, the FedProx term
and the mask are elementwise, so they act on the stacked ``(C, ...)``
params directly.  Batch norm (CNN-FMNIST) takes each client's own batch
statistics under ``vmap``, as under JAX's.

With a ``mesh`` (repro_torch.launch.mesh.CohortMesh: the ``sharded``
runtime, and ``device`` on several devices), :meth:`train_cohort` and
:meth:`train_class` split each bucket's or invocation's padded client
axis into ``data`` contiguous shards of ``C / data`` rows, by the specs
of repro_torch.sharding.rules.  One process drives every shard, as
JAX's single controller does: each shard's steps are queued on its own
device (launches are asynchronous, so shards on different cards
overlap), and each shard forms its float32 weighted partial.  The
partials go to the mesh's first device and are added there in shard
order, and only their float32 sum is cast to the params' dtype (JAX's
``psum(p).astype(dtype)``).  The global params are copied to each mesh
device once a round (:meth:`replicate`).  The defended twins and the
clustering features stay on one device, as in the JAX engine.

Unlike the JAX engine, the port vmaps a bucket's whole client axis at
once: the JAX engine's chunked ``lax.map`` over ``cohort_vmap_width``
clients keeps the CPU's cache warm and changes no client's arithmetic.
``cohort_vmap_width`` still sets the packer's padding, so bucket shapes
equal the JAX package's.  Eager PyTorch has no traces, so ``stats``
keeps only the per-shape ``shape_hits`` / ``shape_misses`` (keyed as
the JAX engine's ``_note_shape``).  Results agree with the sequential
runtime up to float reassociation.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from repro_torch import obs
from repro_torch.configs.base import FLConfig
from repro_torch.core.adapters import ModelAdapter
from repro_torch.optim import OptState, apply_updates, fedprox_grad, sgd
from repro_torch.sharding import rules
from repro_torch.sim.cohort import CohortBucket

Tree = Dict[str, torch.Tensor]


def _flatten_rows(tree: Tree, rows: int) -> torch.Tensor:
    """(rows, D): each leading-axis slice flattened, leaves in sorted-key
    order (``jax.tree.leaves``' order on a dict)."""
    return torch.cat([tree[k].reshape(rows, -1) for k in sorted(tree)], 1)


def _where(keep: torch.Tensor, new: Tree, old: Tree) -> Tree:
    """Per client (leading axis): ``new`` where ``keep`` else ``old``."""
    return {k: torch.where(keep.view((-1,) + (1,) * (v.dim() - 1)), v,
                           old[k]) for k, v in new.items()}


def _device_of(params: Tree) -> torch.device:
    return next(iter(params.values())).device


class CohortEngine:
    def __init__(self, adapter: ModelAdapter, cfg: FLConfig, mesh=None):
        self.adapter = adapter
        self.cfg = cfg
        self.mesh = mesh
        self.stats = {"shape_hits": 0, "shape_misses": 0}
        self._seen_shapes = set()
        grad = torch.func.grad(adapter.loss)
        self._client_grads = torch.func.vmap(grad)        # per-client params
        self._shared_grads = torch.func.vmap(grad, in_dims=(None, 0))

    @property
    def data_axis_size(self) -> int:
        """Client-axis shard count (1 when unsharded)."""
        return 1 if self.mesh is None else self.mesh.shape["data"]

    def replicate(self, tree: Tree) -> Tuple[Tree, ...]:
        """``tree`` once per mesh shard, on the shard's device: one copy
        per distinct device (a shard on the tree's own device, or on a
        device already copied to, shares that copy)."""
        copies: Dict[torch.device, Tree] = {}
        for dev in self.mesh.devices:
            if dev not in copies:
                copies[dev] = {k: v.to(dev, non_blocking=True)
                               for k, v in tree.items()}
        return tuple(copies[dev] for dev in self.mesh.devices)

    def _note_shape(self, key) -> None:
        hit = key in self._seen_shapes
        if hit:
            self.stats["shape_hits"] += 1
        else:
            self._seen_shapes.add(key)
            self.stats["shape_misses"] += 1
        obs.torch_stats.note_shape(hit)     # process-wide mirror

    # ------------------------------------------------------------------
    def _local_steps(self, global_params: Tree,
                     batches: Iterator[Tuple[torch.Tensor, torch.Tensor]],
                     mask: torch.Tensor, momentum: float,
                     proximal: bool) -> Tree:
        """Every client's local SGD from ``global_params``: ``batches``
        yields step s's ``(xs (C, bs, ...), ys (C, bs))`` and ``mask
        (C, S)`` marks the real steps.  Returns the stacked (C, ...)
        params."""
        init, update = sgd(self.cfg.lr, momentum=momentum)
        c = mask.shape[0]
        p = {k: v.expand((c,) + v.shape) for k, v in global_params.items()}
        opt = init(p)
        for s, (xs, ys) in enumerate(batches):
            g = self._client_grads(p, {"x": xs, "y": ys})
            if proximal:
                g = fedprox_grad(g, p, global_params, self.cfg.fedprox_mu)
            u, opt2 = update(g, opt, p)
            keep = mask[:, s] > 0.5
            p = _where(keep, apply_updates(p, u), p)
            opt = OptState(opt2.step, None if opt2.mu is None
                           else _where(keep, opt2.mu, opt.mu))
        return p

    def _train_steps(self, global_params: Tree, batches, mask: torch.Tensor
                     ) -> Tree:
        return self._local_steps(global_params, batches, mask,
                                 self.cfg.local_momentum,
                                 self.cfg.aggregator == "fedprox")

    @staticmethod
    def _f32_partial(stacked: Tree, weights: torch.Tensor) -> Tree:
        """sum_c w_c * params_c in float32."""
        return {k: torch.tensordot(weights, v.float(), dims=1)
                for k, v in stacked.items()}

    @classmethod
    def _fedavg_partial(cls, stacked: Tree, weights: torch.Tensor,
                        global_params: Tree) -> Tree:
        """sum_c w_c * params_c in float32, cast to the params' dtype."""
        return {k: v.to(global_params[k].dtype)
                for k, v in cls._f32_partial(stacked, weights).items()}

    def _mesh_reduce(self, partials: Sequence[Tree], like: Tree) -> Tree:
        """The shards' float32 partials added on the mesh's first device
        in shard order, then cast to the dtypes of ``like``'s leaves
        (JAX's ``psum(p).astype(dtype)``)."""
        first = self.mesh.devices[0]
        total = {k: v.to(first, non_blocking=True)
                 for k, v in partials[0].items()}
        for part in partials[1:]:
            total = {k: total[k] + part[k].to(first, non_blocking=True)
                     for k in total}
        return {k: v.to(like[k].dtype) for k, v in total.items()}

    def _sharded(self, specs: Sequence[str], args: Sequence
                 ) -> List[tuple]:
        """Each shard's arguments under ``specs``: a replicated one is
        taken per shard as given; a split one (a host array) is cut on
        axis 0 and uploaded to the shard's device, in one counted upload
        a shard."""
        n = self.data_axis_size
        split = [i for i, spec in enumerate(specs) if spec == rules.DATA]
        out = []
        for s, dev in enumerate(self.mesh.devices):
            mine = [rules.shard_of(spec, a, s, n)
                    for spec, a in zip(specs, args)]
            put = obs.device_put(tuple(mine[i] for i in split), dev)
            for i, t in zip(split, put):
                mine[i] = t
            out.append(tuple(mine))
        return out

    @staticmethod
    def _flat_deltas(stacked: Tree, global_params: Tree) -> torch.Tensor:
        """(C, D) float32 per-client deltas against the globals, leaves
        in sorted-key order (``core/aggregation.flat_delta``'s layout)."""
        c = next(iter(stacked.values())).shape[0]
        return _flatten_rows({k: v.float() - global_params[k].float()[None]
                              for k, v in stacked.items()}, c)

    @staticmethod
    def _bucket_tensors(b: CohortBucket, device):
        """The bucket's arrays on ``device``, in one counted upload."""
        return obs.device_put((b.xb, b.yb, b.step_mask, b.weights), device)

    # ------------------------------------------------------------------
    def train_bucket(self, global_params: Tree, bucket: CohortBucket
                     ) -> Tuple[Tree, Tree]:
        """(stacked per-client params with leading C axis, weighted
        partial aggregate sum_c w_c * params_c) for one host-packed
        bucket, whose arrays are copied to the params' device."""
        xb, yb, mask, w = self._bucket_tensors(bucket,
                                               _device_of(global_params))
        stacked = self._train_steps(
            global_params,
            ((xb[:, s], yb[:, s]) for s in range(xb.shape[1])), mask)
        return stacked, self._fedavg_partial(stacked, w, global_params)

    def train_cohort(self, global_params: Tree,
                     buckets: List[CohortBucket]) -> Optional[Tree]:
        """Aggregated params over all buckets, or None for an empty
        cohort.  Weights are global, so bucket partials just add.  With
        a mesh, each bucket's client axis is split over the shards (the
        params copied to the mesh devices once for all buckets)."""
        replicas = (self.replicate(global_params)
                    if self.mesh is not None and buckets else None)
        agg = None
        for b in buckets:
            self._note_shape(("bucket", b.xb.shape))
            if replicas is None:
                _, part = self.train_bucket(global_params, b)
            else:
                part = self._train_bucket_sharded(replicas, b)
            agg = part if agg is None else {k: agg[k] + part[k]
                                            for k in agg}
        return agg

    def _train_bucket_sharded(self, replicas: Sequence[Tree],
                              bucket: CohortBucket) -> Tree:
        """One host-packed bucket over the mesh: the cohort rules split
        its arrays, each shard trains its rows on its device from its
        replica of the params, and the float32 partials are reduced."""
        specs = (rules.cohort_param_spec(),) + rules.cohort_bucket_specs()
        partials = []
        for params, xb, yb, mask, w in self._sharded(
                specs, (replicas, bucket.xb, bucket.yb, bucket.step_mask,
                        bucket.weights)):
            stacked = self._train_steps(
                params, ((xb[:, s], yb[:, s]) for s in range(xb.shape[1])),
                mask)
            partials.append(self._f32_partial(stacked, w))
        return self._mesh_reduce(partials, replicas[0])

    def train_bucket_updates(self, global_params: Tree,
                             bucket: CohortBucket) -> torch.Tensor:
        """(C, D) float32 per-client flat deltas of one host-packed
        bucket (padding rows all-zero; ``bucket.client_idx`` marks them
        -1)."""
        self._note_shape(("bucket_upd", bucket.xb.shape))
        xb, yb, mask, _ = self._bucket_tensors(bucket,
                                               _device_of(global_params))
        stacked = self._train_steps(
            global_params,
            ((xb[:, s], yb[:, s]) for s in range(xb.shape[1])), mask)
        return self._flat_deltas(stacked, global_params)

    def _class_steps(self, global_params: Tree, class_x, class_y, rows,
                     plans, step_mask) -> Tree:
        xg = class_x.index_select(0, rows)          # (C, n_cap, *feat)
        yg = class_y.index_select(0, rows)
        cl = torch.arange(rows.shape[0], device=rows.device)[:, None]
        return self._train_steps(
            global_params,
            ((xg[cl, plans[:, s]], yg[cl, plans[:, s]])
             for s in range(plans.shape[1])), step_mask)

    def train_class(self, global_params, class_x, class_y, rows, plans,
                    step_mask, weights) -> Tree:
        """One capacity-class invocation of the device-resident trainer:
        ``class_x/class_y`` are the class's resident ``(P, n_cap, ...)``
        store, ``rows (C,)``, ``plans (C, S, bs)`` (int64), ``step_mask
        (C, S)`` and ``weights (C,)`` the invocation's tensors
        (repro_torch.sim.fleet.ClassBatch) on the same device.  Returns
        the weighted FedAvg partial; partials across invocations add.

        With a mesh the arguments follow ``cohort_param_spec`` and
        ``fleet_class_specs``: the replicated ones (params, store) one
        entry per shard (:meth:`replicate`, ``CapacityClass.xs``), the
        split ones (rows, plans, step_mask, weights) as host arrays,
        which the shards cut on their client axis."""
        if self.mesh is None:
            self._note_shape(("class", tuple(class_x.shape),
                              tuple(plans.shape)))
            stacked = self._class_steps(global_params, class_x, class_y,
                                        rows, plans, step_mask)
            return self._fedavg_partial(stacked, weights, global_params)
        self._note_shape(("class", tuple(class_x[0].shape),
                          tuple(plans.shape)))
        specs = (rules.cohort_param_spec(),) + rules.fleet_class_specs()
        partials = []
        for params, cx, cy, r, p, m, w in self._sharded(
                specs, (global_params, class_x, class_y, rows, plans,
                        step_mask, weights)):
            stacked = self._class_steps(params, cx, cy, r, p, m)
            partials.append(self._f32_partial(stacked, w))
        return self._mesh_reduce(partials, global_params[0])

    def train_class_updates(self, global_params: Tree,
                            class_x: torch.Tensor, class_y: torch.Tensor,
                            rows: torch.Tensor, plans: torch.Tensor,
                            step_mask: torch.Tensor) -> torch.Tensor:
        """(C_cap, D) float32 flat deltas of one capacity-class
        invocation: :meth:`train_class`'s defended twin."""
        self._note_shape(("class_upd", tuple(class_x.shape),
                          tuple(plans.shape)))
        return self._flat_deltas(
            self._class_steps(global_params, class_x, class_y, rows, plans,
                              step_mask), global_params)

    def weight_features(self, global_params: Tree,
                        buckets: List[CohortBucket],
                        num_clients: int) -> torch.Tensor:
        """(N, D) weight-delta features in original client order: one
        in-order epoch of plain SGD (no momentum, no proximal term)."""
        dev = _device_of(global_params)
        rows: List[Optional[torch.Tensor]] = [None] * num_clients
        for b in buckets:
            xb, yb, mask, _ = self._bucket_tensors(b, dev)
            p = self._local_steps(
                global_params,
                ((xb[:, s], yb[:, s]) for s in range(xb.shape[1])), mask,
                momentum=0.0, proximal=False)
            delta = {k: p[k] - global_params[k] for k in p}
            feats = _flatten_rows(delta, b.num_clients)
            for row, cid in enumerate(b.client_idx):
                if cid >= 0:
                    rows[int(cid)] = feats[row]
        missing = [i for i, r in enumerate(rows) if r is None]
        if missing:
            raise ValueError(
                f"clients {missing} missing from the packed buckets: "
                f"expected every id in [0, {num_clients}) exactly once "
                "(zero-size clients are dropped by the packer and have no "
                "weight-delta feature)")
        return torch.stack(rows)

    def gradient_features(self, params: Tree, xb: torch.Tensor,
                          yb: torch.Tensor) -> torch.Tensor:
        """(N, D) mean sample-window gradients; ``xb (N, T0, window,
        *feat)``, ``yb (N, T0, window)`` on the params' device: one
        vmapped gradient over the N clients per window index t."""
        n, t0 = xb.shape[:2]
        total = None
        for t in range(t0):
            flat = _flatten_rows(
                self._shared_grads(params, {"x": xb[:, t], "y": yb[:, t]}),
                n)
            total = flat if total is None else total + flat
        return total / t0

