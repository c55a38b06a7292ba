"""Cohort packing (host-side numpy): turn a set of selected clients' index
shards into the dense, padded minibatch arrays the batched engine
consumes, bit for bit as the JAX package's packer builds them.

The sequential runtime iterates, per client, ``local_epochs`` shuffled
passes of full minibatches of size ``bs = min(32, n)`` and drops the
remainder batch; the shuffle stream is
``np.random.default_rng(history * 977 + client_idx)``, as in the JAX
package, so every runtime of both packages trains on the same
minibatches.  Packing never pads *inside* a batch; it pads only along

  * the **step axis**: a client with fewer steps than its bucket's
    maximum gets trailing steps whose mask is 0 (the engine turns a
    masked step into the identity), and
  * the **client axis**: each bucket is padded with weight-0 rows to a
    multiple of ``cfg.cohort_vmap_width``, but never beyond the next
    power of two, and then to a multiple of ``client_multiple`` (the
    cohort mesh's data-axis size, so a sharded bucket splits evenly).

Clients are split into **buckets** keyed by ``(batch size, power-of-two
step band)``; the bucket partial aggregates (against the cohort's global
weights) add up to the full FedAvg update.  :class:`HostPlanCache`
memoizes each client's plan structure and local data, so per-round
packing rebuilds only the permutations.  With sinks attached, each
packing adds to the ``pack/buckets``, ``pack/client_rows`` and
``pack/real_clients`` counters (the padding it carried), as the JAX
packer does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.configs.base import FLConfig


@dataclass
class CohortBucket:
    """One homogeneous slice of a cohort (shared batch size).

    Shapes: ``xb (C, S, bs, *feat)``, ``yb (C, S, bs)``, ``step_mask
    (C, S)`` float32 (1 = real step), ``weights (C,)`` float32 global
    aggregation weights (over *all* buckets they sum to 1; padded rows are
    0), ``client_idx (C,)`` int32 global client ids (-1 for padding).
    """

    client_idx: np.ndarray
    xb: np.ndarray
    yb: np.ndarray
    step_mask: np.ndarray
    weights: np.ndarray
    batch_size: int

    @property
    def num_clients(self) -> int:
        return int(self.client_idx.shape[0])

    @property
    def num_steps(self) -> int:
        return int(self.step_mask.shape[1])


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _round_up(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def drop_zero_size_winners(sel_idx: np.ndarray, clients) -> np.ndarray:
    """Winners with no local samples run no steps and carry no FedAvg
    mass — drop them before packing or weighting."""
    sel_idx = np.asarray(sel_idx)
    if sel_idx.size == 0:
        return sel_idx
    return sel_idx[[clients[int(i)].size > 0 for i in sel_idx]]


def oracle_batch_plan(n: int, bs: int, epochs: int,
                      rng: np.random.Generator) -> np.ndarray:
    """The exact (epochs * steps, bs) local-index plan the sequential
    runtime executes: per epoch one ``rng.permutation(n)`` draw, then full
    minibatches of ``bs`` with the remainder dropped."""
    steps = (n - bs) // bs + 1 if n >= bs else 0
    out = np.empty((epochs * steps, bs), np.int64)
    r = 0
    for _ in range(epochs):
        order = rng.permutation(n)
        for i in range(0, n - bs + 1, bs):
            out[r] = order[i:i + bs]
            r += 1
    return out


def sequential_batch_plan(n: int, bs: int) -> np.ndarray:
    """The weight-feature pass's plan: one epoch, natural order, full
    minibatches, remainder dropped."""
    steps = (n - bs) // bs + 1 if n >= bs else 0
    return np.arange(steps * bs, dtype=np.int64).reshape(steps, bs)


class HostPlanCache:
    """Per-client plan structure and local data shards, memoized once.

    The batch size, per-epoch step count and batch boundaries of
    :func:`oracle_batch_plan` depend only on the shard size and
    ``local_epochs``; only the permutation values depend on the
    history-seeded rng.  :meth:`plan` returns *local* sample indices
    (into the client's own shard): ``shard[oracle_batch_plan(...)] ==
    shard[plan(...)]`` row for row.
    """

    def __init__(self, x: np.ndarray, y: np.ndarray, clients,
                 epochs: int):
        self.epochs = int(epochs)
        self._x, self._y = x, y
        self.shards = [np.asarray(c.train_idx) for c in clients]
        self.sizes = np.array([len(s) for s in self.shards], np.int64)
        self.bs = np.minimum(32, self.sizes)
        # full minibatches of bs with the remainder dropped = n // bs
        self.steps = np.where(self.sizes > 0,
                              self.sizes // np.maximum(self.bs, 1), 0)
        self._local: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}

    def local_data(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        """(x[shard], y[shard]) for client ``i``, gathered once."""
        got = self._local.get(i)
        if got is None:
            s = self.shards[i]
            got = self._local[i] = (self._x[s], self._y[s])
        return got

    def drop_local_data(self) -> None:
        """Release the memoized host copies (gathered again on next use):
        the device runtime calls this once its fleet store holds them."""
        self._local.clear()

    def plan(self, i: int, history_count: int) -> np.ndarray:
        """The oracle's (epochs * steps, bs) plan in LOCAL indices: only
        the ``rng.permutation`` draws are recomputed per call."""
        n, bs = int(self.sizes[i]), int(self.bs[i])
        s = int(self.steps[i])
        rng = np.random.default_rng(int(history_count) * 977 + int(i))
        out = np.empty((self.epochs * s, bs), np.int64)
        for e in range(self.epochs):
            order = rng.permutation(n)
            out[e * s:(e + 1) * s] = order[:s * bs].reshape(s, bs)
        return out


def _pack_plans(locals_xy: Sequence[Tuple[np.ndarray, np.ndarray]],
                plans: Sequence[np.ndarray],
                client_ids: Sequence[int],
                weights: Sequence[float],
                chunk_width: int = 4,
                client_multiple: int = 1) -> List[CohortBucket]:
    """Group (plan, local shard) pairs into (batch size, pow2 step band)
    buckets and materialize the padded arrays.  ``locals_xy[m]`` holds
    member m's (x_local, y_local) data and ``plans[m]`` indexes into it.
    ``client_multiple`` forces the padded client axis to a multiple of
    the mesh's data-axis size."""
    by_key: Dict[tuple, List[int]] = {}
    for pos, plan in enumerate(plans):
        key = (plan.shape[1], _next_pow2(max(plan.shape[0], 1)))
        by_key.setdefault(key, []).append(pos)

    x0, y0 = locals_xy[0]
    buckets = []
    for (bs, _band), members in sorted(by_key.items()):
        s_max = _round_up(max(plans[m].shape[0] for m in members), 4)
        # multiple of the vmap width, but never beyond next-pow2 (a
        # 2-client bucket padded to 4 would double its compute)
        c_pad = min(_round_up(len(members), chunk_width),
                    _next_pow2(len(members)))
        c_pad = _round_up(c_pad, client_multiple)
        xb = np.zeros((c_pad, s_max, bs) + x0.shape[1:], x0.dtype)
        yb = np.zeros((c_pad, s_max, bs), y0.dtype)
        mask = np.zeros((c_pad, s_max), np.float32)
        w = np.zeros((c_pad,), np.float32)
        cid = np.full((c_pad,), -1, np.int32)
        for row, m in enumerate(members):
            plan = plans[m]
            xl, yl = locals_xy[m]
            s = plan.shape[0]
            xb[row, :s] = xl[plan]                     # (s, bs, *feat)
            yb[row, :s] = yl[plan]
            mask[row, :s] = 1.0
            w[row] = weights[m]
            cid[row] = client_ids[m]
        buckets.append(CohortBucket(client_idx=cid, xb=xb, yb=yb,
                                    step_mask=mask, weights=w,
                                    batch_size=bs))
    if obs.OBS.enabled:
        # padding counters (emitted at the next flush): bucket programs
        # run, the padded client rows they carried, the real members
        obs.OBS.counter("pack/buckets", len(buckets))
        obs.OBS.counter("pack/client_rows",
                        sum(b.weights.shape[0] for b in buckets))
        obs.OBS.counter("pack/real_clients", len(plans))
    return buckets


def pack_cohort(x: np.ndarray, y: np.ndarray, clients,
                sel_idx: np.ndarray, history: np.ndarray,
                cfg: FLConfig, client_multiple: int = 1,
                cache: Optional[HostPlanCache] = None
                ) -> List[CohortBucket]:
    """Pack the round's winners for the engine.

    ``history`` is the pre-round participation count per client (it seeds
    the shuffles).  Aggregation weights are ``p_k = n_k / sum n_k`` over
    the whole cohort.  Zero-size winners are dropped up front; an
    all-zero cohort packs to [] (the runtimes then skip aggregation).
    ``client_multiple`` pads every bucket's client axis to a multiple
    of it (the cohort mesh's data-axis size).  ``cache`` carries the
    memoized plan structure and local data across rounds; without one a
    throwaway cache is built (same result).
    """
    sel_idx = drop_zero_size_winners(sel_idx, clients)
    if sel_idx.size == 0:
        return []
    if cache is None:
        cache = HostPlanCache(x, y, clients, cfg.local_epochs)
    sizes = cache.sizes[sel_idx].astype(np.float64)
    pk = sizes / sizes.sum()

    locals_xy = [cache.local_data(int(i)) for i in sel_idx]
    plans = [cache.plan(int(i), int(history[int(i)])) for i in sel_idx]
    return _pack_plans(locals_xy, plans, [int(i) for i in sel_idx],
                       [float(p) for p in pk],
                       chunk_width=cfg.cohort_vmap_width,
                       client_multiple=client_multiple)


def pack_feature_pass(x: np.ndarray, y: np.ndarray, clients,
                      chunk_width: int = 4,
                      cache: Optional[HostPlanCache] = None
                      ) -> List[CohortBucket]:
    """Pack *all* clients for the clustering weight-feature pass: one
    in-order epoch per client (no shuffle), unit weights (features are
    returned per client, not aggregated)."""
    if cache is None:
        cache = HostPlanCache(x, y, clients, 1)
    locals_xy, plans = [], []
    for i in range(len(clients)):
        locals_xy.append(cache.local_data(i))
        plans.append(sequential_batch_plan(int(cache.sizes[i]),
                                           int(cache.bs[i])))
    ids = list(range(len(clients)))
    return _pack_plans(locals_xy, plans, ids, [1.0] * len(clients),
                       chunk_width=chunk_width)
