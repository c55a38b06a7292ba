"""FleetStore: the fleet's data resident on the device, in static
capacity classes.

The host-packed ``vectorized`` runtime builds padded ``(C, S, bs,
*feat)`` minibatch arrays on the host every round and copies each bucket
to the device, and its bucket shapes follow whichever clients won the
auction.  The ``device`` runtime replaces both:

* **Pack once.**  At init every client's local shard is gathered once
  into a per-class tensor ``(P, n_cap, *feat)`` on the runtime's device.
  A round's cohort is then an on-device ``index_select`` by winner rows;
  the host builds only small int tensors (winner rows and the local batch
  plans, i.e. the shuffle permutations, which stay on the host rng to
  match the sequential runtime bit for bit).
* **Static shapes.**  Class key = (batch size, pow2 band of total local
  steps), derived from the whole fleet; step capacity = the class's
  largest step count rounded up to a multiple of 4; client capacity = a
  pow2 **tier ladder** up to the per-round winner bound.  Every possible
  winner maps to a known class and every winner count to a known tier,
  so ``DeviceRuntime.warmup`` meets every shape the round loop can
  produce (``CohortEngine.stats`` counts none new afterwards); a class
  whose winners exceed its top tier runs the same shapes more than once
  (greedy largest-fitting-tier chunking).

Padding stays under 2x on both axes, as in the bucket packer; masked rows
carry weight 0 and drop out of the FedAvg sum exactly.  The JAX store's
``client_multiple`` (tiers rounded to the mesh's data-axis size) is not
ported: the port has no mesh yet (ROADMAP.md, queue 1).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import FLConfig
from repro_torch.core.selection import k_per_cluster
from repro_torch.device import resolve_device
from repro_torch.sim.cohort import HostPlanCache, _next_pow2, _round_up


@dataclass
class CapacityClass:
    """One static shape class of the fleet.

    ``x (P, n_cap, *feat)`` / ``y (P, n_cap)`` are the device-resident
    local shards of the class's ``P`` members, each padded to the class
    max size ``n_cap`` (plans never index the padding).  ``tiers`` is
    the ascending pow2 ladder of padded client-axis sizes an invocation
    may use.
    """

    bs: int
    step_cap: int            # padded step axis (multiple of 4)
    tiers: List[int]         # padded client-axis capacities (ascending)
    n_cap: int
    members: np.ndarray      # (P,) global client ids
    x: torch.Tensor
    y: torch.Tensor

    @property
    def client_cap(self) -> int:
        """Largest per-invocation client capacity (the top tier)."""
        return self.tiers[-1]


@dataclass
class ClassBatch:
    """One per-round invocation of a capacity class.

    ``rows (C_cap,)`` int32 rows into the class store (0 for padding —
    masked out), ``plans (C_cap, step_cap, bs)`` int32 local sample
    indices, ``step_mask (C_cap, step_cap)`` float32, ``weights (C_cap,)``
    float32 *global* FedAvg weights (over all invocations they sum to 1),
    ``client_idx (C_cap,)`` int32 global ids (-1 for padding).
    """

    cls_id: int
    rows: np.ndarray
    plans: np.ndarray
    step_mask: np.ndarray
    weights: np.ndarray
    client_idx: np.ndarray


class FleetStore:
    """Pack the whole fleet once; assemble cohorts as index arrays."""

    def __init__(self, x: np.ndarray, y: np.ndarray, clients,
                 cfg: FLConfig, cache: Optional[HostPlanCache] = None,
                 device="cuda"):
        device = resolve_device(device)
        self.cfg = cfg
        self.cache = cache if cache is not None \
            else HostPlanCache(x, y, clients, cfg.local_epochs)
        n = len(clients)
        total_steps = self.cache.steps * cfg.local_epochs
        self.class_of = np.full((n,), -1, np.int64)
        self.row_of = np.full((n,), -1, np.int64)

        groups: Dict[tuple, List[int]] = {}
        for i in range(n):
            if self.cache.sizes[i] == 0:     # no steps, no FedAvg mass
                continue
            key = (int(self.cache.bs[i]),
                   _next_pow2(max(int(total_steps[i]), 1)))
            groups.setdefault(key, []).append(i)

        # per-round winner bound: k_total overall, but per-cluster floors
        # can push the union above it (num_clusters x K_j)
        k_total = max(int(round(cfg.select_ratio * cfg.num_clients)), 1)
        k_bound = max(k_total, cfg.num_clusters * k_per_cluster(cfg))

        self.classes: List[CapacityClass] = []
        for (bs, _band), members in sorted(groups.items()):
            members = np.asarray(members, np.int64)
            n_cap = int(self.cache.sizes[members].max())
            step_cap = _round_up(int(total_steps[members].max()), 4)
            cap = min(len(members), k_bound)
            tiers, t = [], 1                 # pow2 ladder up to the bound
            while t < cap:
                tiers.append(t)
                t *= 2
            tiers = sorted(set(tiers + [cap]))
            xb = np.zeros((len(members), n_cap) + x.shape[1:], x.dtype)
            yb = np.zeros((len(members), n_cap), y.dtype)
            for r, gid in enumerate(members):
                xl, yl = self.cache.local_data(int(gid))
                xb[r, :len(xl)] = xl
                yb[r, :len(yl)] = yl
                self.class_of[gid] = len(self.classes)
                self.row_of[gid] = r
            xd, yd = obs.device_put((xb, yb), device)
            self.classes.append(CapacityClass(
                bs=bs, step_cap=step_cap, tiers=tiers, n_cap=n_cap,
                members=members, x=xd, y=yd))

    # ------------------------------------------------------------------
    def _empty_batch(self, cls_id: int, tier: int) -> ClassBatch:
        c = self.classes[cls_id]
        return ClassBatch(
            cls_id=cls_id,
            rows=np.zeros((tier,), np.int32),
            plans=np.zeros((tier, c.step_cap, c.bs), np.int32),
            step_mask=np.zeros((tier, c.step_cap), np.float32),
            weights=np.zeros((tier,), np.float32),
            client_idx=np.full((tier,), -1, np.int32))

    def warmup_batches(self) -> List[ClassBatch]:
        """One fully-masked invocation per (class, tier): every shape the
        round loop can ever produce (classes and tiers are static)."""
        return [self._empty_batch(i, t)
                for i, c in enumerate(self.classes) for t in c.tiers]

    def assemble(self, sel_idx: np.ndarray,
                 history: np.ndarray) -> List[ClassBatch]:
        """Index arrays for the round's winners.  ``history`` is the
        pre-round host participation mirror (it seeds the shuffles).
        Zero-size winners are dropped (same rule as the packers); an
        all-zero cohort assembles to [] — skip aggregation."""
        sel_idx = np.asarray(sel_idx)
        if sel_idx.size:
            sel_idx = sel_idx[self.cache.sizes[sel_idx] > 0]
        if sel_idx.size == 0:
            return []
        sizes = self.cache.sizes[sel_idx].astype(np.float64)
        pk = sizes / sizes.sum()

        by_cls: Dict[int, List[tuple]] = {}
        for i, p in zip(sel_idx, pk):
            by_cls.setdefault(int(self.class_of[int(i)]), []).append(
                (int(i), float(p)))

        out = []
        for cls_id, winners in sorted(by_cls.items()):
            c = self.classes[cls_id]
            lo = 0
            while lo < len(winners):
                rem = len(winners) - lo
                # greedy largest tier that the remainder fills; when even
                # the smallest tier is bigger, take it (padding < 2x rem)
                fits = [t for t in c.tiers if t <= rem]
                tier = fits[-1] if fits else c.tiers[0]
                chunk = winners[lo:lo + tier]
                lo += len(chunk)
                b = self._empty_batch(cls_id, tier)
                for r, (gid, p) in enumerate(chunk):
                    plan = self.cache.plan(gid, int(history[gid]))
                    s = plan.shape[0]
                    b.rows[r] = self.row_of[gid]
                    b.plans[r, :s] = plan
                    b.step_mask[r, :s] = 1.0
                    b.weights[r] = p
                    b.client_idx[r] = gid
                out.append(b)
        return out
