"""Non-IID + imbalanced federated partitioning (paper §V-A).

  * Non-IID level nu: a fraction nu of each client's samples carries the
    client's primary label; the remainder is drawn uniformly from the global
    pool. nu in {1, 0.8, 0.5} in the paper's experiments.
  * Imbalance: the local size of client i is uniform in
    [varpi * imbalance_low, varpi * imbalance_high] where varpi is the
    per-client average (paper: [varpi/6, 2*varpi], e.g. 100..1200 for 100
    clients on MNIST).
  * Per-client split 80/10/10 train/val/test.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from repro_torch.configs.base import FLConfig


@dataclass
class ClientData:
    """Index-based view into the global pool."""

    train_idx: np.ndarray
    val_idx: np.ndarray
    test_idx: np.ndarray
    primary_label: int

    @property
    def size(self) -> int:
        return len(self.train_idx)


def partition_clients(y: np.ndarray, cfg: FLConfig,
                      seed: int = 0) -> List[ClientData]:
    """Partition a global pool with labels y into cfg.num_clients clients."""
    rng = np.random.default_rng(seed)
    n_global = len(y)
    nc = cfg.num_classes
    by_label = [np.nonzero(y == c)[0] for c in range(nc)]
    varpi = n_global // cfg.num_clients

    lo = max(int(varpi * cfg.imbalance_low), 10)
    hi = max(int(varpi * cfg.imbalance_high), lo + 1)

    clients = []
    for i in range(cfg.num_clients):
        primary = i % nc
        size = int(rng.integers(lo, hi + 1))
        n_primary = int(round(cfg.non_iid_level * size))
        idx_p = rng.choice(by_label[primary], n_primary,
                           replace=len(by_label[primary]) < n_primary)
        idx_r = rng.choice(n_global, size - n_primary, replace=False) \
            if size > n_primary else np.empty((0,), np.int64)
        idx = np.concatenate([idx_p, idx_r])
        rng.shuffle(idx)
        n_tr = int(0.8 * size)
        n_va = int(0.1 * size)
        clients.append(ClientData(
            train_idx=idx[:n_tr],
            val_idx=idx[n_tr:n_tr + n_va],
            test_idx=idx[n_tr + n_va:],
            primary_label=primary,
        ))
    return clients


def client_label_histograms(y: np.ndarray, clients: List[ClientData],
                            num_classes: int) -> np.ndarray:
    h = np.zeros((len(clients), num_classes))
    for i, c in enumerate(clients):
        lab, cnt = np.unique(y[c.train_idx], return_counts=True)
        h[i, lab] = cnt
        h[i] /= max(h[i].sum(), 1)
    return h


def global_histogram(y: np.ndarray, num_classes: int) -> np.ndarray:
    h = np.bincount(y, minlength=num_classes).astype(np.float64)
    return h / h.sum()
