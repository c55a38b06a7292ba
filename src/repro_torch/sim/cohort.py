"""Cohort helpers shared by the stage-3 runtimes (host-side numpy).

The sequential runtime iterates, per client, ``local_epochs`` shuffled
passes of full minibatches of size ``bs = min(32, n)`` and drops the
remainder batch; the shuffle stream is
``np.random.default_rng(history * 977 + client_idx)``, as in the JAX
package, so both packages train on the same minibatches.  Cohort packing
for the batched runtimes is not ported yet (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import numpy as np


def drop_zero_size_winners(sel_idx: np.ndarray, clients) -> np.ndarray:
    """Winners with no local samples run no steps and carry no FedAvg
    mass — drop them before weighting."""
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
