"""Cohort sharding rules (``repro.sharding.rules``' cohort part): for
each argument of the engine's round-training functions, whether it is
replicated on every shard or split on axis 0 over the mesh's ``data``
axis (repro_torch.launch.mesh).

Stage-3 local training is pure data parallelism over the cohort: the
packed bucket tensors (xb, yb, step_mask, weights, each with a leading
client axis) split over ``data``, the global params are replicated in,
and the shards' float32 FedAvg partials are summed into the aggregate.
The packer pads the client axis to a multiple of the data-axis size
(weight-0 rows), so the split is always even.

A spec is :data:`REPLICATED` or :data:`DATA`.  :func:`shard_of` applies
one: a replicated argument comes as one entry per shard (each on its
shard's device), a split one as a whole array whose axis 0 is cut into
contiguous blocks.  The LM parameter, cache and batch rules of the dry
run are not part of the port.
"""
from __future__ import annotations

from typing import Tuple

REPLICATED = "replicated"
DATA = "data"


def cohort_param_spec() -> str:
    """Global params in, aggregated params out: replicated."""
    return REPLICATED


def cohort_bucket_specs() -> Tuple[str, ...]:
    """(xb, yb, step_mask, weights): client axis over ``data``."""
    return (DATA, DATA, DATA, DATA)


def cohort_stacked_spec() -> str:
    """Per-client stacked outputs keep their leading client axis on
    ``data``."""
    return DATA


def fleet_class_specs() -> Tuple[str, ...]:
    """The ``device`` runtime's ``(class_x, class_y, rows, plans,
    step_mask, weights)``: the class store is replicated (every shard
    gathers its own winners' rows out of the whole store), the
    per-invocation index and weight arrays split their client axis over
    ``data`` (the store pads every tier to a multiple of the data-axis
    size)."""
    return (REPLICATED, REPLICATED, DATA, DATA, DATA, DATA)


def shard_of(spec: str, value, shard: int, shards: int):
    """Shard ``shard`` of ``shards``'s part of ``value`` under ``spec``.
    REPLICATED: ``value`` holds one entry per shard, and the shard's is
    taken.  DATA: rows ``[shard * c / shards, (shard + 1) * c / shards)``
    of axis 0 (a view, for numpy arrays and tensors alike)."""
    if spec == REPLICATED:
        return value[shard]
    if spec != DATA:
        raise ValueError(f"unknown cohort sharding spec {spec!r}")
    c = value.shape[0]
    if c % shards:
        raise ValueError(f"client axis of {c} rows does not split into "
                         f"{shards} equal shards")
    n = c // shards
    return value[shard * n:(shard + 1) * n]
