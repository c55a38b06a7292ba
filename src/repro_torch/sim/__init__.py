"""Cohort execution engine: batched local training for whole auction
cohorts, the port's counterpart of the JAX package's ``repro.sim``.

  * cohort.py  — packs the selected clients' shards into padded,
    size-bucketed minibatch tensors with per-step validity masks;
    ``HostPlanCache`` memoizes the per-client plans.
  * fleet.py   — ``FleetStore``: the whole fleet packed once into
    device-resident capacity-class tensors (the ``device`` runtime's
    data plane).
  * engine.py  — local SGD/FedProx epochs for a whole bucket or class,
    ``torch.func.vmap`` over clients, with the weighted aggregation
    fused in.
  * runtime.py — the ``CohortRuntime`` protocol and its four backends
    (``sequential``, ``vectorized``, ``sharded``, ``device``).
  * dynamics.py — the per-round fault model (availability churn,
    stragglers, deadline misses).
"""
from repro_torch.sim.cohort import (CohortBucket, HostPlanCache,
                                    pack_cohort, pack_feature_pass)
from repro_torch.sim.dynamics import (DynamicsState, dynamics_key,
                                      fault_step, init_dynamics,
                                      split_outcomes)
from repro_torch.sim.engine import CohortEngine
from repro_torch.sim.fleet import CapacityClass, ClassBatch, FleetStore
from repro_torch.sim.runtime import (CohortRuntime, DeviceRuntime,
                                     SequentialRuntime, ShardedRuntime,
                                     VectorizedRuntime, make_runtime)

__all__ = [
    "CohortBucket", "HostPlanCache", "pack_cohort", "pack_feature_pass",
    "CohortEngine",
    "CapacityClass", "ClassBatch", "FleetStore",
    "CohortRuntime", "DeviceRuntime", "SequentialRuntime",
    "ShardedRuntime", "VectorizedRuntime", "make_runtime",
    "DynamicsState", "dynamics_key", "fault_step", "init_dynamics",
    "split_outcomes",
]
