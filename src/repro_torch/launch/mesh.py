"""Mesh builders (``repro.launch.mesh``).

The cohort mesh: the devices over which the ``sharded`` runtime, and the
``device`` runtime on more than one device, split each cohort's client
axis.  One process drives every local device, as JAX's single controller
does: the mesh is a tuple of ``torch.device``s, and the engine queues
each shard's work on its own device (repro_torch.sim.engine).  Its one
axis that splits anything is ``data`` (the client axis); ``model`` has
size 1, as in the JAX cohort mesh.  A device may appear more than once:
each entry is one shard, so a mesh of one card listed four times splits
a cohort four ways on that card.

The production mesh of the dry run (``launch.dryrun``) is a
``DeviceMesh`` over a *fake* process group of 256 or 512 ranks, this
process being rank 0: DTensors placed on it carry the production
shardings while every collective is recorded and none is sent.
Built by a FUNCTION (never a module-level constant), so importing this
module starts no process group, as JAX's keeps device state untouched.
Mesh semantics (DESIGN.md §5):
  * ``data``  — FSDP + batch parallelism (16-way per pod)
  * ``model`` — tensor/expert parallelism (16-way)
  * ``pod``   — federated cohorts: parameters replicated across pods, one
    cross-pod all-reduce per FL aggregation round.

The roofline constants below are an NVIDIA H100 SXM's, per card.  A
256-card mesh spans several hosts, whose cards talk over the network,
slower than NVLink, so the collective term they give is a floor.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from repro_torch.device import canonical_device


@dataclass(frozen=True)
class CohortMesh:
    """One shard of the ``data`` axis per entry of ``devices``; the first
    entry is the runtime's own device, where shard results are reduced."""

    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a cohort mesh needs at least one device")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis sizes by name, as a JAX mesh's ``shape``."""
        return {"data": len(self.devices), "model": 1}


def make_debug_mesh(device="cuda") -> CohortMesh:
    """The 1-device mesh: every sharded function runs unchanged on
    ``device`` alone."""
    return CohortMesh((canonical_device(device),))


def make_cohort_mesh(num_devices: int = 0, device="cuda") -> CohortMesh:
    """The mesh of ``--runtime sharded`` (and of ``device`` on several
    cards).  ``num_devices`` caps the data axis (0 = every local card):
    ``device`` first, then the other local CUDA devices in index order.
    A CPU ``device``, or fewer than 2 devices, gives the 1-device mesh."""
    first = canonical_device(device)
    if first.type != "cuda":
        return make_debug_mesh(first)
    n_avail = torch.cuda.device_count()
    n = min(num_devices, n_avail) if num_devices > 0 else n_avail
    if n <= 1:
        return make_debug_mesh(first)
    others = [torch.device("cuda", i) for i in range(n_avail)
              if i != first.index]
    return CohortMesh((first, *others[:n - 1]))


# ----------------------------------------------------------------------
# the production mesh of the dry run
# ----------------------------------------------------------------------

def _fake_group(world_size: int) -> None:
    """Make the default process group a fake one of ``world_size`` ranks,
    this process rank 0 (torch.testing's FakeStore backend: collectives
    return at once, and move nothing).  A fake group of another size is
    replaced; a real one is refused."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run's mesh needs a fake process "
                               "group, and a real one is running")
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def fake_mesh(shape, axes, device="cuda"):
    """A ``DeviceMesh`` of ``shape`` with axis names ``axes`` over a fake
    process group of prod(shape) ranks (started if none of that size
    runs).  ``device`` names the device type of the fake tensors placed
    on it; cuda without a GPU raises, as everywhere in the port."""
    from torch.distributed.device_mesh import DeviceMesh
    dev = canonical_device(device)
    n = 1
    for d in shape:
        n *= d
    _fake_group(n)
    return DeviceMesh(dev.type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """(16, 16) over (data, model), or (2, 16, 16) over (pod, data,
    model) with ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return fake_mesh(shape, axes, device)


# NVIDIA H100 SXM constants for the roofline model (per card), from the
# H100 datasheet (NVIDIA, "H100 Tensor Core GPU", SXM column).
PEAK_FLOPS_BF16 = 989.4e12      # FLOP/s, dense bf16 tensor cores
HBM_BW = 3.35e12                # bytes/s, HBM3
NVLINK_BW = 450e9               # bytes/s a direction, NVLink 4 (900 GB/s
#                                 both ways); a floor across hosts
HBM_PER_CARD = 80 * 10**9       # 80 GB
