"""The cohort mesh (``repro.launch.mesh``'s cohort part): the devices over
which the ``sharded`` runtime, and the ``device`` runtime on more than
one device, split each cohort's client axis.

One process drives every local device, as JAX's single controller does:
the mesh is a tuple of ``torch.device``s, and the engine queues each
shard's work on its own device (repro_torch.sim.engine).  Its one axis
that splits anything is ``data`` (the client axis); ``model`` has size 1,
as in the JAX cohort mesh.  The production mesh of the dry run and the
TPU constants are not part of the port.

A device may appear more than once: each entry is one shard, so a mesh
of one card listed four times splits a cohort four ways on that card.
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
