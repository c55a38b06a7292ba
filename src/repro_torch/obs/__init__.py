"""repro_torch.obs — round-pipeline telemetry, the port's counterpart of
the JAX package's ``repro.obs``.

Three layers:

  * **registry** — structured metrics (counters / gauges / per-round
    series / events) buffered host-side, flushed to pluggable sinks
    (JSONL, CSV, in-memory) only at the system's own logging boundaries;
  * **tracing** — nestable monotonic-clock spans
    (``obs.span("round/dispatch")``) cheap enough for the warm loop,
    recording dispatch and drain time separately, plus :data:`SPANS`,
    the total host seconds per span name;
  * **torchmon** — PyTorch awareness: process-wide counters
    (``obs.torch_stats``), counted explicit ``device_put``/``device_get``
    transfers, the ``set_sync_debug_mode``-based sync auditor
    (``obs.sync_audit``) and opt-in ``torch.profiler`` capture
    (``obs.maybe_profile``).

The invariant everything here is built around: instrumentation must not
perturb the system under test — no blocking fetches in the round loop,
bit-identical logs and near-zero overhead when disabled (no sink
attached).  Held by tests/test_torch_obs.py.
"""
from repro_torch.obs.registry import OBS, now
from repro_torch.obs.torchmon import (device_get, device_put,
                                      maybe_profile, sync_audit,
                                      torch_stats)
from repro_torch.obs.tracing import SPANS, span

__all__ = ["OBS", "now", "span", "SPANS", "torch_stats", "device_put",
           "device_get", "sync_audit", "maybe_profile", "configure",
           "flush", "log"]

# singleton conveniences (module-level functions so call sites read as
# ``obs.log(...)`` / ``obs.flush()``)
configure = OBS.configure
flush = OBS.flush
log = OBS.log
