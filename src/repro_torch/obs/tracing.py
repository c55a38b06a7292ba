"""Lightweight span tracing for the round pipeline.

``span("round/dispatch", round=t)`` is a context manager that records a
``{"kind": "span", name, id, parent, depth, t0, dur_s, **meta}`` event on
exit.  Spans nest through a thread-local stack (each thread traces its
own tree), use the monotonic clock (registry epoch), and are safe to
leave in hot paths: the cost is two ``perf_counter`` reads, one add into
:data:`SPANS` and, with a sink attached, one buffered dict append at
exit — no I/O, no device sync.

:data:`SPANS` keeps the total host seconds per span name whether or not
a sink is attached (``chip_smoke.py`` and ``PERF.md`` read the stage-1
spans from it).  A span reads only the host clock, so on the card it
measures the host time to enqueue its block's work.  The stage-1 spans
(``run/cluster``, ``cluster/features``, ``cluster/project``,
``cluster/kmeans``) end with an explicit ``device.synchronize``, so
theirs include the device work they queued.

The server records *dispatch* spans (``round/dispatch`` and its
children) separately from *drain* spans (``round/drain``): a dispatch
span measures only the host time to enqueue the round's work, so the
pipeline's device/host overlap shows up as dispatch spans much shorter
than the wall time between drains instead of being averaged away.
"""
from __future__ import annotations

import itertools
import threading
from collections import defaultdict
from typing import Dict

from repro_torch.obs.registry import OBS, now

SPANS: Dict[str, float] = defaultdict(float)

_ids = itertools.count(1)
_tls = threading.local()


class _TimedSpan:
    """The span while no sink is attached: it only adds its host seconds
    into :data:`SPANS`."""

    __slots__ = ("name", "t0")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = now()
        return self

    def __exit__(self, *exc):
        SPANS[self.name] += now() - self.t0
        return False


class _Span:
    __slots__ = ("name", "meta", "t0", "sid", "parent")

    def __init__(self, name, meta):
        self.name = name
        self.meta = meta

    def __enter__(self):
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        self.parent = stack[-1].sid if stack else None
        self.sid = next(_ids)
        stack.append(self)
        self.t0 = now()
        return self

    def __exit__(self, *exc):
        t1 = now()
        SPANS[self.name] += t1 - self.t0
        stack = _tls.stack
        depth = len(stack) - 1
        if stack and stack[-1] is self:
            stack.pop()
        OBS.event("span", name=self.name, id=self.sid, parent=self.parent,
                  depth=depth, t0=round(self.t0, 6),
                  dur_s=round(t1 - self.t0, 6), **self.meta)
        return False


_RESERVED = frozenset(("kind", "ts", "name", "id", "parent", "depth",
                       "t0", "dur_s"))


def span(name: str, **meta):
    """Open a span; while obs is disabled it only times the block into
    :data:`SPANS`.  ``meta`` must be JSON-serializable host scalars; keys
    clashing with the span schema fields are prefixed ``meta_``."""
    if not OBS.enabled:
        return _TimedSpan(name)
    if _RESERVED & meta.keys():
        meta = {(f"meta_{k}" if k in _RESERVED else k): v
                for k, v in meta.items()}
    return _Span(name, meta)
