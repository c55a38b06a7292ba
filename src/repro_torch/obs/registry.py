"""Structured metrics registry: counters, gauges, per-round scalar
series and free-form events, buffered host-side and flushed to pluggable
sinks only at the caller's logging boundaries.

The registry is the process-wide singleton :data:`OBS`.  Everything is a
no-op while no sink is attached (``OBS.enabled`` is False — the default),
so instrumented hot paths pay one attribute load + branch; with sinks the
cost per record is a dict append to a host-side buffer.  Nothing here
imports torch and nothing ever touches device values: callers hand the
registry plain Python scalars they already fetched at their own sync
points, which is what keeps instrumentation from perturbing the round
pipeline (no extra blocking fetches, no changed dispatch order —
asserted by tests/test_torch_obs.py).

Event stream shape (one dict per event; the JSONL sink writes one per
line, schema in :mod:`repro_torch.obs.schema`):

  {"kind": "round", "ts": ..., "round": t, "test_acc": ..., ...}
  {"kind": "span",  "ts": ..., "name": "round/dispatch", "id": 7,
   "parent": 5, "depth": 1, "t0": ..., "dur_s": ...}
  {"kind": "counter" | "gauge", "ts": ..., "name": ..., "value": ...}
  {"kind": "jax_stats", "ts": ..., <repro_torch.obs.torchmon counters>}
  {"kind": "log",   "ts": ..., "msg": ...}
  {"kind": "meta",  "ts": ..., <run header: argv, wall epoch, ...>}

``ts``/``t0`` are monotonic seconds since the registry's process epoch
(``time.perf_counter`` based — immune to wall-clock steps); the ``meta``
header records the wall-clock epoch for absolute-time reconstruction.
"""
from __future__ import annotations

import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional

_EPOCH_WALL = time.time()
_EPOCH_MONO = time.perf_counter()


def now() -> float:
    """Monotonic seconds since the obs epoch (process start)."""
    return time.perf_counter() - _EPOCH_MONO


class Observability:
    """The metrics registry + event buffer.  Thread-safe; cheap when
    disabled (every record method returns after one branch)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._sinks: List[Any] = []
        self._buffer: List[Dict[str, Any]] = []
        self._flush_hooks: List[Callable[[], None]] = []
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self._dirty_counters: set = set()
        self.quiet = False

    # -- lifecycle -----------------------------------------------------
    @property
    def enabled(self) -> bool:
        return bool(self._sinks)

    def add_sink(self, sink) -> None:
        with self._lock:
            self._sinks.append(sink)

    def add_flush_hook(self, hook: Callable[[], None]) -> None:
        """Hooks run at the start of every flush (while recording is
        still buffered) — e.g. torchmon snapshots its counters here."""
        with self._lock:
            if hook not in self._flush_hooks:
                self._flush_hooks.append(hook)

    def configure(self, jsonl: Optional[str] = None,
                  csv: Optional[str] = None, memory: bool = False,
                  quiet: Optional[bool] = None):
        """Attach sinks from CLI-style options.  Returns the MemorySink
        when ``memory`` is requested (tests read its ``events``)."""
        from repro_torch.obs.sinks import CsvSink, JsonlSink, MemorySink
        mem = None
        with self._lock:
            if jsonl:
                self.add_sink(JsonlSink(jsonl))
            if csv:
                self.add_sink(CsvSink(csv))
            if memory:
                mem = MemorySink()
                self.add_sink(mem)
            if quiet is not None:
                self.quiet = quiet
            if self._sinks:
                self.event("meta", wall_epoch=_EPOCH_WALL,
                           argv=list(sys.argv))
        return mem

    @property
    def sinks(self) -> tuple:
        return tuple(self._sinks)

    def close_sinks(self, keep=()) -> None:
        """Flush, then close and detach every sink not in ``keep`` (an
        entry point detaches the sinks it attached, so a later run in
        the same process does not write into its files)."""
        with self._lock:
            self.flush()
            for s in [s for s in self._sinks if s not in keep]:
                close = getattr(s, "close", None)
                if close:
                    close()
                self._sinks.remove(s)

    def reset(self) -> None:
        """Close sinks and drop all state (tests; start-of-run)."""
        with self._lock:
            self.flush()
            for s in self._sinks:
                close = getattr(s, "close", None)
                if close:
                    close()
            self._sinks.clear()
            self._buffer.clear()
            self.counters.clear()
            self.gauges.clear()
            self._dirty_counters.clear()
            self.quiet = False

    # -- recording (buffered; never blocks on device values) ----------
    def event(self, kind: str, **fields) -> None:
        if not self._sinks:
            return
        e = {"kind": kind, "ts": round(now(), 6)}
        e.update(fields)
        with self._lock:
            self._buffer.append(e)

    def counter(self, name: str, inc: float = 1) -> None:
        """Cumulative counter; current values are emitted as events at
        the next flush (not per increment — increments are hot)."""
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + inc
            if self._sinks:
                self._dirty_counters.add(name)

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self.gauges[name] = value
        self.event("gauge", name=name, value=value)

    def record_round(self, round: int, **scalars) -> None:
        """One per-round series row (acc/loss/E_std/mean_bid/vds_gap...).
        Callers pass host floats they already own."""
        self.event("round", round=int(round), **scalars)

    def log(self, msg: str, always: bool = False) -> None:
        """Structured stdout logger: prints ``msg`` verbatim (byte-
        compatible with the bare ``print`` it replaces) unless quiet, and
        mirrors it into the event stream when sinks are attached.
        ``always=True`` marks a result line (the command's primary
        output, e.g. ``final acc=...``) that ``--quiet`` must not
        swallow — quiet silences progress, not answers."""
        if always or not self.quiet:
            print(msg, flush=True)
        self.event("log", msg=msg)

    # -- flushing (the logging boundary) -------------------------------
    def flush(self) -> None:
        """Push the buffered events to every sink.  Called only at the
        system's own logging boundaries (metric drains, end of run) so
        sink I/O never lands inside the round loop's dispatch window."""
        if not self._sinks:
            return
        with self._lock:
            for hook in self._flush_hooks:
                hook()
            for name in sorted(self._dirty_counters):
                self._buffer.append({"kind": "counter",
                                     "ts": round(now(), 6), "name": name,
                                     "value": self.counters[name]})
            self._dirty_counters.clear()
            if not self._buffer:
                return
            batch, self._buffer = self._buffer, []
            for s in self._sinks:
                s.emit(batch)


OBS = Observability()
