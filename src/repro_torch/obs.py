"""Minimal observability for the port: a progress logger and wall-clock
spans.  ``span`` times a block on the host's monotonic clock and keeps
the total per name in ``SPANS`` (seconds).  Once CUDA is in use it
synchronises the device when the block ends, so a span holds the device
work its block queued, not whatever a later span happens to wait for.
The event stream, sinks and schema of ``repro.obs`` are not ported yet
(ROADMAP.md, queue 1: observability)."""
from __future__ import annotations

import sys
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, Iterator

import torch

SPANS: Dict[str, float] = defaultdict(float)
_QUIET = {"on": False}


def configure(quiet: bool = False) -> None:
    _QUIET["on"] = bool(quiet)


def log(msg: str, always: bool = False) -> None:
    if always or not _QUIET["on"]:
        print(msg, file=sys.stdout, flush=True)


@contextmanager
def span(name: str) -> Iterator[None]:
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        SPANS[name] += time.perf_counter() - t0
