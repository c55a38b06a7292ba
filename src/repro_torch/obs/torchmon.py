"""PyTorch awareness: process-wide counters, counted host<->device
transfers, the synchronisation auditor and opt-in profiler capture (the
port's counterpart of the JAX package's ``obs/jaxmon.py``).

:data:`torch_stats` keeps the JAX package's counter API (``note_trace``,
``note_shape``, ``note_transfer``, ``snapshot``, ``delta``, ``reset``).
Shape-cache bookkeeping (``sim/engine.CohortEngine``) calls
``note_shape``, and :func:`device_put` / :func:`device_get` count the
explicit transfers by direction, bytes and calls.  Eager PyTorch traces
nothing, so ``note_trace`` has no call site until the port compiles a
program.  At each flush the counters, when they moved, become one event
of kind ``"jax_stats"``: that kind name belongs to the event stream,
whose schema (``obs/schema.py`` and the JAX package's) accepts no other,
not to the library.

The **sync auditor** (:func:`sync_audit`) runs a region under
``torch.cuda.set_sync_debug_mode("error")``: an operation that
synchronises the host with the card (``.item()``, ``nonzero``,
boolean-mask indexing, a blocking copy from pageable memory) raises.
:func:`device_put` and :func:`device_get`, the transfers the round loop
makes on purpose, set the mode to ``"default"`` for their own copy, so
they stay legal: the JAX package's split between explicit and implicit
transfers.  The mode is process-global, and PyTorch warns that it "does
not yet detect all synchronizing operations".  Without CUDA the mode is
only booked (:func:`sync_debug_mode`), and nothing is checked.
"""
from __future__ import annotations

import contextlib
import os
import threading
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.obs.registry import OBS

_MODES = {"default": 0, "warn": 1, "error": 2}


class TorchStats:
    """Process-wide shape / transfer counters (thread-safe)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counters: Dict[str, int] = {}
        self._last_emitted: Dict[str, int] = {}

    def _inc(self, name: str, by: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + by

    def note_trace(self, what: str = "compile") -> None:
        """For a compiled program's trace; eager PyTorch has none."""
        self._inc("traces")
        self._inc(f"traces/{what}")

    def note_shape(self, hit: bool) -> None:
        self._inc("shape_hits" if hit else "shape_misses")

    def note_transfer(self, direction: str, nbytes: int,
                      calls: int = 1) -> None:
        """``direction`` is 'h2d' or 'd2h' (explicit, counted wrappers)."""
        self._inc(f"{direction}_bytes", nbytes)
        self._inc(f"{direction}_calls", calls)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.counters)

    def delta(self, since: Dict[str, int]) -> Dict[str, int]:
        """Counter movement since a :meth:`snapshot` (only nonzero keys)."""
        snap = self.snapshot()
        keys = set(snap) | set(since)
        return {k: snap.get(k, 0) - since.get(k, 0) for k in keys
                if snap.get(k, 0) != since.get(k, 0)}

    def reset(self) -> None:
        with self._lock:
            self.counters.clear()
            self._last_emitted.clear()


torch_stats = TorchStats()


def _emit_stats() -> None:
    """Flush hook: one ``jax_stats`` event per flush iff counters moved."""
    snap = torch_stats.snapshot()
    if snap and snap != torch_stats._last_emitted:
        torch_stats._last_emitted = snap
        OBS.event("jax_stats", **snap)


OBS.add_flush_hook(_emit_stats)

# the mode last set through this module: the process's mode without CUDA
_BOOKED = {"mode": 0}


def sync_debug_mode() -> int:
    """The sync debug mode in force (0 default, 1 warn, 2 error)."""
    if torch.cuda.is_available():
        return torch.cuda.get_sync_debug_mode()
    return _BOOKED["mode"]


def _set_mode(mode: int) -> None:
    _BOOKED["mode"] = mode
    if torch.cuda.is_available():
        torch.cuda.set_sync_debug_mode(mode)


@contextlib.contextmanager
def _debug_mode(mode: int):
    prev = sync_debug_mode()
    _set_mode(mode)
    try:
        yield
    finally:
        _set_mode(prev)


def _map(fn, tree):
    """``fn`` over the leaves of a tree of dicts, lists and tuples (None
    stays None)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def device_put(tree: Any, device):
    """Counted explicit host->device transfer of a tree of numpy arrays,
    numpy or Python scalars and tensors: each leaf becomes a tensor on
    ``device``.  Host arrays go through pinned memory and copy without
    blocking the host, as ``jax.device_put`` does."""
    device = torch.device(device)
    moved = [0]

    def host(x) -> torch.Tensor:
        a = np.asarray(x)
        if not (a.flags.c_contiguous and a.flags.writeable):
            a = a.copy()
        return torch.from_numpy(a)

    def put(x):
        t = x if isinstance(x, torch.Tensor) else host(x)
        if t.device == device:
            return t
        moved[0] += t.numel() * t.element_size()
        if device.type == "cuda" and t.device.type == "cpu":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    with _debug_mode(0):
        out = _map(put, tree)
    torch_stats.note_transfer("h2d", moved[0])
    return out


def device_get(tree: Any):
    """Counted explicit device->host transfer of a tree of tensors: every
    leaf comes back as a numpy array, the card's copies queued together
    and waited for once.  Bytes are tallied from the host buffers."""
    with _debug_mode(0):
        host = _map(lambda t: t.to("cpu", non_blocking=True)
                    if isinstance(t, torch.Tensor) else t, tree)
        if torch.cuda.is_initialized():
            torch.cuda.current_stream().synchronize()
    out = _map(lambda t: t.numpy() if isinstance(t, torch.Tensor)
               else np.asarray(t), host)
    nbytes = [0]
    _map(lambda a: nbytes.__setitem__(0, nbytes[0] + a.nbytes), out)
    torch_stats.note_transfer("d2h", nbytes[0])
    return out


@contextlib.contextmanager
def sync_audit(mode: str = "error"):
    """Run a region under ``torch.cuda.set_sync_debug_mode(mode)``, the
    previous mode restored on exit.  Wrap warm round dispatches:

        with obs.sync_audit():
            server._dispatch_round(t, eval_now)

    An implicit synchronisation raises a RuntimeError at the offending
    op; :func:`device_put` / :func:`device_get` stay legal."""
    with _debug_mode(_MODES[mode]):
        yield


@contextlib.contextmanager
def maybe_profile(profile_dir):
    """Opt-in ``torch.profiler`` capture (``--profile-dir``): a no-op
    when ``profile_dir`` is falsy, otherwise the region's CPU ops (and
    the card's kernels, where there is one) land in a Chrome trace
    ``trace.<pid>.json`` in that directory."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(
        os.path.join(str(profile_dir), f"trace.{os.getpid()}.json"))
