"""Event sinks for the metrics registry (repro_torch.obs.registry).

All sinks consume batches of event dicts at flush time; none are touched
from the hot path.  File sinks sanitize non-finite floats to ``null`` so
every line/row stays strictly-valid JSON/CSV (NaN is how the server logs
off-cadence eval rounds — see FederatedServer.run)."""
from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, List


def _sanitize(v: Any) -> Any:
    """Strict-JSON scalar: non-finite floats become None."""
    if isinstance(v, float) and not math.isfinite(v):
        return None
    return v


def sanitize_event(e: Dict[str, Any]) -> Dict[str, Any]:
    return {k: _sanitize(v) for k, v in e.items()}


class MemorySink:
    """In-memory sink for tests: ``events`` is the raw (unsanitized)
    event list in emission order."""

    def __init__(self):
        self.events: List[Dict[str, Any]] = []

    def emit(self, batch: List[Dict[str, Any]]) -> None:
        self.events.extend(batch)

    def close(self) -> None:
        pass


class JsonlSink:
    """One strict-JSON object per line (``--log-jsonl``).  The file is
    line-buffered only at flush boundaries: a flush writes its whole
    batch then fsync-free flushes the Python buffer, so a crashed run
    keeps every completed logging boundary."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "w")

    def emit(self, batch: List[Dict[str, Any]]) -> None:
        for e in batch:
            self._f.write(json.dumps(sanitize_event(e), sort_keys=False))
            self._f.write("\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class CsvSink:
    """Flat CSV (``--log-csv``): fixed columns for the common fields,
    everything else JSON-packed into ``extra`` so no event loses data."""

    COLUMNS = ("kind", "ts", "name", "round", "value", "t0", "dur_s",
               "id", "parent", "depth", "extra")

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "w")
        self._f.write(",".join(self.COLUMNS) + "\n")

    def emit(self, batch: List[Dict[str, Any]]) -> None:
        for raw in batch:
            e = sanitize_event(raw)
            extra = {k: v for k, v in e.items() if k not in self.COLUMNS}
            cells = []
            for col in self.COLUMNS[:-1]:
                v = e.get(col)
                cells.append("" if v is None else json.dumps(v))
            cells.append(json.dumps(json.dumps(extra)) if extra else "")
            self._f.write(",".join(cells) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()
