"""Event sinks: a JSONL stream plus ``BENCH_*.json`` snapshot artifacts,
copied from the reference's ``obs/sink.py`` (it uses no framework).

- :class:`JsonlSink` — the raw event stream (span close events, ad-hoc
  events, periodic metric dumps), one JSON object per line, flushed per
  write so a crashed run keeps everything up to the crash.
- :func:`write_snapshot` — one aggregated JSON document per run, written
  atomically so a reader never sees a torn file.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Optional


def _jsonable(o: Any):
    """Best-effort JSON coercion for numpy scalars, 0-d tensors and odd
    leaves."""
    if hasattr(o, "item"):
        try:
            return o.item()
        except Exception:
            pass
    if hasattr(o, "tolist"):
        try:
            return o.tolist()
        except Exception:
            pass
    return str(o)


class NullSink:
    """Metrics-off sink: accepts writes, keeps nothing."""

    path: Optional[str] = None

    def write(self, event: Dict[str, Any]) -> None:
        return None

    def close(self) -> None:
        return None


class JsonlSink:
    """Append-only JSONL event stream (thread-safe, flushed per line)."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._lock = threading.Lock()
        self._f = open(self.path, "a")

    def write(self, event: Dict[str, Any]) -> None:
        line = json.dumps(event, default=_jsonable)
        with self._lock:
            if self._f.closed:
                return
            self._f.write(line + "\n")
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()


def write_snapshot(path: str, payload: Dict[str, Any]) -> str:
    """Atomically write one snapshot document (tmp file + rename)."""
    path = os.path.abspath(path)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1, default=_jsonable, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


def read_jsonl(path: str):
    """Parse a JSONL event stream back into a list of dicts (tests,
    report tooling)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
