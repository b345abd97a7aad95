"""repro_torch.obs — session-wide telemetry: metrics, spans, snapshots,
ported from the reference's ``repro.obs``.

- :mod:`repro_torch.obs.metrics` — thread-safe counters / gauges /
  fixed-bucket histograms with p50/p99 summaries (a copy),
- :mod:`repro_torch.obs.trace` — nestable :class:`Span` context managers
  (host phases time directly; device work registers outputs via
  ``Span.block`` so the span closes after ``torch.cuda.synchronize``),
- :mod:`repro_torch.obs.sink` — the JSONL event stream + atomic
  ``BENCH_*.json`` snapshot writer (a copy),
- :mod:`repro_torch.obs.report` — the predicted-vs-measured drift report
  (the planner's step time and the memory model's peak against the
  measured ones; ``python -m repro_torch.obs.report`` gates on it).

The :class:`Obs` facade bundles one registry + tracer + sink;
:data:`NULL` is the disabled singleton every instrumented call site
defaults to, so with metrics off the hot paths see cheap no-ops, no span
synchronizes a card, and numerics and output are unchanged.  Code that
runs far from a :class:`~repro_torch.api.Session` handle (e.g.
``comms.sync_tree``) reads the process-wide active instance via
:func:`get_active`.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

from .metrics import (Counter, Gauge, Histogram,  # noqa: F401 (re-export)
                      MetricRegistry)
from .sink import JsonlSink, NullSink, read_jsonl, write_snapshot
from .trace import NULL_SPAN, Span, Tracer

__all__ = [
    "Obs", "NULL", "get_active", "set_active",
    "MetricRegistry", "Counter", "Gauge", "Histogram",
    "Tracer", "Span", "NULL_SPAN",
    "JsonlSink", "NullSink", "read_jsonl", "write_snapshot",
]


class Obs:
    """One registry + tracer + sink, the unit a Session (or CLI) owns.

    ``jsonl=None`` keeps the metrics/spans in memory (summaries and
    snapshots still work) without writing a stream.
    """

    enabled: bool = True

    def __init__(self, jsonl: Optional[str] = None, name: str = "obs"):
        self.name = name
        self.metrics = MetricRegistry()
        self.sink = JsonlSink(jsonl) if jsonl else NullSink()
        self.tracer = Tracer(sink=self.sink, metrics=self.metrics)

    # -- the four verbs ----------------------------------------------------
    def span(self, name: str, **attrs) -> Span:
        return self.tracer.span(name, **attrs)

    def counter(self, name: str) -> Counter:
        return self.metrics.counter(name)

    def gauge(self, name: str) -> Gauge:
        return self.metrics.gauge(name)

    def histogram(self, name: str,
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self.metrics.histogram(name, buckets)

    def event(self, kind: str, **fields) -> None:
        """Ad-hoc structured event (watchdog anomaly, comms sync, ...).
        Reserved keys win a collision with ``fields``."""
        self.sink.write({**fields, "kind": kind, "t_wall": time.time()})

    # -- persistence -------------------------------------------------------
    def snapshot(self, path: Optional[str] = None, **meta) -> Dict:
        """Aggregate every metric into one document; append it to the
        JSONL stream and (with ``path``) write the ``BENCH_*.json``-style
        artifact atomically.  Returns the document."""
        snap = {"meta": {"name": self.name, "t_wall": time.time(), **meta},
                "metrics": self.metrics.summary()}
        self.sink.write({"kind": "metrics", **snap})
        if path:
            write_snapshot(path, snap)
        return snap

    def close(self) -> None:
        self.sink.close()


class _NullMetric:
    """No-op counter/gauge/histogram for the disabled singleton."""

    __slots__ = ()
    value = 0

    def inc(self, n: int = 1) -> None:
        return None

    def set(self, v: float) -> None:
        return None

    def observe(self, v: float) -> None:
        return None

    def summary(self) -> Dict:
        return {"count": 0}

    def percentile(self, q: float):
        return None


_NULL_METRIC = _NullMetric()


class _NullObs(Obs):
    """Metrics-off: every verb is a no-op (guard hot-path extras — timing
    syscalls, ``torch.cuda.synchronize`` — behind ``obs.enabled``)."""

    enabled = False

    def __init__(self):
        super().__init__(jsonl=None, name="null")

    def span(self, name: str, **attrs):
        return NULL_SPAN

    def counter(self, name: str):
        return _NULL_METRIC

    def gauge(self, name: str):
        return _NULL_METRIC

    def histogram(self, name: str, buckets=None):
        return _NULL_METRIC

    def event(self, kind: str, **fields) -> None:
        return None

    def snapshot(self, path: Optional[str] = None, **meta) -> Dict:
        return {"meta": {"name": self.name}, "metrics": {}}


#: The disabled singleton — default for every instrumented call site.
NULL = _NullObs()

_ACTIVE: Obs = NULL


def get_active() -> Obs:
    """The process-wide active Obs (NULL unless a CLI/test opted in).

    For instrumentation sites without a Session handle — e.g. the wire
    counters of ``comms.sync_tree``."""
    return _ACTIVE


def set_active(obs: Optional[Obs]) -> Obs:
    """Install ``obs`` (None -> NULL) as the active instance; returns the
    previous one so callers can restore it in a finally block."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = obs if obs is not None else NULL
    return prev
