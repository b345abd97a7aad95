"""The disabled telemetry surface the serve engines touch.

Only the no-op :data:`NULL` singleton of the reference's ``repro.obs`` is
ported here (``enabled``, ``counter().inc``, ``histogram().observe``,
``gauge().set``); the metrics registry, spans and sinks come with the
host-services slice.
"""

from __future__ import annotations


class _NullMetric:
    """No-op counter/gauge/histogram."""

    __slots__ = ()
    value = 0

    def inc(self, n: int = 1) -> None:
        return None

    def set(self, v: float) -> None:
        return None

    def observe(self, v: float) -> None:
        return None


_NULL_METRIC = _NullMetric()


class _NullObs:
    enabled = False

    def counter(self, name: str) -> _NullMetric:
        return _NULL_METRIC

    def gauge(self, name: str) -> _NullMetric:
        return _NULL_METRIC

    def histogram(self, name: str, buckets=None) -> _NullMetric:
        return _NULL_METRIC


NULL = _NullObs()

__all__ = ["NULL"]
