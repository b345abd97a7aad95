"""Thread-safe metric registry: counters, gauges, fixed-bucket histograms,
copied from the reference's ``obs/metrics.py`` (it uses no framework).

The hot paths record *data* (counters of wire bytes, gauges of resident
bytes, latency histograms with p50/p99 summaries) instead of log lines,
and :func:`MetricRegistry.summary` is what lands in the ``BENCH_*.json``
snapshots (see :mod:`repro_torch.obs.sink`).

All three metric kinds share one registry lock — contention is irrelevant
at the rates the instrumentation produces (per step / per engine tick,
never per element), and a single lock keeps ``summary()`` a consistent
snapshot across kinds.
"""

from __future__ import annotations

import bisect
import math
import threading
from typing import Dict, Optional, Sequence, Tuple

#: Default histogram bucket upper bounds (seconds): 1-2-5 decades from
#: 1 us to 500 s — wide enough for a CPU-simulator compile and a real
#: device decode tick alike.  An implicit overflow bucket catches the
#: rest; percentile estimates there fall back to the observed max.
DEFAULT_BUCKETS: Tuple[float, ...] = tuple(
    m * 10.0 ** e for e in range(-6, 3) for m in (1.0, 2.0, 5.0))


class Counter:
    """Monotonic counter (wire bytes, cache hits, tokens)."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str, lock: threading.RLock):
        self.name = name
        self.value = 0
        self._lock = lock

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """Last-write-wins scalar (resident bytes, measured bubble fraction)."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str, lock: threading.RLock):
        self.name = name
        self.value: float = 0.0
        self._lock = lock

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)


class Histogram:
    """Fixed-bucket histogram with p50/p99 summaries.

    Buckets are upper bounds (ascending); an implicit overflow bucket
    holds everything above the last bound.  Percentiles are linearly
    interpolated *within* the bucket where the cumulative count crosses
    the quantile, then clamped to the exact observed min/max.  (Returning
    the raw bucket boundary — the old behavior — quantizes every p50 to a
    1-2-5 edge: eight ~0.17 s steps reported p50 == 0.2 exactly, which
    the drift report then scored as model error.)
    """

    __slots__ = ("name", "buckets", "counts", "count", "sum", "min", "max",
                 "_lock")

    def __init__(self, name: str, lock: threading.RLock,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.name = name
        self.buckets: Tuple[float, ...] = tuple(sorted(float(b)
                                                       for b in buckets))
        if not self.buckets:
            raise ValueError(f"histogram {name!r} needs >= 1 bucket bound")
        self.counts = [0] * (len(self.buckets) + 1)   # +1: overflow
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._lock = lock

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.counts[bisect.bisect_left(self.buckets, v)] += 1
            self.count += 1
            self.sum += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)

    def percentile(self, q: float) -> Optional[float]:
        """Within-bucket linear estimate of the q-quantile (q in [0, 1])."""
        with self._lock:
            if not self.count:
                return None
            target = q * self.count
            cum = 0
            for i, c in enumerate(self.counts):
                if not c:
                    continue
                if cum + c >= target:
                    if i >= len(self.buckets):      # overflow bucket
                        lo, hi = self.buckets[-1], self.max
                    elif i == 0:
                        lo, hi = min(0.0, self.min), self.buckets[0]
                    else:
                        lo, hi = self.buckets[i - 1], self.buckets[i]
                    frac = (target - cum) / c
                    v = lo + (hi - lo) * frac
                    return max(self.min, min(v, self.max))
                cum += c
            return self.max

    def summary(self) -> Dict[str, float]:
        with self._lock:
            if not self.count:
                return {"count": 0}
            return {
                "count": self.count,
                "sum": self.sum,
                "mean": self.sum / self.count,
                "min": self.min,
                "max": self.max,
                "p50": self.percentile(0.50),
                "p90": self.percentile(0.90),
                "p99": self.percentile(0.99),
            }


class MetricRegistry:
    """Get-or-create table of named metrics behind one lock.

    Re-requesting a name returns the SAME metric object (so call sites
    never coordinate creation); a histogram's bucket layout is fixed by
    the first request and later ``buckets=`` arguments are ignored.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name, self._lock)
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name, self._lock)
            return g

    def histogram(self, name: str,
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(
                    name, self._lock, buckets or DEFAULT_BUCKETS)
            return h

    def summary(self) -> Dict[str, Dict]:
        """One consistent snapshot of every metric (JSON-ready)."""
        with self._lock:
            return {
                "counters": {k: c.value
                             for k, c in sorted(self._counters.items())},
                "gauges": {k: g.value
                           for k, g in sorted(self._gauges.items())},
                "histograms": {k: h.summary()
                               for k, h in sorted(self._histograms.items())},
            }
