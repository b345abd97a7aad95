"""Nestable span tracing for host phases and device work, ported from the
reference's ``obs/trace.py``.

A :class:`Span` is a context manager that times one phase (plan, build,
step, ...).  Spans nest: each thread keeps a stack, so a span opened
inside another records the outer span's id as its ``parent`` — the JSONL
trace events reconstruct the tree.  Kernels run asynchronously, so naive
host timing would time the launches only: register the step's outputs
with :meth:`Span.block` and the span closes after
``torch.cuda.synchronize`` on each card they lie on (the reference waits
on ``jax.block_until_ready``), so the recorded duration covers their
device work.  CPU tensors are ready when they are returned.  Only an
enabled Obs hands out real spans; the disabled one's :data:`NULL_SPAN`
never synchronizes.

Every closed span (a) appends a ``{"kind": "span", ...}`` event to the
tracer's sink and (b) observes its duration into the ``span.<name>.s``
histogram of the tracer's metric registry — so the same measurement feeds
both the raw trace and the p50/p99 summaries.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Dict, List, Optional

import torch


def _cuda_devices(value, out: set) -> set:
    """The CUDA devices of every tensor in ``value`` (nested dicts, lists
    and tuples)."""
    if isinstance(value, torch.Tensor):
        if value.device.type == "cuda":
            out.add(value.device)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, out)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _cuda_devices(v, out)
    return out


class Span:
    """One timed phase; use via ``with tracer.span("step") as sp:``."""

    __slots__ = ("name", "attrs", "id", "parent", "t_wall", "seconds",
                 "_tracer", "_t0", "_sync")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs
        self.id: Optional[int] = None
        self.parent: Optional[int] = None
        self.t_wall: float = 0.0
        self.seconds: float = 0.0
        self._tracer = tracer
        self._t0: float = 0.0
        self._sync: List[Any] = []

    def block(self, value):
        """Register device output(s) to wait for at close.

        Returns ``value`` unchanged so the call slots into assignments:
        ``out = sp.block(fn(x))``.
        """
        self._sync.append(value)
        return value

    def __enter__(self) -> "Span":
        self.id = self._tracer._next_id()
        stack = self._tracer._stack()
        self.parent = stack[-1].id if stack else None
        stack.append(self)
        self.t_wall = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._sync:
            for dev in _cuda_devices(self._sync, set()):
                torch.cuda.synchronize(dev)
            self._sync.clear()
        self.seconds = time.perf_counter() - self._t0
        stack = self._tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        self._tracer._emit(self, error=exc_type.__name__ if exc_type
                           else None)


class _NullSpan:
    """No-op stand-in returned by disabled tracers/obs."""

    __slots__ = ()
    name = "null"
    id = None
    parent = None
    seconds = 0.0

    def block(self, value):
        return value

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        return None


NULL_SPAN = _NullSpan()


class Tracer:
    """Span factory wired to a sink (JSONL events) and a metric registry
    (``span.<name>.s`` histograms).  Either may be None."""

    def __init__(self, sink=None, metrics=None):
        self.sink = sink
        self.metrics = metrics
        self._ids = itertools.count(1)
        self._id_lock = threading.Lock()
        self._tls = threading.local()

    def span(self, name: str, **attrs) -> Span:
        return Span(self, name, attrs)

    # ------------------------------------------------------------------
    def _next_id(self) -> int:
        with self._id_lock:
            return next(self._ids)

    def _stack(self) -> List[Span]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _emit(self, span: Span, error: Optional[str] = None) -> None:
        if self.metrics is not None:
            self.metrics.histogram(f"span.{span.name}.s").observe(
                span.seconds)
        if self.sink is not None:
            # attrs first: the reserved keys must win a collision (a span
            # attr named "kind" would otherwise corrupt the event type)
            event = {**span.attrs,
                     "kind": "span", "name": span.name, "id": span.id,
                     "parent": span.parent, "t_wall": span.t_wall,
                     "dur_s": span.seconds}
            if error:
                event["error"] = error
            self.sink.write(event)
