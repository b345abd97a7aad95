"""Op cache (paper §3.3), ported from the reference's ``core/opcache.py``.

dMath replaces per-operation metadata broadcasts with a single cached
identifier so "the workers remember the entire forward and backward
computations".  Ops are registered once under a semantic key (op name,
abstract shapes and dtypes, operand layouts, mesh) and replayed by key;
stats expose hit rates, so a test can assert that a fixed pipeline builds
each op exactly once.

The reference caches ``jax.jit`` of the callable it is given and counts
a compilation per miss.  The port runs eagerly: :meth:`OpCache.call`
caches the callable itself, and a "compile" here is the first build of
an entry (for ``gemm_auto``, its plan).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, Hashable, Optional, Tuple

from .layout import Layout


def _abstract_key(x) -> Hashable:
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        return (tuple(x.shape), str(x.dtype))
    return ("static", repr(x))


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    compiles: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class OpCache:
    """Keyed registry of built callables (or plans) with hit/miss
    accounting."""

    def __init__(self, name: str = "dmath"):
        self.name = name
        self._plans: Dict[Hashable, Any] = {}
        self._stats: Dict[str, CacheStats] = {}
        self._lock = threading.Lock()

    def key_for(self, op: str, args: Tuple[Any, ...],
                layouts: Tuple[Optional[Layout], ...] = (),
                mesh_shape: Tuple[Tuple[str, int], ...] = (),
                **static) -> Hashable:
        return (op, tuple(_abstract_key(a) for a in args), layouts,
                mesh_shape, tuple(sorted(static.items())))

    def get_or_build(self, key: Hashable, op: str,
                     build: Callable[[], Any]) -> Any:
        with self._lock:
            stats = self._stats.setdefault(op, CacheStats())
            plan = self._plans.get(key)
            if plan is not None:
                stats.hits += 1
                return plan
            stats.misses += 1
            stats.compiles += 1
        plan = build()
        with self._lock:
            self._plans[key] = plan
        return plan

    def call(self, op: str, fn: Callable, *args,
             layouts: Tuple[Optional[Layout], ...] = (), mesh=None,
             static_argnames: Tuple[str, ...] = (), **kwargs):
        """Cache-dispatch ``fn(*args, **kwargs)`` under its semantic key
        (the first callable given for a key is the one replayed)."""
        mesh_shape = tuple(mesh.shape.items()) if mesh is not None else ()
        static = {k: kwargs[k] for k in static_argnames if k in kwargs}
        key = self.key_for(op, args, layouts, mesh_shape, **static)
        plan = self.get_or_build(key, op, lambda: fn)
        return plan(*args, **kwargs)

    def __contains__(self, key: Hashable) -> bool:
        """Membership probe WITHOUT touching hit/miss stats."""
        with self._lock:
            return key in self._plans

    def stats(self) -> Dict[str, CacheStats]:
        with self._lock:
            return dict(self._stats)

    def size(self) -> int:
        return len(self._plans)

    def clear(self) -> None:
        with self._lock:
            self._plans.clear()
            self._stats.clear()


# Process-global cache, mirroring dMath's per-worker metadata cache.
GLOBAL_CACHE = OpCache()
