"""Persistent device-resident state registry (paper §2.1), ported from
the reference's ``api/state.py``.

dMath keeps persistent data (parameters, optimizer state, caches) in GPU
memory across steps.  :class:`StateRegistry` is that store made
explicit: named trees of tensors with byte accounting against a
:class:`repro_torch.core.memory.MemoryBudget`.  ``Session.step``
refreshes an entry after every step; ``evict``/``clear`` free the
accounting.

The class is the reference's: it counts a tree's bytes and refuses a put
that takes the total past ``budget.usable * n_devices``.  The reference
holds global arrays and counts them against the mesh's aggregate; the
port's ``Session`` holds one rank's tensors (its blocks on a mesh) and
makes its registry with ``n_devices=1``, so each rank is held to one
device's usable bytes.  ``registry[name]`` is ``get(name)``.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, Iterable, Optional

from .errors import PlanMemoryError

GIB = 1024 ** 3


@dataclasses.dataclass
class StateEntry:
    """One persistent tree: the value, its bytes, and a kind tag
    (``train_state`` | ``params`` | ``kv_cache`` | ``state``) for
    reporting."""

    value: Any
    nbytes: int
    kind: str = "state"


class StateRegistry:
    """name -> :class:`StateEntry` with footprint accounting."""

    def __init__(self, budget=None, n_devices: int = 1):
        self.budget = budget
        self.n_devices = max(1, int(n_devices))
        self._table: Dict[str, StateEntry] = {}
        self._lock = threading.Lock()

    # -- capacity ----------------------------------------------------------
    @property
    def capacity(self) -> Optional[int]:
        """Aggregate usable bytes across the mesh, or None (unbounded)."""
        if self.budget is None:
            return None
        return self.budget.usable * self.n_devices

    def total_bytes(self) -> int:
        with self._lock:
            return sum(e.nbytes for e in self._table.values())

    def footprint(self) -> Dict[str, int]:
        with self._lock:
            return {k: e.nbytes for k, e in self._table.items()}

    # -- mutation ----------------------------------------------------------
    def put(self, name: str, tree: Any, kind: str = "state") -> StateEntry:
        """Register (or overwrite) a persistent tree under ``name``.

        Raises :class:`PlanMemoryError` when the registry total would
        exceed the aggregate budget — the paper's resource-governed
        refusal applied to the persistent store.
        """
        from repro_torch.core import memory as mem_mod

        nb = mem_mod.tree_bytes(tree)
        with self._lock:
            other = sum(e.nbytes for k, e in self._table.items()
                        if k != name)
            cap = self.capacity
            if cap is not None and other + nb > cap:
                raise PlanMemoryError(
                    f"putting {name!r} ({nb / GIB:.2f} GiB) would take the "
                    f"persistent-state registry to "
                    f"{(other + nb) / GIB:.2f} GiB > aggregate capacity "
                    f"{cap / GIB:.2f} GiB ({self.budget.describe()} x "
                    f"{self.n_devices} devices); evict something first",
                    budget=self.budget)
            entry = StateEntry(tree, nb, kind)
            self._table[name] = entry
            return entry

    def update(self, name: str, tree: Any) -> StateEntry:
        """Refresh: replace the value of an EXISTING entry (the step's
        new state).  Enforces the same capacity bound as ``put`` — a
        refresh that grows the entry past budget raises too."""
        from repro_torch.core import memory as mem_mod

        nb = mem_mod.tree_bytes(tree)
        with self._lock:
            if name not in self._table:
                raise KeyError(
                    f"no persistent state named {name!r} to update; "
                    f"known: {sorted(self._table)}")
            old = self._table[name]
            other = sum(e.nbytes for k, e in self._table.items()
                        if k != name)
            cap = self.capacity
            if cap is not None and other + nb > cap:
                raise PlanMemoryError(
                    f"updating {name!r} to {nb / GIB:.2f} GiB would take "
                    f"the persistent-state registry to "
                    f"{(other + nb) / GIB:.2f} GiB > aggregate capacity "
                    f"{cap / GIB:.2f} GiB; evict something first",
                    budget=self.budget)
            self._table[name] = StateEntry(tree, nb, old.kind)
            return self._table[name]

    def replace_value(self, name: str, tree: Any) -> StateEntry:
        """Swap an entry's value WITHOUT re-walking the tree for bytes:
        for fixed-size buffers (a serve engine's KV cache, whose stand-in
        was put first)."""
        with self._lock:
            if name not in self._table:
                raise KeyError(
                    f"no persistent state named {name!r} to replace; "
                    f"known: {sorted(self._table)}")
            old = self._table[name]
            self._table[name] = StateEntry(tree, old.nbytes, old.kind)
            return self._table[name]

    def get(self, name: str) -> Any:
        with self._lock:
            if name not in self._table:
                raise KeyError(
                    f"no persistent state named {name!r}; "
                    f"known: {sorted(self._table)}")
            return self._table[name].value

    def evict(self, name: str) -> Any:
        """Drop an entry (freeing its accounting); returns the value or
        None when absent."""
        with self._lock:
            e = self._table.pop(name, None)
            return e.value if e is not None else None

    def clear(self) -> None:
        with self._lock:
            self._table.clear()

    # -- views -------------------------------------------------------------
    def keys(self) -> Iterable[str]:
        with self._lock:
            return sorted(self._table)

    def entry(self, name: str) -> Optional[StateEntry]:
        with self._lock:
            return self._table.get(name)

    def __getitem__(self, name: str) -> Any:
        return self.get(name)

    def __contains__(self, name: str) -> bool:
        return name in self._table

    def __len__(self) -> int:
        return len(self._table)

    def report(self) -> str:
        with self._lock:
            lines = [f"  {k:<24s} {e.kind:<12s} {e.nbytes / GIB:8.3f} GiB"
                     for k, e in sorted(self._table.items())]
        cap = self.capacity
        head = (f"persistent state: {self.total_bytes() / GIB:.3f} GiB"
                + (f" / {cap / GIB:.1f} GiB aggregate" if cap else ""))
        return "\n".join([head] + lines)
