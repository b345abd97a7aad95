"""The paged-KV block manager: a numpy-only copy of the JAX reference's
``serve/blocks.py``, pinned to it by the port's tests.

dMath's memory-manager thesis (persistent device buffers, host-side
bookkeeping only) applied to serving: the physical K/V page pool lives in
the reference's ``StateRegistry`` as ONE entry (so its bytes
are priced against the session ``MemoryBudget``
exactly like params and train state), while this module owns the pure
host-side logical->physical mapping — a free-list allocator plus
per-sequence block tables.

Conventions
-----------
- Physical page ``NULL_PAGE = 0`` is reserved: inactive batch slots and
  the unallocated tail of every table row point at it, so stray writes
  (idle-slot decode, prefill end-padding) land in a sacrificial page and
  can never corrupt a live sequence.  Capacity is ``num_pages - 1``.
- Admission is budget-governed the same way the planner refuses OOM
  train plans: a request whose ``prompt + max_new_tokens`` can never fit
  the pool (or the engine's position window) is refused up front with a
  structured :class:`AdmissionRefusal` carrying the footprint numbers.
- Transient pressure is NOT a refusal: ``can_admit`` gates the scheduler
  until enough pages free up, and :class:`PoolExhausted` from
  :meth:`BlockManager.extend` triggers preempt-and-requeue instead.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

NULL_PAGE = 0

GIB = 1024 ** 3


def kv_bytes_per_block(cfg, page_size: int, dtype_bytes: int = 2) -> int:
    """Global bytes one physical page costs across the layer stack:
    K and V, all layers, ``page_size`` positions of (Hkv, hd) heads."""
    return (2 * cfg.n_layers * page_size * cfg.n_kv_heads * cfg.d_head
            * dtype_bytes)


def pool_pages_for_budget(free_bytes: int, cfg, page_size: int) -> int:
    """How many pool pages (incl. the NULL page) fit in ``free_bytes``."""
    per = kv_bytes_per_block(cfg, page_size)
    return max(0, int(free_bytes // per))


@dataclasses.dataclass
class AdmissionRefusal:
    """Structured refusal reason, styled after the planner's
    ``PlanMemoryError`` rows: what was asked,
    what the footprint model says it costs, what the pool can hold."""

    rid: int
    reason: str      # "pool_capacity" | "seq_window" | "preempt_cycle"
    needed_tokens: int
    needed_blocks: int
    capacity_blocks: int
    needed_bytes: int
    capacity_bytes: int

    def describe(self) -> str:
        return (f"request {self.rid}: {self.reason} — needs "
                f"{self.needed_tokens} tokens = {self.needed_blocks} "
                f"blocks ({self.needed_bytes / GIB:.3f} GiB) > pool "
                f"capacity {self.capacity_blocks} blocks "
                f"({self.capacity_bytes / GIB:.3f} GiB)")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class PoolExhausted(RuntimeError):
    """Transient out-of-pages during decode growth; the scheduler's
    preempt-and-requeue path handles it — never an admission verdict."""


class BlockManager:
    """Free-list page allocator + per-sequence block tables.

    ``num_pages`` counts the reserved NULL page; ``max_seq`` fixes the
    logical row length every sequence's table is padded to (``n_row``
    pages), so the jitted decode/prefill signatures are shape-stable no
    matter how many pages a sequence currently owns.
    """

    def __init__(self, cfg, *, num_pages: int, page_size: int,
                 max_seq: int):
        if num_pages < 2:
            raise ValueError(
                f"paged pool needs >= 2 pages (1 reserved NULL + 1 "
                f"usable), got {num_pages}")
        self.cfg = cfg
        self.page = int(page_size)
        self.num_pages = int(num_pages)
        self.max_seq = int(max_seq)
        self.n_row = -(-self.max_seq // self.page)      # pages per table row
        # LIFO free list: hottest (most recently freed) page first, so a
        # retire->admit cycle reuses warm pages
        self._free: List[int] = list(range(self.num_pages - 1, 0, -1))
        self._tables: Dict[int, List[int]] = {}

    # -- capacity ----------------------------------------------------------
    @property
    def capacity_pages(self) -> int:
        return self.num_pages - 1

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.capacity_pages - len(self._free)

    def blocks_for(self, n_tokens: int) -> int:
        return -(-max(0, int(n_tokens)) // self.page)

    # -- admission verdicts ------------------------------------------------
    def check_admission(self, rid: int, prompt_len: int,
                        max_new_tokens: int) -> Optional[AdmissionRefusal]:
        """PERMANENT verdict: can this request ever fit?  Returns the
        structured refusal (footprint numbers attached) or None."""
        tokens = int(prompt_len) + int(max_new_tokens)
        need = self.blocks_for(tokens)
        per = kv_bytes_per_block(self.cfg, self.page)
        if tokens > self.n_row * self.page:
            return AdmissionRefusal(
                rid=rid, reason="seq_window", needed_tokens=tokens,
                needed_blocks=need, capacity_blocks=self.n_row,
                needed_bytes=need * per,
                capacity_bytes=self.n_row * per)
        if need > self.capacity_pages:
            return AdmissionRefusal(
                rid=rid, reason="pool_capacity", needed_tokens=tokens,
                needed_blocks=need, capacity_blocks=self.capacity_pages,
                needed_bytes=need * per,
                capacity_bytes=self.capacity_pages * per)
        return None

    def can_admit(self, prompt_len: int, max_new_tokens: int) -> bool:
        """TRANSIENT verdict: do the free pages hold prompt+max_new right
        now?  (Allocation at admit time only takes the prompt pages;
        decode growth allocates lazily, so admitted sequences may still
        collide — that's what preemption is for.)"""
        return self.blocks_for(prompt_len + max_new_tokens) \
            <= self.free_pages

    # -- alloc / extend / free ---------------------------------------------
    def alloc(self, rid: int, n_tokens: int) -> List[int]:
        """Allocate the pages for a sequence's first ``n_tokens``."""
        if rid in self._tables:
            raise KeyError(f"sequence {rid} already has a block table")
        need = self.blocks_for(n_tokens)
        if need > self.free_pages:
            raise PoolExhausted(
                f"sequence {rid} needs {need} pages, {self.free_pages} "
                f"free of {self.capacity_pages}")
        self._tables[rid] = [self._free.pop() for _ in range(need)]
        return self._tables[rid]

    def extend(self, rid: int, n_tokens: int) -> List[int]:
        """Grow a sequence's table to cover ``n_tokens`` positions.
        Raises :class:`PoolExhausted` (allocating nothing) when the free
        list can't cover the growth — preempt a victim and retry."""
        pages = self._tables[rid]
        need = self.blocks_for(n_tokens) - len(pages)
        if need <= 0:
            return pages
        if need > self.free_pages:
            raise PoolExhausted(
                f"sequence {rid} needs {need} more pages, "
                f"{self.free_pages} free of {self.capacity_pages}")
        pages.extend(self._free.pop() for _ in range(need))
        return pages

    def free(self, rid: int) -> int:
        """Retire a sequence: its pages go back on the free list (LIFO).
        Returns the number of pages released (0 when unknown)."""
        pages = self._tables.pop(rid, None)
        if not pages:
            return 0
        self._free.extend(reversed(pages))
        return len(pages)

    # -- table rows ---------------------------------------------------------
    def table_row(self, rid: int) -> np.ndarray:
        """(n_row,) int32 logical->physical row, tail-padded with the
        NULL page."""
        row = np.full(self.n_row, NULL_PAGE, np.int32)
        pages = self._tables[rid]
        row[:len(pages)] = pages
        return row

    def null_row(self) -> np.ndarray:
        return np.full(self.n_row, NULL_PAGE, np.int32)

    def owned(self, rid: int) -> int:
        """Pages currently held by a sequence (0 when unknown)."""
        return len(self._tables.get(rid, ()))
