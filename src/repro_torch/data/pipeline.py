"""Auto-tuned input pipeline (paper §2.2), ported from the reference's
``data/pipeline.py``: :class:`Stage`, :class:`Pipeline` and the synthetic
LM stream, copies that use no framework (the tests pin them to the
reference's code and batches).

- a :class:`Stage` is a callable tagged with where it may run
  (host / device / either);
- the :class:`Pipeline` runs host stages on a thread pool feeding a
  bounded prefetch queue, so training overlaps consumption; device stages
  and ``device_put_fn`` run in ``__next__``, on the consumer's thread
  (the one that launches the card's work);
- :meth:`Pipeline.autotune` measures end-to-end samples/sec for candidate
  (n_threads, placement) settings and keeps the best — §2.2's runtime
  tuner;
- precision promotion happens at the last host stage
  (:func:`repro_torch.core.precision.lazy_promote`).

The source is a synthetic LM stream (deterministic from the master seed,
§2.3); plug any iterator for real data.  With more than one worker the
batches may leave the queue out of the source's order.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class Stage:
    name: str
    fn: Callable[[Any], Any]
    placement: str = "either"          # host | device | either


class SyntheticLM:
    """Deterministic synthetic token stream (master-seeded, §2.3).

    ``structured=True`` draws each row from a fixed bank of repeating
    n-gram patterns, so next-token prediction is learnable (loss well
    below ln(V)); the default uniform stream has irreducible loss ln(V)
    and is for throughput measurement only.
    """

    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0,
                 structured: bool = False, n_patterns: int = 64,
                 pattern_len: int = 16):
        self.vocab, self.batch, self.seq = vocab, batch, seq
        self.structured = structured
        self.rng = np.random.default_rng(seed)
        if structured:
            self.patterns = self.rng.integers(
                0, vocab, (n_patterns, pattern_len), dtype=np.int32)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            if self.structured:
                pick = self.rng.integers(0, len(self.patterns), self.batch)
                reps = -(-(self.seq + 1) // self.patterns.shape[1])
                toks = np.tile(self.patterns[pick],
                               (1, reps))[:, :self.seq + 1]
            else:
                toks = self.rng.integers(
                    0, self.vocab, (self.batch, self.seq + 1),
                    dtype=np.int32)
            yield {"tokens": toks[:, :-1].copy(),
                   "labels": toks[:, 1:].copy()}


class Pipeline:
    def __init__(self, source: Iterator, stages: Sequence[Stage],
                 n_threads: int = 2, prefetch: int = 4,
                 device_put_fn: Optional[Callable] = None):
        self.source = iter(source)
        self.stages = list(stages)
        self.n_threads = n_threads
        self.prefetch = prefetch
        self.device_put_fn = device_put_fn
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._lock = threading.Lock()
        self.placements: Dict[str, str] = {
            s.name: ("host" if s.placement in ("host", "either") else "device")
            for s in self.stages}

    # ---- execution ---------------------------------------------------------
    def _apply_host_stages(self, item):
        for s in self.stages:
            if self.placements[s.name] == "host":
                item = s.fn(item)
        return item

    def _apply_device_stages(self, item):
        for s in self.stages:
            if self.placements[s.name] == "device":
                item = s.fn(item)
        return item

    def _worker(self):
        while not self._stop.is_set():
            with self._lock:
                try:
                    item = next(self.source)
                except StopIteration:
                    self._q.put(None)
                    return
            item = self._apply_host_stages(item)
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def start(self):
        self._stop.clear()
        self._threads = [threading.Thread(target=self._worker, daemon=True)
                         for _ in range(self.n_threads)]
        for t in self._threads:
            t.start()
        return self

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2.0)
        self._threads = []
        while not self._q.empty():
            try:
                self._q.get_nowait()
            except queue.Empty:
                break

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise StopIteration
        item = self._apply_device_stages(item)
        if self.device_put_fn is not None:
            item = self.device_put_fn(item)
        return item

    # ---- the §2.2 autotuner -------------------------------------------------
    def autotune(self, consume_fn: Callable[[Any], None],
                 candidates_threads: Sequence[int] = (1, 2, 4),
                 samples: int = 8) -> Dict[str, Any]:
        """Measure samples/sec for thread counts and host/device placement
        of each movable stage; keep the fastest setting."""
        movable = [s for s in self.stages if s.placement == "either"]
        results = []
        placements_options = [
            {s.name: p for s in movable}
            for p in (["host"] * len(movable) or [[]])
        ] or [{}]
        # host-all vs device-all for movable stages (+ thread sweep)
        placement_cands = [{s.name: "host" for s in movable},
                           {s.name: "device" for s in movable}] \
            if movable else [{}]
        for nt in candidates_threads:
            for pc in placement_cands:
                self.stop()
                self.n_threads = nt
                for name, where in pc.items():
                    self.placements[name] = where
                self.start()
                t0 = time.perf_counter()
                for _ in range(samples):
                    consume_fn(next(self))
                dt = time.perf_counter() - t0
                results.append((samples / dt, nt, dict(pc)))
        results.sort(reverse=True, key=lambda r: r[0])
        best = results[0]
        self.stop()
        self.n_threads = best[1]
        self.placements.update(best[2])
        self.start()
        return {"samples_per_sec": best[0], "n_threads": best[1],
                "placements": best[2],
                "all": [(round(r[0], 2), r[1], r[2]) for r in results]}
