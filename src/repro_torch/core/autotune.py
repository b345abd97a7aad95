"""Startup autotuning (paper §4.1), ported from the reference's
``core/autotune.py``.

"On startup, dMath automatically selects the optimal convolution algorithm
based on timing samples and system constraints."  The same mechanism here
selects among candidate implementations (a GEMM algorithm for a layout
pair, a kernel's tiling, a remat policy) by timing each candidate a few
times and memoizing the winner by key.  A memory ceiling disqualifies
candidates whose workspace would not fit (the paper's "system
constraints"), as does a candidate that raises; when every candidate is
disqualified, :meth:`AutoTuner.pick` raises.

A candidate's result is waited for before the clock is read: on the card
``torch.cuda.synchronize``, the port's ``block_until_ready``.  As in the
reference, nothing in the system calls the tuner itself.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass
class Candidate:
    name: str
    fn: Callable[..., Any]
    workspace_bytes: int = 0


@dataclasses.dataclass
class TuneResult:
    name: str
    us_per_call: float
    disqualified: Tuple[str, ...] = ()


def _ready(out: Any) -> None:
    """Wait for ``out``'s device work: the card's queue when any tensor of
    it lies there."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _ready(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _ready(v)


class AutoTuner:
    """Times candidates, honours a memory budget, memoizes the choice."""

    def __init__(self, budget_bytes: Optional[int] = None, warmup: int = 1,
                 iters: int = 3):
        self.budget_bytes = budget_bytes
        self.warmup = warmup
        self.iters = iters
        self._choices: Dict[Any, TuneResult] = {}

    def pick(self, key: Any, candidates: Sequence[Candidate],
             *args, **kwargs) -> TuneResult:
        if key in self._choices:
            return self._choices[key]

        disq = []
        best: Optional[Tuple[float, Candidate]] = None
        for cand in candidates:
            if (self.budget_bytes is not None
                    and cand.workspace_bytes > self.budget_bytes):
                disq.append(cand.name)
                continue
            try:
                for _ in range(self.warmup):
                    _ready(cand.fn(*args, **kwargs))
                t0 = time.perf_counter()
                for _ in range(self.iters):
                    _ready(cand.fn(*args, **kwargs))
                dt = (time.perf_counter() - t0) / self.iters * 1e6
            except Exception:
                disq.append(cand.name)
                continue
            if best is None or dt < best[0]:
                best = (dt, cand)

        if best is None:
            raise RuntimeError(
                f"autotune: every candidate disqualified for {key}: {disq}")
        result = TuneResult(best[1].name, best[0], tuple(disq))
        self._choices[key] = result
        return result

    def choices(self) -> Dict[Any, TuneResult]:
        return dict(self._choices)


GLOBAL_TUNER = AutoTuner()
