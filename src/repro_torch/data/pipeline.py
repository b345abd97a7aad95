"""Input pipeline, ported from the reference's ``data/pipeline.py``: the
synthetic LM stream only (numpy, deterministic from the seed), a copy
that the tests pin to yield the reference's batches.  The threaded,
auto-tuned ``Pipeline`` is not needed by a ported path yet (ROADMAP
queue 1, item 6)."""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


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
