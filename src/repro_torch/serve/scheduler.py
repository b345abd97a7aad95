"""Budget-governed request scheduling: a numpy-only copy of the JAX
reference's ``serve/scheduler.py``, pinned to it by the port's tests.

The per-tick policy half of continuous batching: the
:class:`~repro_torch.serve.blocks.BlockManager` says what fits, this module
says who goes next.  FIFO by default, optional static priorities;
admission is gated on the pool holding ``prompt + max_new_tokens`` (the
same conservative bound the footprint model uses), long prefills are
chunked by the engine and interleaved with decode ticks, and pool
exhaustion during decode growth preempts the YOUNGEST admitted sequence
— it has the least sunk prefill work — which requeues at the FRONT so
it is first to restart.

Graceful degradation under deadline pressure (§2 req. e's serving twin):
a request may carry a ``deadline_s`` TTL; queued work that expires before
admission is SHED with a structured :class:`DeadlineExceeded` refusal
(never silently dropped), and preempt-requeue cycles are bounded per
request — a sequence the pool can never keep resident converts into the
permanent :class:`~repro_torch.serve.blocks.AdmissionRefusal` instead of
preempting forever.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, List, Optional, Sequence

import numpy as np

from .blocks import AdmissionRefusal, BlockManager, kv_bytes_per_block


@dataclasses.dataclass
class DeadlineExceeded:
    """Structured shed reason: the request's TTL elapsed while it was
    still queued.  Styled after :class:`AdmissionRefusal` — what was
    asked, what happened, so clients can retry/deprioritize on data
    instead of parsing strings."""

    rid: int
    reason: str                    # always "deadline"
    deadline_s: float              # the TTL the client attached
    waited_s: float                # how long it actually sat queued
    n_preempted: int = 0           # restarts burned before the TTL ran out

    def describe(self) -> str:
        return (f"request {self.rid}: {self.reason} — queued "
                f"{self.waited_s:.3f}s > TTL {self.deadline_s:.3f}s "
                f"({self.n_preempted} preemptions)")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (S_prompt,) int32
    max_new_tokens: int = 32
    priority: int = 0             # higher admits first (priority policy)
    #: TTL in seconds from submit; queued past this -> shed with a
    #: structured DeadlineExceeded.  None = wait forever.  Admission
    #: stops the clock: an ADMITTED request always runs to completion.
    deadline_s: Optional[float] = None
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # lifecycle timestamps (time.perf_counter seconds) + bookkeeping
    submit_t: Optional[float] = None
    admit_t: Optional[float] = None
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    n_preempted: int = 0
    refusal: Optional[object] = None   # AdmissionRefusal | DeadlineExceeded
    prefill_pos: int = 0          # prompt tokens already prefilled

    def expired(self, now: Optional[float] = None) -> bool:
        """Deadline verdict for QUEUED work (admitted requests are never
        expired — their clock stopped at admit_t)."""
        if self.deadline_s is None or self.submit_t is None \
                or self.admit_t is not None:
            return False
        return (now if now is not None
                else time.perf_counter()) - self.submit_t > self.deadline_s


class Scheduler:
    """Queue + admission/preemption policy over a :class:`BlockManager`.

    ``policy="fifo"`` scans the queue in arrival order and admits the
    first request whose footprint fits the free pool; ``"priority"``
    scans in (priority desc, arrival) order.  Requests that can NEVER
    fit (pool capacity or the engine's position window) are refused at
    submit time with the block manager's structured reason and land in
    ``refused`` instead of the queue.
    """

    def __init__(self, blocks: BlockManager, *, policy: str = "fifo",
                 max_preempt_restarts: int = 3):
        if policy not in ("fifo", "priority"):
            raise ValueError(f"scheduler policy {policy!r}; expected "
                             "fifo | priority")
        self.blocks = blocks
        self.policy = policy
        self.max_preempt_restarts = max_preempt_restarts
        self.queue: Deque[Request] = deque()
        self.refused: List[Request] = []
        self.shed: List[Request] = []

    # -- intake -------------------------------------------------------------
    def submit(self, req: Request) -> Optional[AdmissionRefusal]:
        """Queue a request, or refuse it outright when it can never fit.
        Returns the structured refusal (also stored on the request) or
        None when queued."""
        if req.submit_t is None:
            req.submit_t = time.perf_counter()
        refusal = self.blocks.check_admission(
            req.rid, len(req.prompt), req.max_new_tokens)
        if refusal is not None:
            req.refusal = refusal
            req.done = True
            self.refused.append(req)
            return refusal
        self.queue.append(req)
        return None

    # -- deadline shedding --------------------------------------------------
    def shed_expired(self, now: Optional[float] = None) -> List[Request]:
        """Remove every QUEUED request whose TTL has elapsed, stamping a
        structured :class:`DeadlineExceeded` on each; returns the shed
        batch (also collected on ``self.shed``).  Called by the engine
        per tick before admission — expired work never takes a slot or a
        prefill from requests that can still meet their deadline."""
        now = now if now is not None else time.perf_counter()
        out: List[Request] = []
        for req in [r for r in self.queue if r.expired(now)]:
            self.queue.remove(req)
            req.refusal = DeadlineExceeded(
                rid=req.rid, reason="deadline",
                deadline_s=float(req.deadline_s),
                waited_s=now - req.submit_t,
                n_preempted=req.n_preempted)
            req.done = True
            req.finish_t = now
            self.shed.append(req)
            out.append(req)
        return out

    # -- admission ----------------------------------------------------------
    def _scan_order(self) -> Sequence[Request]:
        if self.policy == "priority":
            # stable sort: ties keep arrival order
            return sorted(self.queue, key=lambda r: -r.priority)
        return self.queue

    def next_admission(self) -> Optional[Request]:
        """Pop the next request the pool can hold end-to-end, or None.
        FIFO deliberately allows small requests to bypass a stuck head —
        the head is not starved because pages only ever free up (retire/
        preempt), at which point arrival order wins again."""
        for req in self._scan_order():
            if self.blocks.can_admit(len(req.prompt), req.max_new_tokens):
                self.queue.remove(req)
                return req
        return None

    # -- preemption ---------------------------------------------------------
    def victim(self, active: Sequence[Optional[Request]]
               ) -> Optional[Request]:
        """The youngest admitted sequence (latest ``admit_t``): least
        sunk prefill/decode work to throw away."""
        live = [r for r in active if r is not None]
        if not live:
            return None
        return max(live, key=lambda r: (r.admit_t or 0.0))

    def requeue_preempted(self, req: Request
                          ) -> Optional[AdmissionRefusal]:
        """Full-restart preemption: drop generated state, requeue FRONT.

        Cycle bound: a request preempted more than
        ``max_preempt_restarts`` times is circulating through a pool that
        cannot keep it resident (classically: its footprint grows past
        what concurrent traffic leaves free, every re-admission collides
        again).  Instead of preempting forever it converts into the
        permanent structured :class:`AdmissionRefusal`
        (``reason="preempt_cycle"``), which is returned (and stamped on
        the request); None means the request was requeued normally."""
        req.n_preempted += 1
        req.out.clear()
        req.prefill_pos = 0
        req.admit_t = None
        req.first_token_t = None
        if req.n_preempted > self.max_preempt_restarts:
            tokens = len(req.prompt) + req.max_new_tokens
            need = self.blocks.blocks_for(tokens)
            per = kv_bytes_per_block(self.blocks.cfg, self.blocks.page)
            req.refusal = AdmissionRefusal(
                rid=req.rid, reason="preempt_cycle",
                needed_tokens=tokens, needed_blocks=need,
                capacity_blocks=self.blocks.capacity_pages,
                needed_bytes=need * per,
                capacity_bytes=self.blocks.capacity_pages * per)
            req.done = True
            req.finish_t = time.perf_counter()
            self.refused.append(req)
            return req.refusal
        self.queue.appendleft(req)
        return None

    # -- retirement ---------------------------------------------------------
    def retire(self, req: Request) -> None:
        req.done = True
        req.finish_t = time.perf_counter()

    def __len__(self) -> int:
        return len(self.queue)
