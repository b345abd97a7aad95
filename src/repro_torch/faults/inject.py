"""Seeded fault injection at named seams (the testable half of §2 req. e),
copied from the reference's ``faults/inject.py``, which imports no
framework.

A :class:`FaultPlan` is a deterministic list of :class:`FaultSpec`\\ s —
*which* seam fires, *when* (step / tick index), *how hard* (seam-specific
magnitude) and *how often* (count).  The instrumented seams ask the plan
:meth:`~FaultPlan.fire` and act only when it returns a spec, so a run
without a plan is bit-identical to an uninstrumented one and a run WITH a
plan replays the same failures every time (same specs -> same faults —
what makes the recovery drill a regression test instead of a flake).

Seams
-----
``train.nonfinite``     NaN/Inf gradient spike: the committed step update
                        is poisoned and the loss goes non-finite — the
                        loop must detect, roll back and retry/skip.
``train.straggler``     artificial per-step delay (``magnitude`` seconds)
                        feeding the
                        :class:`~repro_torch.train.StepTimeWatchdog`.
``comms.timeout``       :class:`CollectiveTimeout` raised at the step
                        boundary — the transient retry-with-backoff path.
``comms.sync_tree``     the same timeout raised *inside*
                        :func:`repro_torch.comms.plan.sync_tree` before
                        any bucket is packed (armed via the
                        process-active plan, see :func:`trace_seam`;
                        the port runs eagerly, so it is consulted at
                        every call).
``checkpoint.torn``     kill-mid-write: a torn snapshot (truncated
                        manifest) is left on disk with ``LATEST``
                        pointing at it, then :class:`HostCrash` — restore
                        must walk back to the newest complete snapshot.
``serve.pool_storm``    ``magnitude`` KV pages stolen from the block pool
                        for ``duration`` engine ticks (``arm_engine``) —
                        the preempt/requeue/shed paths under pressure.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence

SEAMS = ("train.nonfinite", "train.straggler", "comms.timeout",
         "comms.sync_tree", "checkpoint.torn", "serve.pool_storm")


class InjectedFault(RuntimeError):
    """Base for harness-injected failures; carries the seam + step."""

    def __init__(self, seam: str, step: Optional[int] = None,
                 msg: str = ""):
        super().__init__(msg or f"injected fault at seam {seam!r}"
                         + (f" (step {step})" if step is not None else ""))
        self.seam = seam
        self.step = step


class CollectiveTimeout(InjectedFault):
    """A collective (gradient sync) timed out — TRANSIENT: the resilient
    loop retries the same step with bounded exponential backoff."""


class HostCrash(InjectedFault):
    """A host died mid-operation (kill-mid-write, lost device) — FATAL
    for the attempt: only the elastic-restart driver recovers, by
    restoring the newest valid checkpoint onto a re-planned mesh."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One deterministic injection: fire ``count`` times at ``seam``.

    ``step=None`` means "the next time the seam is consulted" (what the
    trace-time :func:`trace_seam` uses — compiles have no step index);
    otherwise the spec fires only when the seam reports that exact
    step/tick.  ``magnitude`` is seam-specific: straggler delay seconds,
    storm pages.  ``duration`` is in engine ticks (storms only).
    """

    seam: str
    step: Optional[int] = None
    count: int = 1
    magnitude: float = 0.0
    duration: int = 1

    def __post_init__(self):
        if self.seam not in SEAMS:
            raise ValueError(f"unknown fault seam {self.seam!r}; "
                             f"expected one of {SEAMS}")


class FaultPlan:
    """A seeded, deterministic schedule of fault injections.

    Thread-safe (the serve engine and a checkpoint writer may consult it
    concurrently).  Every firing is recorded in :attr:`fired`, and
    :meth:`summary` gives the per-seam injected/pending counts the drill
    benchmark commits — an injection with no matching recovery in the
    report is a failed drill.
    """

    def __init__(self, specs: Sequence[FaultSpec] = (), seed: int = 0):
        self.seed = seed
        self.specs: List[FaultSpec] = list(specs)
        self._remaining: List[int] = [s.count for s in self.specs]
        self.fired: List[Dict] = []
        self._lock = threading.Lock()

    @classmethod
    def random(cls, seed: int, steps: int,
               seams: Sequence[str] = ("train.nonfinite",
                                       "train.straggler",
                                       "comms.timeout"),
               magnitude: float = 0.25) -> "FaultPlan":
        """One injection per seam at a seed-chosen step — the quick way
        to build a reproducible chaos schedule for a run of ``steps``."""
        import numpy as np
        rng = np.random.default_rng(seed)
        specs = [FaultSpec(seam=s, step=int(rng.integers(1, max(2, steps))),
                           magnitude=magnitude) for s in seams]
        return cls(specs, seed=seed)

    # ------------------------------------------------------------------
    def fire(self, seam: str, step: Optional[int] = None
             ) -> Optional[FaultSpec]:
        """Consume-and-return the first armed spec matching ``seam`` at
        ``step`` (a ``step=None`` spec matches any consultation).  Returns
        None when nothing is armed — the seam then does nothing."""
        with self._lock:
            for i, spec in enumerate(self.specs):
                if spec.seam != seam or self._remaining[i] <= 0:
                    continue
                if spec.step is not None and spec.step != step:
                    continue
                self._remaining[i] -= 1
                self.fired.append({"seam": seam, "step": step,
                                   "spec_step": spec.step,
                                   "magnitude": spec.magnitude})
                return spec
        return None

    def pending(self, seam: Optional[str] = None) -> int:
        """Injections not yet fired (optionally for one seam)."""
        with self._lock:
            return sum(r for s, r in zip(self.specs, self._remaining)
                       if seam is None or s.seam == seam)

    def injected(self, seam: Optional[str] = None) -> int:
        with self._lock:
            return sum(1 for f in self.fired
                       if seam is None or f["seam"] == seam)

    def summary(self) -> Dict[str, Dict[str, int]]:
        out: Dict[str, Dict[str, int]] = {}
        for spec in self.specs:
            d = out.setdefault(spec.seam, {"planned": 0, "injected": 0,
                                           "pending": 0})
            d["planned"] += spec.count
        for f in self.fired:
            out[f["seam"]]["injected"] += 1
        for s in out:
            out[s]["pending"] = out[s]["planned"] - out[s]["injected"]
        return out


# ---------------------------------------------------------------------------
# process-active plan: seams that run far from any handle (trace time)
# ---------------------------------------------------------------------------

_ACTIVE: Optional[FaultPlan] = None


def set_active(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    """Install ``plan`` as the process-active one (None disarms); returns
    the previous plan so callers can restore it in a finally block."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = plan
    return prev


def get_active() -> Optional[FaultPlan]:
    return _ACTIVE


def trace_seam(seam: str) -> None:
    """Trace-time seam (e.g. inside ``comms.sync_tree``): raises
    :class:`CollectiveTimeout` when the process-active plan has an armed
    ``step=None`` spec for ``seam``.  The exception propagates out of the
    jit trace before anything is compiled or cached, so a disarmed retry
    traces cleanly."""
    plan = _ACTIVE
    if plan is None:
        return
    spec = plan.fire(seam)
    if spec is not None:
        raise CollectiveTimeout(seam, msg=f"injected timeout inside {seam}")


# ---------------------------------------------------------------------------
# seam helpers: serve pool storms, torn checkpoints
# ---------------------------------------------------------------------------

#: reserved rid namespace for storm-held pages (never collides with real
#: requests, which use non-negative rids)
_STORM_RID = -1_000_000


def arm_engine(plan: FaultPlan, engine) -> None:
    """Attach the plan's ``serve.pool_storm`` specs to a
    :class:`~repro_torch.serve.ContinuousEngine`: at the spec's tick, steal
    ``magnitude`` pages from the block pool (held under a reserved rid)
    and give them back ``duration`` ticks later — admitted sequences hit
    :class:`~repro_torch.serve.blocks.PoolExhausted` on growth exactly as if
    a burst of traffic had taken the pages."""
    holds: Dict[int, List[int]] = {}        # release_tick -> [storm rids]

    def hook(tick: int) -> None:
        blocks = engine.blocks
        for release in [t for t in holds if t <= tick]:
            for rid in holds.pop(release):
                blocks.free(rid)
        spec = plan.fire("serve.pool_storm", tick)
        if spec is not None:
            steal = min(int(spec.magnitude), blocks.free_pages)
            if steal > 0:
                rid = _STORM_RID - len(plan.fired)
                blocks.alloc(rid, steal * blocks.page)
                holds.setdefault(tick + max(1, spec.duration), []).append(rid)

    engine.tick_hooks.append(hook)


def write_torn_checkpoint(mgr, step: int, state) -> None:
    """Simulate kill-mid-write: leave a TORN snapshot for ``step`` on disk
    — leaf files present, ``manifest.json`` truncated mid-document — with
    the ``LATEST`` pointer already trusting it (what a hard kill between
    the data fsync and the manifest write leaves behind on a
    non-atomic writer, or an fs that lost the tail).  The hardened
    :meth:`~repro_torch.checkpoint.CheckpointManager.restore` must refuse this
    snapshot and walk back to the newest complete one."""
    import json
    import os

    mgr.save(step, state, blocking=True)
    d = os.path.join(mgr.dir, f"step_{step}")
    manifest = os.path.join(d, "manifest.json")
    with open(manifest) as f:
        doc = f.read()
    with open(manifest, "w") as f:
        f.write(doc[: max(1, len(doc) // 2)])   # torn mid-write
    with open(os.path.join(mgr.dir, "LATEST"), "w") as f:
        f.write(str(step))
