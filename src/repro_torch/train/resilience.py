"""repro_torch.train.resilience — control loops that survive what faults
inject, ported from the reference's ``train/resilience.py``.

dMath's §2 requirement (e) — checkpoint-restart on a fleet where nodes
fail — needs more than a checkpoint *writer*: it needs the loop that
detects a poisoned step, retries a dead collective, escalates a straggler
and restarts elastically.  Three layers, composing the primitives that
already exist (``repro_torch.checkpoint``, ``train/watchdog.py``,
``Session.snapshot_state``/``restore_state``, ``repro_torch.faults``):

:class:`ResilientStepLoop`
    wraps ``Session.step`` with

    - **non-finite detection**: a step whose loss goes NaN/Inf is rolled
      back (the committed update is discarded against the last good host
      snapshot) and retried once — a transient spike replays bit-identically
      — then *skipped* with loss-scale backoff when it persists;
    - **transient retry**: :class:`~repro_torch.faults.CollectiveTimeout`
      gets bounded exponential backoff before re-issuing the same step;
    - **watchdog escalation**: N straggler anomalies inside a window cut
      an early checkpoint and raise a structured :class:`StepAbort` —
      the signal to give the flaky host up and restart elsewhere.

:class:`ElasticRunner`
    the restart driver: catches :class:`StepAbort`/:class:`HostCrash`,
    re-plans on a possibly SMALLER mesh, restores the newest *valid*
    snapshot (torn ones are walked past) onto the new session's mesh and
    layouts, replays the deterministic data pipeline to the restored
    step, and resumes — so a recovered run's trajectory matches an
    uninterrupted one.

Where the reference takes ``plan.state_shardings()``, the port takes the
session's mesh and ``Session.state_layouts(plan)``
(:class:`StateCheckpoints`): checkpoints hold the reference's tree of
global arrays, gathered from each rank's blocks at a save and re-blocked
at a restore.  Every recovery action increments a ``resil.*`` obs
counter, so the drill benchmark (and a fleet dashboard) can assert
injected == recovered.
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch

from repro_torch.checkpoint.manager import state_from_tree, state_tree
from repro_torch.core.layout import Layout
from repro_torch.faults import CollectiveTimeout, HostCrash
from repro_torch.faults import inject as inject_mod

from .watchdog import StepTimeWatchdog


class StepAbort(RuntimeError):
    """Structured abort: the loop gave up on this ATTEMPT (not the run).

    Carries the machine-readable fields the elastic driver branches on:
    ``reason`` (``watchdog_escalation`` | ``collective_timeout``),
    ``step`` (the step being executed when the loop aborted) and
    ``checkpoint_step`` (the early checkpoint cut on the way out, or
    None when none could be written).
    """

    def __init__(self, reason: str, *, step: int,
                 checkpoint_step: Optional[int] = None, detail: str = ""):
        super().__init__(
            f"step loop aborted at step {step}: {reason}"
            + (f" (checkpoint at step {checkpoint_step})"
               if checkpoint_step is not None else "")
            + (f" — {detail}" if detail else ""))
        self.reason = reason
        self.step = step
        self.checkpoint_step = checkpoint_step


@dataclasses.dataclass
class ResilienceConfig:
    """Policy knobs for the resilient loop (defaults sized for drills)."""

    #: transient-fault (CollectiveTimeout) retries per step
    max_retries: int = 3
    backoff_base_s: float = 0.05       # exponential: base * 2**(attempt-1)
    backoff_max_s: float = 2.0
    #: rollback-and-retry budget for a non-finite step before skipping it
    max_nonfinite_retries: int = 1
    #: loss-scale policy state (applied by amp-style steps; tracked and
    #: exported here so the skip decision and the scale move together)
    loss_scale_backoff: float = 0.5
    min_loss_scale: float = 1.0 / 64.0
    loss_scale_growth_steps: int = 100
    #: refresh the host rollback snapshot every N healthy steps
    snapshot_every: int = 1
    #: escalate after `anomaly_limit` watchdog anomalies within the last
    #: `anomaly_window` steps
    anomaly_window: int = 16
    anomaly_limit: int = 3


class StateCheckpoints:
    """A session's train state through a ``CheckpointManager``, saved as
    the reference's tree (:func:`state_tree`).  On several ranks a save
    gathers each leaf's blocks (``Session.state_layouts``; replicated
    leaves where the path keeps whole ones) and one rank writes; a
    restore reads the global arrays and puts this rank's blocks in the
    session's layouts back (``Session.restore_state``), on whatever mesh
    it has.  ``dir`` and ``save(step, state, blocking)`` are the
    manager's, so :func:`~repro_torch.faults.write_torn_checkpoint` takes
    this view."""

    def __init__(self, mgr, session, plan):
        self.mgr = mgr
        self.dir = mgr.dir
        self.session = session
        self.layouts = session.state_layouts(plan)

    def save(self, step: int, state, blocking: bool = False) -> None:
        tree = state_tree(state)
        kw = {}
        if self.session.n_ranks > 1:
            lays = (_tree_map(lambda x: Layout.replicated(x.dim()), tree)
                    if self.layouts is None else state_tree(self.layouts))
            kw = dict(mesh=self.session.mesh, layouts=lays)
        self.mgr.save(step, tree, blocking=blocking, **kw)

    def restore(self, step: int, name: str = "train_state"):
        """Make the (validated) snapshot of ``step`` the session's state
        ``name``; returns it."""
        state = state_from_tree(self.mgr.restore(step=step))
        kw = ({} if self.layouts is None
              else dict(mesh=self.session.mesh, layouts=self.layouts))
        return self.session.restore_state(state, name=name, **kw)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


class ResilientStepLoop:
    """``Session.step`` with detection, rollback, retry and escalation.

    The loop's step index ``i`` counts BATCHES CONSUMED (a skipped step
    advances ``i`` without a parameter update), and checkpoints are
    labeled ``i + 1`` — so a resume that replays ``label`` batches lands
    exactly where the snapshot was cut, no matter how many steps were
    skipped before it.
    """

    def __init__(self, session, plan, *, name: str = "train_state",
                 ckpt=None, ckpt_every: int = 0,
                 watchdog: Optional[StepTimeWatchdog] = None,
                 faults=None, config: Optional[ResilienceConfig] = None):
        self.session = session
        self.plan = plan
        self.name = name
        self.ckpt = ckpt
        self._io = (StateCheckpoints(ckpt, session, plan)
                    if ckpt is not None else None)
        self.ckpt_every = ckpt_every
        self.dog = watchdog
        self.faults = faults
        self.cfg = config or ResilienceConfig()
        self.obs = session.obs
        self.loss_scale = 1.0
        self.losses: List[float] = []
        self.loss_by_step: Dict[int, float] = {}
        self._good = None                 # host rollback snapshot
        self._good_step = -1
        self._good_streak = 0
        self._observed = 0                # healthy steps fed to the dog
        self._anomaly_steps: deque = deque()

    # -- snapshot / rollback ------------------------------------------------
    def _snapshot(self, step: int) -> None:
        self._good = self.session.snapshot_state(self.name)
        self._good_step = step

    def _rollback(self) -> None:
        # the snapshot holds this rank's blocks: put back as they are
        self.session.restore_state(self._good, name=self.name)
        self.obs.counter("resil.rollbacks").inc()

    def _poison(self) -> None:
        """The injected NaN gradient spike: the committed update (every
        floating leaf) goes NaN, exactly what an overflowed grad that got
        applied would leave behind — recovery MUST roll back."""
        with torch.no_grad():
            _tree_map(lambda x: x.mul_(float("nan"))
                      if x.is_floating_point() else x,
                      self.session.get(self.name))

    # -- checkpointing ------------------------------------------------------
    def checkpoint(self, label: int, blocking: bool = False) -> None:
        """Save under ``label`` (= batches consumed).  The
        ``checkpoint.torn`` fault seam fires HERE: a torn snapshot is left
        on disk with LATEST trusting it, then the host "dies"
        (:class:`HostCrash`) — only the elastic driver survives that."""
        if self.ckpt is None:
            return
        if self.faults is not None \
                and self.faults.fire("checkpoint.torn", label) is not None:
            inject_mod.write_torn_checkpoint(
                self._io, label, self.session.get(self.name))
            self.obs.counter("resil.torn_checkpoints").inc()
            raise HostCrash("checkpoint.torn", label,
                            msg=f"killed mid-write of checkpoint {label}")
        self._io.save(label, self.session.get(self.name), blocking=blocking)

    # -- watchdog escalation ------------------------------------------------
    def _observe_step_time(self, i: int, dt: float) -> None:
        if self.dog is None:
            return
        # steps that build their op-cache entry (the first call) run
        # longer than the steady state; feeding them would prime the
        # EMA's variance so wide that real stragglers never reach
        # z_threshold
        if getattr(self.session, "last_step_compiled", False):
            return
        self._observed += 1
        msg = self.dog.observe(i, dt)
        if msg is None:
            return
        print("WATCHDOG:", msg)
        self.obs.counter("resil.anomalies").inc()
        self._anomaly_steps.append(i)
        while self._anomaly_steps and \
                self._anomaly_steps[0] <= i - self.cfg.anomaly_window:
            self._anomaly_steps.popleft()
        if len(self._anomaly_steps) >= self.cfg.anomaly_limit:
            # the host is sick, not one step: cut the insurance checkpoint
            # and hand the attempt back to the elastic driver
            ckpt_step = None
            if self.ckpt is not None:
                self.checkpoint(i + 1, blocking=True)
                ckpt_step = i + 1
            self.obs.counter("resil.aborts").inc()
            self.obs.event("resil_abort", reason="watchdog_escalation",
                           step=i, checkpoint_step=ckpt_step)
            raise StepAbort(
                "watchdog_escalation", step=i, checkpoint_step=ckpt_step,
                detail=(f"{len(self._anomaly_steps)} anomalies in the last "
                        f"{self.cfg.anomaly_window} steps"))

    # -- the guarded step ---------------------------------------------------
    def step_once(self, i: int, batch) -> Optional[float]:
        """One guarded train step; returns the loss, or None when the
        step was skipped (persistent non-finite).  Raises
        :class:`StepAbort` / :class:`HostCrash` when the attempt is over.
        """
        if self._good is None or (self.cfg.snapshot_every > 0 and
                                  i - self._good_step
                                  >= self.cfg.snapshot_every):
            self._snapshot(i)
        transient = 0
        nonfinite = 0
        while True:
            t0 = time.perf_counter()
            try:
                if self.faults is not None and \
                        self.faults.fire("comms.timeout", i) is not None:
                    raise CollectiveTimeout(
                        "comms.timeout", i,
                        msg=f"injected gradient-sync timeout at step {i}")
                straggler = (self.faults.fire("train.straggler", i)
                             if self.faults is not None else None)
                if straggler is not None:
                    time.sleep(straggler.magnitude)
                metrics = self.session.step(self.plan, batch,
                                            name=self.name)
                loss = float(metrics["loss"])
            except CollectiveTimeout as e:
                transient += 1
                self.obs.counter("resil.retries").inc()
                if transient > self.cfg.max_retries:
                    ckpt_step = None
                    if self.ckpt is not None:
                        self.checkpoint(i, blocking=True)
                        ckpt_step = i
                    self.obs.counter("resil.aborts").inc()
                    raise StepAbort("collective_timeout", step=i,
                                    checkpoint_step=ckpt_step,
                                    detail=str(e)) from e
                delay = min(self.cfg.backoff_base_s * 2 ** (transient - 1),
                            self.cfg.backoff_max_s)
                self.obs.event("resil_retry", step=i, attempt=transient,
                               backoff_s=delay, fault=str(e))
                time.sleep(delay)
                continue
            dt = time.perf_counter() - t0

            if self.faults is not None and \
                    self.faults.fire("train.nonfinite", i) is not None:
                self._poison()
                loss = float("nan")

            if not math.isfinite(loss):
                self.obs.counter("resil.nonfinite").inc()
                self._rollback()
                self._good_streak = 0
                if nonfinite < self.cfg.max_nonfinite_retries:
                    # a transient spike: the clean retry of the SAME batch
                    # from the rolled-back state replays bit-identically
                    nonfinite += 1
                    self.obs.event("resil_nonfinite_retry", step=i,
                                   attempt=nonfinite)
                    continue
                # persistent: skip the step, back the loss scale off
                self.loss_scale = max(
                    self.cfg.min_loss_scale,
                    self.loss_scale * self.cfg.loss_scale_backoff)
                self.obs.counter("resil.skipped_steps").inc()
                self.obs.gauge("resil.loss_scale").set(self.loss_scale)
                self.obs.event("resil_skip", step=i,
                               loss_scale=self.loss_scale)
                return None

            # healthy step: record it FIRST (escalation below aborts the
            # attempt, but this step committed — and the escalation
            # checkpoint includes it), then refresh streak/scale and
            # feed the watchdog
            self.loss_by_step[i] = loss
            self.losses.append(loss)
            self._good_streak += 1
            if self.loss_scale < 1.0 and self._good_streak \
                    % self.cfg.loss_scale_growth_steps == 0:
                self.loss_scale = min(1.0, self.loss_scale * 2.0)
                self.obs.gauge("resil.loss_scale").set(self.loss_scale)
            # a step that needed recovery is not a steady-state latency
            # sample (its duration holds a rollback or a backoff-adjacent
            # warmup), so it never feeds the dog
            if transient == 0 and nonfinite == 0:
                self._observe_step_time(i, dt)
            return loss

    # -- the loop -----------------------------------------------------------
    def run(self, batches: Iterable, *, start_step: int, steps: int
            ) -> Dict[str, Any]:
        """Consume ``batches`` from ``start_step`` to ``steps``; returns
        ``{"losses": {step: loss}, "skipped": [...]}`` (skipped steps are
        absent from losses)."""
        it = iter(batches)
        # instance-held (step_once records committed steps as they land)
        # so the elastic driver keeps an aborted attempt's partial
        # trajectory — the steps BEFORE the crash were healthy
        losses = self.loss_by_step = {}
        skipped: List[int] = []
        for i in range(start_step, steps):
            if self.step_once(i, next(it)) is None:
                skipped.append(i)
            if self.ckpt is not None and self.ckpt_every > 0 \
                    and (i + 1) % self.ckpt_every == 0:
                self.checkpoint(i + 1)
        if self.ckpt is not None:
            self.checkpoint(steps, blocking=True)
        return {"losses": losses, "skipped": skipped,
                "loss_scale": self.loss_scale}


class ElasticRunner:
    """The restart driver: attempts -> abort -> re-plan -> restore -> replay.

    ``session_factory(attempt)`` returns ``(session, plan)`` for attempt
    N — attempt 0 is the full fleet; later attempts may re-plan on FEWER
    ranks (the elastic subset re-shard), which is why restore always
    goes through the NEW session's mesh and layouts
    (:class:`StateCheckpoints`).  ``data_factory()`` must return a fresh
    deterministic batch iterator (same seed -> same order); the runner
    replays it to the restored step so a resumed trajectory matches an
    uninterrupted one.
    """

    def __init__(self, session_factory: Callable[[int], Tuple[Any, Any]],
                 data_factory: Callable[[], Iterable], *,
                 ckpt, steps: int, ckpt_every: int = 5,
                 config: Optional[ResilienceConfig] = None,
                 faults=None, max_restarts: int = 4,
                 name: str = "train_state", seed: int = 0,
                 watchdog_factory: Optional[Callable[[], StepTimeWatchdog]]
                 = None):
        self.session_factory = session_factory
        self.data_factory = data_factory
        self.ckpt = ckpt
        self.steps = steps
        self.ckpt_every = ckpt_every
        self.config = config
        self.faults = faults
        self.max_restarts = max_restarts
        self.name = name
        self.seed = seed
        self.watchdog_factory = watchdog_factory or StepTimeWatchdog

    def run(self) -> Dict[str, Any]:
        attempt = 0
        restarts: List[Dict[str, Any]] = []
        merged: Dict[int, float] = {}
        skipped: List[int] = []
        t_abort: Optional[float] = None
        while True:
            session, plan = self.session_factory(attempt)
            valid = self.ckpt.valid_steps() if self.ckpt else []
            start = valid[-1] if valid else 0
            if valid:
                StateCheckpoints(self.ckpt, session, plan).restore(
                    start, name=self.name)
            else:
                session.init_state(plan, seed=self.seed)

            # replay the deterministic pipeline to the restored step
            data = iter(self.data_factory())
            for _ in range(start):
                next(data)

            # fresh step-time stats: the EMA learned on the previous
            # attempt's hardware must not judge the new mesh
            dog = self.watchdog_factory()
            dog.reset()

            if t_abort is not None:
                rec = restarts[-1]
                rec["restored_step"] = start
                rec["steps_lost"] = max(0, rec["abort_step"] - start)
                rec["recovery_s"] = time.perf_counter() - t_abort
                rec["mesh"] = dict(session.mesh.shape)
                session.obs.event("resil_restart", **rec)
                t_abort = None

            loop = ResilientStepLoop(
                session, plan, name=self.name, ckpt=self.ckpt,
                ckpt_every=self.ckpt_every, watchdog=dog,
                faults=self.faults, config=self.config)
            try:
                out = loop.run(data, start_step=start, steps=self.steps)
                merged.update(out["losses"])
                skipped.extend(out["skipped"])
                return {"losses": merged, "skipped": sorted(set(skipped)),
                        "restarts": restarts, "attempts": attempt + 1,
                        "final_loss": merged[max(merged)] if merged
                        else None}
            except (StepAbort, HostCrash) as e:
                # keep the healthy prefix of the aborted attempt; the
                # resumed attempt overwrites anything re-run
                merged.update(getattr(loop, "loss_by_step", {}))
                attempt += 1
                if attempt > self.max_restarts:
                    raise
                t_abort = time.perf_counter()
                restarts.append({
                    "attempt": attempt,
                    "reason": getattr(e, "reason", None)
                    or getattr(e, "seam", type(e).__name__),
                    "abort_step": getattr(e, "step", -1) or -1,
                    "checkpoint_step":
                        getattr(e, "checkpoint_step", None),
                })
