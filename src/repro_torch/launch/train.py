"""Training driver: ``python -m repro_torch.launch.train --arch <id> [...]``.

A thin CLI over :class:`repro_torch.api.Session`, ported from the
reference's ``launch/train.py``: config -> ``Session.plan`` ->
``init_state`` (or a restore from ``--ckpt-dir`` with ``--resume``) ->
``Session.step`` over ``SyntheticLM(structured=True)`` batches from a
threaded :class:`~repro_torch.data.Pipeline`, AdamW under
``warmup_cosine(lr, steps // 10 + 1, steps)``, periodic async checkpoints
(every ``--ckpt-every`` steps, the reference's ``ckpt_every``) and a
final blocking one.  Checkpoints are the reference's format and layout,
so either package's train CLI resumes the other's.  A resume restarts
the batch stream from its first batch, as the reference's non-resilient
resume does.

``--metrics PATH`` writes the JSONL stream (spans, counters, events) and,
at exit, a ``BENCH_step_metrics.json`` snapshot beside PATH (or at
``--metrics-snapshot``) whose meta holds the cell (arch, mesh, batch,
seq, ...) and the drift report; without it every site is the NULL no-op.
Runs on the card unless ``--device cpu`` is given.

``Session.plan`` prices the cell with the memory model against the card's
budget (or ``--hbm-gib``) before anything is allocated, and the CLI
prints the model's peak (a cell that does not fit raises
``PlanMemoryError``).  ``--calibration PATH`` installs a fitted
:class:`~repro_torch.core.calibrate.CalibrationTable` for the run.  With
``--metrics`` the run ends with the peak gauges (the model's peak,
calibrated and raw, and ``torch.cuda.max_memory_allocated`` over the
steps on the card) and the drift report (predicted vs measured step time
and peak; the CPU measures no peak, so that row is left out).

``--pp N`` trains on the pipeline path (:mod:`repro_torch.pipeline`):
the ranks form a (data = n/N, pipe = N, model = 1) mesh and
``--pp-schedule`` picks GPipe (the default) or 1F1B.  The ranks are
processes started with ``RANK``, ``WORLD_SIZE`` and
``DMATH_INIT_METHOD`` (a ``file://`` path or ``tcp://127.0.0.1:<port>``)
in their environment; the CLI joins that process group when none is
initialized.  A vlm's batches pass the reference's ``vision_stub`` host
stage (zero patch embeddings ahead of the text).

Every run has the :class:`~repro_torch.train.StepTimeWatchdog`, whose
``on_anomaly`` records a ``watchdog_anomaly`` event and cuts an early
checkpoint (with ``--ckpt-dir``).  ``--resilient`` runs the
:class:`~repro_torch.train.ResilientStepLoop` (rollback and retry of a
non-finite step, backoff on a collective timeout, watchdog escalation
to a structured abort) on a one-worker ``Pipeline``, so that the batch
order is deterministic.  ``--faults`` (a JSON file or inline JSON, see
:func:`load_fault_plan`) installs a :class:`~repro_torch.faults.FaultPlan`
as the process-active one for the run (the ``comms.sync_tree`` seam),
hands it to the resilient loop, and prints ``faults: {summary}``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import faults as faults_mod
from repro_torch import obs as obs_mod
from repro_torch.api import Session
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import distributed as dist_mod
from repro_torch.core import memory as mem_mod
from repro_torch.data import Pipeline, Stage, SyntheticLM
from repro_torch.kernels import ops
from repro_torch.obs import report as report_mod
from repro_torch.train import ResilientStepLoop, StepTimeWatchdog
from repro_torch.train.optimizer import AdamWConfig, warmup_cosine
from repro_torch.train.resilience import StateCheckpoints


def load_fault_plan(spec: Optional[str]):
    """``--faults``: a JSON file path or inline JSON — either a list of
    FaultSpec dicts or ``{"seed": ..., "specs": [...]}``."""
    if not spec:
        return None
    from repro_torch.faults import FaultPlan, FaultSpec
    text = spec
    if os.path.exists(spec):
        with open(spec) as f:
            text = f.read()
    doc = json.loads(text)
    seed, specs = (doc.get("seed", 0), doc.get("specs", [])) \
        if isinstance(doc, dict) else (0, doc)
    return FaultPlan([FaultSpec(**d) for d in specs], seed=seed)


def run(arch: str, *, steps: int = 50, batch: int = 8, seq: int = 128,
        scale_down: int = 64, lr: float = 3e-3, microbatches: int = 1,
        ckpt_dir: Optional[str] = None, ckpt_every: int = 25,
        resume: bool = False, log_every: int = 10, seed: int = 0,
        comms: str = "auto", pp: int = 1, pp_schedule: Optional[str] = None,
        hbm_gib: Optional[float] = None, metrics: Optional[str] = None,
        metrics_snapshot: Optional[str] = None,
        calibration: Optional[str] = None, resilient: bool = False,
        faults: Optional[str] = None, device: str = "cuda"):
    fault_plan = load_fault_plan(faults)
    # ranks started with RANK / WORLD_SIZE / DMATH_INIT_METHOD join their
    # group here, unless the caller has already
    joined = (not dist.is_initialized()
              and int(os.environ.get("WORLD_SIZE", "1")) > 1)
    if joined:
        dist_mod.init_group(device=device)
    # telemetry is strictly opt-in: without --metrics every obs call site
    # sees the NULL singleton, so numerics and stdout are unchanged
    obs = obs_mod.Obs(jsonl=metrics, name=f"train/{arch}") if metrics \
        else obs_mod.NULL
    prev_obs = obs_mod.set_active(obs)
    # calibrated planning is opt-in and scoped to this run: the table is
    # the active one before any plan or topology is built
    from repro_torch.core import calibrate
    prev_cal = None
    if calibration:
        table = calibrate.load(calibration)
        prev_cal = calibrate.set_active(table)
        print(f"calibration: {table.describe()}  [{calibration}]")
    prev_faults = faults_mod.set_active(fault_plan)
    try:
        losses = _run(arch, obs, steps=steps, batch=batch, seq=seq,
                      scale_down=scale_down, lr=lr,
                      microbatches=microbatches, ckpt_dir=ckpt_dir,
                      ckpt_every=ckpt_every, resume=resume,
                      log_every=log_every, seed=seed, comms=comms, pp=pp,
                      pp_schedule=pp_schedule or "gpipe", hbm_gib=hbm_gib,
                      metrics=metrics, metrics_snapshot=metrics_snapshot,
                      calibration=calibration, device=device,
                      resilient=resilient, fault_plan=fault_plan)
        if fault_plan is not None:
            print("faults:", json.dumps(fault_plan.summary()))
        return losses
    finally:
        faults_mod.set_active(prev_faults)
        if calibration:
            calibrate.set_active(prev_cal)
        obs_mod.set_active(prev_obs)
        obs.close()
        if joined:
            dist_mod.close_group()


def vision_stub(cfg, batch: int) -> list:
    """The host stages of a batch: for a vlm the reference's
    ``vision_stub`` (the InternViT frontend is a stub: the last
    ``n_vision_tokens`` tokens of each row make way for as many zero patch
    embeddings ahead of the text, whose labels are -1), else none."""
    if cfg.family != "vlm":
        return []
    nv = cfg.n_vision_tokens

    def add_vision(item):
        item = dict(item)
        item["tokens"] = item["tokens"][:, :-nv]
        item["labels"][:, :nv] = -1
        item["vision_embeds"] = np.zeros((batch, nv, cfg.d_model),
                                         np.float32)
        return item

    return [Stage("vision_stub", add_vision, "host")]


def _measure_peak(session, plan, obs) -> None:
    """Publish the steps' measured peak (on the card) beside the memory
    model's, calibrated (what the drift report judges) and raw (what the
    fitter regresses the scale from)."""
    peak = mem_mod.peak_stage_footprint(plan.footprints)
    measured = mem_mod.measured_peak_bytes(session.device)
    if measured is not None:
        obs.gauge(report_mod.MEASURED_PEAK_GAUGE).set(measured)
    obs.gauge(report_mod.PREDICTED_PEAK_GAUGE).set(
        float(peak.calibrated_total))
    obs.gauge(report_mod.PREDICTED_RAW_PEAK_GAUGE).set(float(peak.total))


def _run(arch: str, obs, *, steps, batch, seq, scale_down, lr, microbatches,
         ckpt_dir, ckpt_every, resume, log_every, seed, comms, pp,
         pp_schedule, hbm_gib, metrics, metrics_snapshot, calibration,
         device, resilient=False, fault_plan=None):
    session = Session(device=device, obs=obs, hbm_gib=hbm_gib, pp=pp)
    adamw = AdamWConfig(lr=warmup_cosine(lr, steps // 10 + 1, steps))
    plan = session.plan(arch, batch=batch, seq=seq, microbatches=microbatches,
                        pp_schedule=pp_schedule, comms=comms, adamw=adamw,
                        scale_down=scale_down)
    cfg = plan.cfg
    peak = mem_mod.peak_stage_footprint(plan.footprints)
    print(f"memory model: predicted peak {peak.total / mem_mod.GIB:.3f} "
          f"GiB/device vs {plan.budget.describe()} -> fits")
    if plan.pipeline is not None:
        print(f"pipeline: {plan.pipeline.n_stages} stages "
              f"({plan.pipeline.schedule}, {plan.num_microbatches} "
              f"microbatches), bubble {plan.pipeline.bubble_fraction():.2f}")
    if plan.comms is not None:
        print(f"comms: grad sync via {plan.comms.schedule} schedule "
              f"(bucket {plan.comms.bucket_bytes >> 20} MiB)")

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    # on a mesh the checkpoint holds the global arrays: each rank's blocks
    # are gathered at a save and taken again at a restore
    io = StateCheckpoints(mgr, session, plan) if mgr is not None else None
    # the newest complete snapshot (torn or missing ones are walked past);
    # with none the run starts fresh rather than crashing
    valid = mgr.valid_steps() if resume and mgr is not None else []
    start_step = valid[-1] if valid else 0
    resumed = bool(valid)
    if resumed:
        io.restore(start_step)
        print(f"resumed from step {start_step}")
    else:
        session.init_state(plan, seed=seed)

    source = SyntheticLM(cfg.vocab_size, batch, seq, seed=seed,
                         structured=True)
    # the resilient loop needs deterministic batch order (a restart
    # replays the stream to the restored step); 2-thread prefetch
    # reorders, so it drops to a single worker
    pipe = Pipeline(source, vision_stub(cfg, batch),
                    n_threads=1 if resilient else 2).start()
    if session.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(session.device)

    def on_anomaly(step, dt, msg):
        # anomaly -> action (the watchdog's contract): record the event
        # and cut the early checkpoint a restart depends on, not just a
        # log line.  Fires with or without --metrics.
        obs.event("watchdog_anomaly", step=step, dt_s=dt, msg=msg)
        if io is not None:
            io.save(step + 1, session.get("train_state"))
            obs.event("watchdog_checkpoint", step=step + 1)
            print(f"WATCHDOG: early checkpoint at step {step + 1}")

    dog = StepTimeWatchdog(on_anomaly=on_anomaly)
    if resumed:
        # restart hygiene: never judge the resumed run against a
        # step-time distribution learned before the interruption
        dog.reset()
    if resilient:
        loop = ResilientStepLoop(session, plan, ckpt=mgr,
                                 ckpt_every=ckpt_every, watchdog=dog,
                                 faults=fault_plan)
        try:
            out = loop.run(pipe, start_step=start_step, steps=steps)
        finally:
            pipe.stop()
        if out["skipped"]:
            print(f"resilience: skipped steps {out['skipped']} "
                  f"(loss scale {out['loss_scale']:.4g})")
        if obs.enabled:
            session.publish_metrics()
        return [out["losses"][i] for i in sorted(out["losses"])]
    losses = []
    try:
        for i in range(start_step, steps):
            batch_np = next(pipe)
            t0 = time.perf_counter()
            metrics_out = session.step(plan, batch_np)
            loss = float(metrics_out["loss"])
            dt = time.perf_counter() - t0
            losses.append(loss)
            msg = dog.observe(i, dt)
            if msg:
                print("WATCHDOG:", msg)
            if (i + 1) % log_every == 0 or i == start_step:
                print(f"step {i + 1:5d} loss {loss:.4f} ({dt * 1e3:.0f} ms)")
            if io is not None and (i + 1) % ckpt_every == 0:
                io.save(i + 1, session.get("train_state"))
        if io is not None:
            t0 = time.perf_counter()
            io.save(steps, session.get("train_state"), blocking=True)
            d = os.path.join(ckpt_dir, f"step_{steps}")
            nbytes = sum(os.path.getsize(os.path.join(d, f))
                         for f in os.listdir(d))
            print(f"checkpoint: step {steps}, {nbytes} bytes in "
                  f"{time.perf_counter() - t0:.3f} s ({d})")
    finally:
        pipe.stop()

    if obs.enabled:
        session.publish_metrics()
        _measure_peak(session, plan, obs)
        drift = report_mod.session_drift_report(
            plan, {"metrics": obs.metrics.summary()})
        print("drift report (predicted vs measured):")
        print(drift.table())
        snap_path = metrics_snapshot or os.path.join(
            os.path.dirname(os.path.abspath(metrics)) or ".",
            "BENCH_step_metrics.json")
        obs.snapshot(snap_path, arch=arch, steps=steps,
                     ranks=plan.n_ranks, device=str(session.device),
                     mesh=dict(session.mesh.shape), batch=batch, seq=seq,
                     scale_down=scale_down,
                     microbatches=plan.num_microbatches,
                     pp_schedule=pp_schedule, calibration=calibration,
                     drift=drift.to_dict(),
                     kernel_launches=ops.dispatch_report())
        print(f"metrics: {metrics}  snapshot: {snap_path}")
    return losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--scale-down", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--ckpt-every", type=int, default=25,
                    help="async checkpoint period in steps (the final "
                         "step is always saved)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--comms", choices=["auto", "off"], default="auto",
                    help="route DP grad sync through repro_torch.comms "
                         "(one rank: no wire either way)")
    ap.add_argument("--pp", type=int, default=1,
                    help="pipeline-parallel degree: the ranks form a "
                         "(data=n/pp, pipe=pp, model=1) mesh")
    ap.add_argument("--pp-schedule", choices=["gpipe", "1f1b"],
                    default=None, help="the pipeline schedule (default "
                                       "gpipe)")
    ap.add_argument("--hbm-gib", type=float, default=None,
                    help="per-device memory budget in GiB for the plan's "
                         "memory verdict (default: the card's entry, "
                         "h100 80 GiB; cpu 16 GiB)")
    ap.add_argument("--metrics", type=str, default=None, metavar="PATH",
                    help="write a JSONL telemetry stream (spans, counters, "
                         "events) to PATH and a BENCH_step_metrics.json "
                         "snapshot beside it at exit; default off")
    ap.add_argument("--metrics-snapshot", type=str, default=None,
                    metavar="PATH", help="override the snapshot path "
                    "(default: BENCH_step_metrics.json next to --metrics)")
    ap.add_argument("--calibration", type=str, default=None, metavar="PATH",
                    help="fitted calibration table (python -m "
                         "repro_torch.fit) the planner and the drift report "
                         "use for this run")
    ap.add_argument("--resilient", action="store_true",
                    help="run the fault-tolerant step loop (rollback/retry "
                         "on non-finite or timed-out steps, watchdog "
                         "escalation to a structured abort); forces "
                         "single-threaded data for deterministic replay")
    ap.add_argument("--faults", type=str, default=None, metavar="JSON",
                    help="fault-injection plan for drills: a JSON file or "
                         "inline JSON list of FaultSpec dicts, e.g. "
                         '\'[{"seam": "train.nonfinite", "step": 3}]\'')
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain versions")
    args = ap.parse_args()
    losses = run(args.arch, steps=args.steps, batch=args.batch,
                 seq=args.seq, scale_down=args.scale_down, lr=args.lr,
                 microbatches=args.microbatches, ckpt_dir=args.ckpt_dir,
                 ckpt_every=args.ckpt_every, resume=args.resume,
                 seed=args.seed, comms=args.comms, pp=args.pp,
                 pp_schedule=args.pp_schedule, hbm_gib=args.hbm_gib,
                 metrics=args.metrics,
                 metrics_snapshot=args.metrics_snapshot,
                 calibration=args.calibration, resilient=args.resilient,
                 faults=args.faults, device=args.device)
    if losses:
        print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})")


if __name__ == "__main__":
    main()
