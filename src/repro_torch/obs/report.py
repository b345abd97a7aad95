"""Predicted-vs-measured drift report, ported from the reference's
``obs/report.py``.

The planner predicts (alpha-beta step seconds, the pipeline bubble, the
per-stage peak memory); the obs layer measures (the step-span histogram,
the bubble probe, the measured peak).  This module joins the two sides
and flags any row whose relative drift passes its tolerance.
Predictions resolve through the active calibration table when one is
installed (:mod:`repro_torch.core.calibrate`), so after ``launch/train.py
--calibration`` the drift is the model's error on this machine, not the
distance to a nominal accelerator.  The measured peak is
``torch.cuda.max_memory_allocated`` on the card
(:func:`repro_torch.core.memory.measured_peak_bytes`); on the CPU there
is none and the ``peak_bytes`` row is left out.  ``python -m
repro_torch.obs.report BENCH_*.json`` gates on a snapshot's drift table
(exit 1 on a flagged row that is not waived).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional

#: Per-metric relative drift tolerance, |measured - predicted| /
#: predicted: the reference's, which assume a calibrated model
#: (``repro_torch.core.calibrate``).  ``step_time_s`` 0.5 (the fitted
#: constants reproduce the measured p50 by construction; 50% covers noise
#: between the fitting run and the gating run), ``bubble_fraction`` 0.25,
#: ``peak_bytes`` 0.2 (the calibrated scale removes the model's bias; the
#: rest is the allocator's variation).
DEFAULT_TOLERANCES: Dict[str, float] = {
    "step_time_s": 0.5,
    "bubble_fraction": 0.25,
    "peak_bytes": 0.2,
}

UNITS: Dict[str, str] = {
    "step_time_s": "s",
    "bubble_fraction": "frac",
    "peak_bytes": "B",
}

#: Gauge / histogram names the measured side is read from.
#: ``span.step.s`` holds steady-state steps only: a step that builds its
#: step function lands in ``span.step_warmup.s``.
MEASURED_STEP_HISTOGRAM = "span.step.s"
WARMUP_STEP_HISTOGRAM = "span.step_warmup.s"
MEASURED_BUBBLE_GAUGE = "pipeline.bubble.measured"
PREDICTED_BUBBLE_GAUGE = "pipeline.bubble.predicted"
MEASURED_PEAK_GAUGE = "memory.measured_peak_bytes"
PREDICTED_PEAK_GAUGE = "memory.predicted_peak_bytes"
#: Uncalibrated model peak, published alongside the calibrated
#: PREDICTED_PEAK_GAUGE so the fitter can re-derive the scale from an
#: already-calibrated run without compounding corrections.
PREDICTED_RAW_PEAK_GAUGE = "memory.predicted_raw_peak_bytes"


@dataclasses.dataclass
class DriftRow:
    """One predicted-vs-measured pair with a relative tolerance."""

    name: str
    predicted: float
    measured: float
    unit: str = ""
    tolerance: float = 0.5

    @property
    def drift(self) -> float:
        """Relative drift (measured - predicted) / |predicted|."""
        denom = max(abs(self.predicted), 1e-12)
        return (self.measured - self.predicted) / denom

    @property
    def flagged(self) -> bool:
        return abs(self.drift) > self.tolerance

    def as_dict(self) -> Dict[str, object]:
        return {"name": self.name, "predicted": self.predicted,
                "measured": self.measured, "unit": self.unit,
                "drift": self.drift, "tolerance": self.tolerance,
                "flagged": self.flagged}


@dataclasses.dataclass
class DriftReport:
    rows: List[DriftRow]

    @property
    def flagged(self) -> List[DriftRow]:
        return [r for r in self.rows if r.flagged]

    def table(self) -> str:
        """Fixed-width predicted-vs-measured table."""
        header = (f"{'metric':<18s} {'predicted':>14s} {'measured':>14s} "
                  f"{'drift':>9s} {'tol':>7s}  verdict")
        lines = [header, "-" * len(header)]
        for r in self.rows:
            lines.append(
                f"{r.name:<18s} {_fmt(r.predicted, r.unit):>14s} "
                f"{_fmt(r.measured, r.unit):>14s} {r.drift:>+8.1%} "
                f"{r.tolerance:>6.0%}  "
                f"{'DRIFT' if r.flagged else 'ok'}")
        if not self.rows:
            lines.append("(no joined predicted/measured pairs)")
        return "\n".join(lines)

    def to_dict(self) -> Dict[str, object]:
        return {"rows": [r.as_dict() for r in self.rows],
                "n_flagged": len(self.flagged)}


def _fmt(v: float, unit: str) -> str:
    if unit == "B":
        return f"{v / 2**30:.3f} GiB"
    if unit == "frac":
        return f"{v:.3f}"
    if unit == "s" and v < 0.1:
        return f"{v * 1e3:.2f} ms"
    return f"{v:.4g} {unit}".strip()


def drift_report(predicted: Mapping[str, float],
                 measured: Mapping[str, float],
                 tolerances: Optional[Mapping[str, float]] = None
                 ) -> DriftReport:
    """Join the two sides on shared keys; unmatched keys are dropped
    (a prediction with no measurement is not drift, it is a gap)."""
    tol = dict(DEFAULT_TOLERANCES)
    tol.update(tolerances or {})
    rows = [DriftRow(name=k, predicted=float(predicted[k]),
                     measured=float(measured[k]),
                     unit=UNITS.get(k, ""), tolerance=tol.get(k, 0.5))
            for k in sorted(set(predicted) & set(measured))]
    return DriftReport(rows=rows)


# ---------------------------------------------------------------------------
# the plan side (predictions)
# ---------------------------------------------------------------------------

def predicted_step_seconds(plan) -> Optional[float]:
    """Alpha-beta cost-model seconds for the plan's own (dp, tp, pp, M).

    Reuses the planner's hybrid scoring formula
    (:func:`repro_torch.core.planner.score_hybrid_candidates`) so the report and
    the planner can never disagree about the predicted side; returns None
    when the plan's factorization is outside the scored set (e.g. a
    non-train cell).
    """
    from repro_torch.core.planner import score_hybrid_candidates

    mesh = plan.mesh
    dp = 1
    for a in ("pod", "data"):
        dp *= mesh.shape.get(a, 1)
    tp = mesh.shape.get("model", 1)
    pp = mesh.shape.get("pipe", 1)
    n_dev = math.prod(mesh.shape.values()) or 1
    try:
        scores = score_hybrid_candidates(
            plan.cfg, n_dev, global_batch=plan.global_batch,
            seq_len=plan.seq_len, num_microbatches=plan.num_microbatches,
            schedule=plan.schedule, check_memory=False)
    except Exception:
        return None
    return scores.get((dp, tp, pp))


def predicted_bubble_fraction(plan_pipeline) -> float:
    """Predicted bubble for a PipelineSpec: the calibrated probe model
    (1 - M*b / (a + M*b)) when the active table carries a pipe fit, else
    the structural GPipe (S-1)/(M+S-1)."""
    from repro_torch.core import calibrate
    fitted = calibrate.predicted_bubble(plan_pipeline.n_stages,
                                        plan_pipeline.num_microbatches)
    return fitted if fitted is not None \
        else plan_pipeline.bubble_fraction()


def plan_predictions(plan) -> Dict[str, float]:
    """The predicted side of the report, read off an ExecutablePlan.

    Calibration-aware end to end: step time routes through the planner
    (which resolves fitted links/FLOPs/overhead), the bubble prefers the
    probe-fitted model, and peak bytes carry the fitted memory scale.
    """
    out: Dict[str, float] = {}
    t = predicted_step_seconds(plan)
    if t is not None:
        out["step_time_s"] = t
    if plan.pipeline is not None:
        out["bubble_fraction"] = predicted_bubble_fraction(plan.pipeline)
    if plan.footprints:
        from repro_torch.core import memory as mem_mod
        out["peak_bytes"] = float(
            mem_mod.peak_stage_footprint(plan.footprints).calibrated_total)
    return out


# ---------------------------------------------------------------------------
# the measured side
# ---------------------------------------------------------------------------

def measured_bubble_fraction(step_seconds: Mapping[int, float]
                             ) -> Dict[int, float]:
    """Measured bubble per microbatch count from timed steps at >= 2 Ms.

    The bubble-free per-microbatch time t_mb is the slope between the two
    largest M (the S-1 bubble term cancels in the difference); measured
    bubble at M is then 1 - M * t_mb / t(M) — the estimator the
    pipeline_parallel benchmark established.
    """
    if len(step_seconds) < 2:
        raise ValueError("need step times at >= 2 microbatch counts to "
                         "separate the bubble from the per-microbatch slope")
    ms = sorted(step_seconds)
    m_hi, m_lo = ms[-1], ms[-2]
    t_mb = max(1e-12, (step_seconds[m_hi] - step_seconds[m_lo])
               / (m_hi - m_lo))
    return {m: 1.0 - m * t_mb / max(step_seconds[m], 1e-12) for m in ms}


def measured_from_summary(summary: Mapping) -> Dict[str, float]:
    """The measured side, read from a ``MetricRegistry.summary()`` (or a
    snapshot document wrapping one under ``"metrics"``)."""
    m = summary.get("metrics", summary)
    hists = m.get("histograms", {})
    gauges = m.get("gauges", {})
    out: Dict[str, float] = {}
    h = hists.get(MEASURED_STEP_HISTOGRAM)
    if h and h.get("count"):
        out["step_time_s"] = h["p50"]
    if MEASURED_BUBBLE_GAUGE in gauges:
        out["bubble_fraction"] = gauges[MEASURED_BUBBLE_GAUGE]
    if MEASURED_PEAK_GAUGE in gauges:
        out["peak_bytes"] = gauges[MEASURED_PEAK_GAUGE]
    return out


def session_drift_report(plan, summary: Mapping,
                         tolerances: Optional[Mapping[str, float]] = None
                         ) -> DriftReport:
    """The standard join: an ExecutablePlan's predictions vs a metric
    summary's measurements (step time, bubble fraction, peak memory)."""
    return drift_report(plan_predictions(plan),
                        measured_from_summary(summary),
                        tolerances=tolerances)


# ---------------------------------------------------------------------------
# CI gate: fail on flagged rows of a committed snapshot
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    """``python -m repro_torch.obs.report BENCH_*.json [--waive METRIC ...]``

    Re-reads the drift table a ``launch/train.py --metrics-snapshot`` run
    embedded under ``meta.drift`` and exits 1 if any non-waived row is
    flagged — the CI gate the ROADMAP calibration loop asked for.  Rows
    are re-judged against the *current* DEFAULT_TOLERANCES (not the ones
    baked into the snapshot), so tightening a tolerance retro-flags stale
    snapshots until they are re-measured.
    """
    import argparse
    import json
    import sys

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="gate on a committed drift snapshot")
    ap.add_argument("snapshot", help="BENCH_*.json written by a "
                    "--metrics-snapshot run")
    ap.add_argument("--waive", action="append", default=[],
                    metavar="METRIC",
                    help="ignore this metric's flag (repeatable)")
    args = ap.parse_args(argv)

    with open(args.snapshot) as f:
        snap = json.load(f)
    drift = snap.get("meta", {}).get("drift", {})
    rows = [DriftRow(name=r["name"], predicted=r["predicted"],
                     measured=r["measured"], unit=r.get("unit", ""),
                     tolerance=DEFAULT_TOLERANCES.get(r["name"], 0.5))
            for r in drift.get("rows", [])]
    if not rows:
        print(f"{args.snapshot}: no drift table under meta.drift",
              file=sys.stderr)
        return 2
    report = DriftReport(rows=rows)
    print(report.table())
    bad = [r for r in report.flagged if r.name not in args.waive]
    waived = [r for r in report.flagged if r.name in args.waive]
    for r in waived:
        print(f"waived: {r.name} ({r.drift:+.1%})")
    if bad:
        print(f"FAIL: {len(bad)} metric(s) beyond tolerance: "
              + ", ".join(f"{r.name} ({r.drift:+.1%} > {r.tolerance:.0%})"
                          for r in bad))
        return 1
    print("ok: all drift rows within tolerance")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
