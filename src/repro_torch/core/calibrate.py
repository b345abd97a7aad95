"""Calibration fitter: refit the planner's cost and memory constants from
obs data, ported from the reference's ``core/calibrate.py``.

Every link, FLOPs and memory constant the planner consumes starts at the
reference's nominal value (``comms/topology.py``'s links,
``pipeline/costs.py``'s ``DEVICE_FLOPS``, the ``core/memory.py`` footprint
model).  This module reads the obs layer's measurements, the JSONL stream
and a ``BENCH_*.json``-shaped snapshot, and least-squares-refits them:

- **one link's alpha and beta** from ``collective_sample`` events
  (T = steps * alpha + wire_bytes * beta; ``steps`` and ``wire_bytes``
  from :func:`repro_torch.comms.topology.allreduce_design`);
- **the per-tick pipeline compute and the step overhead** from a
  ``bubble_probe`` event (t(M) = a + b * M);
- **effective device FLOPs** by inverting the planner's own scoring
  function (:func:`repro_torch.core.planner.score_hybrid_candidates`)
  against the steady-state step-time histogram;
- **a memory correction factor** from ``memory.predicted_peak_bytes``
  against ``memory.measured_peak_bytes``.

The result is a versioned :class:`CalibrationTable` (JSON, with its
provenance: sources, sample counts, residuals).  Consumers load it with
:func:`set_active` (or ``launch/train.py --calibration PATH``); without
an active table every consumer keeps the nominals, and degenerate data
keeps them per constant with a :class:`CalibrationWarning`.  The same
events and snapshot give the reference's table, field for field (its
provenance's ``fitted_at`` and ``sources`` aside).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
import warnings
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.comms.topology import LinkSpec

CALIBRATION_VERSION = 1

#: Fewest steady-state step samples the FLOPs fit will accept.
MIN_STEADY_STEPS = 3

#: Fewest (steps, wire_bytes, seconds) samples the link fit will accept.
MIN_LINK_SAMPLES = 2


class CalibrationWarning(UserWarning):
    """A constant could not be fitted; its hand-set default stays."""


class CalibrationDataError(ValueError):
    """The obs data is missing pieces no fit can work around."""


def _warn(warns: List[Dict[str, str]], field: str, reason: str) -> None:
    warns.append({"field": field, "reason": reason})
    warnings.warn(f"calibration: {field}: {reason} — hand-set default "
                  f"kept", CalibrationWarning, stacklevel=3)


# ---------------------------------------------------------------------------
# the table
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CalibrationTable:
    """Fitted planner constants + provenance.  ``None`` fields mean "the
    fit had no data for this constant — keep the hand-set default"."""

    version: int = CALIBRATION_VERSION
    intra: Optional[LinkSpec] = None        # fitted intranode link
    inter: Optional[LinkSpec] = None        # fitted internode link
    device_flops: Optional[float] = None    # effective FLOPs/s per device
    step_overhead_s: float = 0.0            # fixed per-step host overhead
    pipe_tick_s: Optional[float] = None     # b in t(M) = a + b*M
    pipe_intercept_s: Optional[float] = None  # a in t(M) = a + b*M
    memory_scale: float = 1.0               # measured_peak / predicted_peak
    provenance: Mapping = dataclasses.field(default_factory=dict)

    # -- derived predictions ------------------------------------------------
    def predicted_bubble(self, n_stages: int,
                         n_microbatches: int) -> Optional[float]:
        """Calibrated bubble at M: 1 - M*b / (a + M*b) — what the slope
        estimator in :func:`repro_torch.obs.report.measured_bubble_fraction`
        will measure when t(M) = a + b*M holds.  None without a pipe fit
        (fall back to the structural (S-1)/(M+S-1))."""
        if (n_stages <= 1 or self.pipe_tick_s is None
                or self.pipe_intercept_s is None):
            return None
        m = max(1, n_microbatches)
        t_m = self.pipe_intercept_s + m * self.pipe_tick_s
        if t_m <= 0:
            return None
        return min(1.0, max(0.0, 1.0 - m * self.pipe_tick_s / t_m))

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> Dict:
        def link(spec: Optional[LinkSpec]):
            return None if spec is None else {
                "latency_s": spec.latency_s,
                "bandwidth_Bps": spec.bandwidth_Bps}
        return {"version": self.version,
                "intra": link(self.intra), "inter": link(self.inter),
                "device_flops": self.device_flops,
                "step_overhead_s": self.step_overhead_s,
                "pipe_tick_s": self.pipe_tick_s,
                "pipe_intercept_s": self.pipe_intercept_s,
                "memory_scale": self.memory_scale,
                "provenance": dict(self.provenance)}

    @classmethod
    def from_dict(cls, d: Mapping) -> "CalibrationTable":
        def link(v):
            return None if v is None else LinkSpec(
                latency_s=float(v["latency_s"]),
                bandwidth_Bps=float(v["bandwidth_Bps"]))
        v = int(d.get("version", 0))
        if v != CALIBRATION_VERSION:
            raise CalibrationDataError(
                f"calibration table version {v} != supported "
                f"{CALIBRATION_VERSION}; refit from current obs data")
        return cls(version=v, intra=link(d.get("intra")),
                   inter=link(d.get("inter")),
                   device_flops=d.get("device_flops"),
                   step_overhead_s=float(d.get("step_overhead_s", 0.0)),
                   pipe_tick_s=d.get("pipe_tick_s"),
                   pipe_intercept_s=d.get("pipe_intercept_s"),
                   memory_scale=float(d.get("memory_scale", 1.0)),
                   provenance=d.get("provenance", {}))

    def save(self, path: str) -> str:
        from repro_torch.obs.sink import write_snapshot
        return write_snapshot(path, self.to_dict())

    def describe(self) -> str:
        parts = []
        if self.inter is not None:
            parts.append(f"link alpha={self.inter.latency_s * 1e6:.1f}us "
                         f"bw={self.inter.bandwidth_Bps / 1e9:.2f}GB/s")
        if self.device_flops is not None:
            parts.append(f"flops={self.device_flops / 1e9:.2f}G/s")
        if self.pipe_tick_s is not None:
            parts.append(f"tick={self.pipe_tick_s * 1e3:.1f}ms")
        if self.step_overhead_s:
            parts.append(f"overhead={self.step_overhead_s * 1e3:.1f}ms")
        parts.append(f"mem_scale={self.memory_scale:.3f}")
        return "CalibrationTable(" + ", ".join(parts) + ")"


def load(path: str) -> CalibrationTable:
    with open(path) as f:
        return CalibrationTable.from_dict(json.load(f))


# ---------------------------------------------------------------------------
# active-table plumbing (the consumption side)
# ---------------------------------------------------------------------------

_ACTIVE: Optional[CalibrationTable] = None


def set_active(table: Optional[CalibrationTable]
               ) -> Optional[CalibrationTable]:
    """Install ``table`` process-wide (None clears).  Returns the previous
    table so callers can restore it in a finally block."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = table
    return prev


def active() -> Optional[CalibrationTable]:
    return _ACTIVE


def links() -> Tuple[Optional[LinkSpec], Optional[LinkSpec]]:
    """(intra, inter) of the active table; (None, None) without one —
    consumers fall back to the hand-set LinkSpec defaults."""
    t = _ACTIVE
    if t is None:
        return None, None
    return t.intra, t.inter


def device_flops() -> Optional[float]:
    t = _ACTIVE
    return t.device_flops if t is not None else None


def step_overhead_s() -> float:
    t = _ACTIVE
    return t.step_overhead_s if t is not None else 0.0


def memory_scale() -> float:
    t = _ACTIVE
    return t.memory_scale if t is not None else 1.0


def predicted_bubble(n_stages: int, n_microbatches: int) -> Optional[float]:
    t = _ACTIVE
    if t is None:
        return None
    return t.predicted_bubble(n_stages, n_microbatches)


# ---------------------------------------------------------------------------
# per-constant fitters
# ---------------------------------------------------------------------------

def fit_link(samples: Sequence[Mapping]
             ) -> Tuple[Optional[LinkSpec], Dict]:
    """Least-squares (alpha, beta) from ``collective_sample`` rows.

    Model: ``seconds = steps * alpha + wire_bytes * beta`` (the exact form
    :meth:`repro_torch.comms.topology.Topology.allreduce_time` prices flat
    schedules with; ``steps``/``wire_bytes`` come from
    :func:`repro_torch.comms.topology.allreduce_design`, so the regressors ARE
    the cost model's design matrix).  Returns ``(None, meta)`` on
    degenerate data: fewer than :data:`MIN_LINK_SAMPLES` rows, or a
    zero-variance design (all rows the same size/schedule) that makes the
    normal equations singular.
    """
    rows = [(float(s["steps"]), float(s["wire_bytes"]), float(s["seconds"]))
            for s in samples
            if s.get("seconds", 0) > 0 and s.get("steps", 0) > 0]
    meta: Dict = {"n_samples": len(rows)}
    if len(rows) < MIN_LINK_SAMPLES:
        meta["reason"] = (f"{len(rows)} usable collective samples "
                          f"(< {MIN_LINK_SAMPLES})")
        return None, meta
    ss = sum(s * s for s, _, _ in rows)
    ww = sum(w * w for _, w, _ in rows)
    sw = sum(s * w for s, w, _ in rows)
    st = sum(s * t for s, _, t in rows)
    wt = sum(w * t for _, w, t in rows)
    det = ss * ww - sw * sw
    if det <= 1e-9 * max(ss * ww, 1e-300):
        meta["reason"] = ("zero-variance design (every sample has the "
                          "same steps/wire ratio); cannot separate alpha "
                          "from beta")
        return None, meta
    alpha = (st * ww - wt * sw) / det
    beta = (ss * wt - sw * st) / det
    # physicality: negative coefficients mean the other term explains the
    # data — refit the remaining one alone rather than extrapolate.
    if alpha < 0:
        alpha, beta = 0.0, wt / ww
    if beta <= 0:
        beta, alpha = 0.0, st / ss
    if alpha <= 0 and beta <= 0:
        meta["reason"] = "fit collapsed to non-positive alpha and beta"
        return None, meta
    bandwidth = (1.0 / beta) if beta > 0 else 1e18   # beta == 0: pure alpha
    resid = [s * alpha + w * beta - t for s, w, t in rows]
    rms = math.sqrt(sum(r * r for r in resid) / len(rows))
    mean_t = sum(t for _, _, t in rows) / len(rows)
    meta["residual_rms_s"] = rms
    meta["residual_rms_rel"] = rms / max(mean_t, 1e-12)
    return LinkSpec(latency_s=alpha, bandwidth_Bps=bandwidth), meta


def fit_pipe(probe: Mapping) -> Tuple[Optional[float], Optional[float],
                                      Dict]:
    """(intercept a, tick b) of ``t(M) = a + b*M`` from one
    ``bubble_probe`` event (``microbatches`` + ``times_s`` lists).

    Least squares over the probe points (exact for the usual two); the
    intercept is clamped to >= 0 (a negative intercept is probe noise —
    steps cannot get cheaper as work is added).  ``(None, None, meta)``
    when the probe has < 2 points or a non-positive slope.
    """
    ms = [float(m) for m in probe.get("microbatches", [])]
    ts = [float(t) for t in probe.get("times_s", [])]
    meta: Dict = {"n_points": min(len(ms), len(ts))}
    if len(ms) < 2 or len(ts) < 2 or len(ms) != len(ts):
        meta["reason"] = "bubble probe has < 2 (M, t) points"
        return None, None, meta
    n = len(ms)
    mean_m = sum(ms) / n
    mean_t = sum(ts) / n
    var_m = sum((m - mean_m) ** 2 for m in ms)
    if var_m <= 0:
        meta["reason"] = "bubble probe points share one microbatch count"
        return None, None, meta
    b = sum((m - mean_m) * (t - mean_t) for m, t in zip(ms, ts)) / var_m
    if b <= 0:
        meta["reason"] = (f"non-positive per-microbatch slope {b:.3g}s "
                          "(probe noise dominates)")
        return None, None, meta
    a = max(0.0, mean_t - b * mean_m)
    resid = [a + b * m - t for m, t in zip(ms, ts)]
    meta["residual_rms_s"] = math.sqrt(sum(r * r for r in resid) / n)
    return a, b, meta


def fit_memory_scale(gauges: Mapping) -> Tuple[Optional[float], Dict]:
    """measured_peak / predicted_peak from the snapshot gauges.

    Prefers the RAW (uncalibrated) predicted gauge so refitting from an
    already-calibrated run cannot compound corrections.  Clamped to
    [0.1, 10] — a ratio outside that is a measurement bug, not a model
    correction.
    """
    from repro_torch.obs import report as report_mod
    meas = gauges.get(report_mod.MEASURED_PEAK_GAUGE)
    pred = (gauges.get(report_mod.PREDICTED_RAW_PEAK_GAUGE)
            or gauges.get(report_mod.PREDICTED_PEAK_GAUGE))
    meta: Dict = {"measured_peak_bytes": meas, "predicted_peak_bytes": pred}
    if not meas or not pred:
        meta["reason"] = "missing peak-memory gauges"
        return None, meta
    scale = max(0.1, min(10.0, float(meas) / float(pred)))
    return scale, meta


# ---------------------------------------------------------------------------
# cell reconstruction + the FLOPs inverse
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Cell:
    """The (config, mesh, shape) coordinates a snapshot was measured at —
    everything :func:`predicted_step_seconds_for_cell` needs."""

    cfg: object
    mesh_shape: Dict[str, int]
    global_batch: int
    seq_len: int
    num_microbatches: int = 1
    schedule: str = "gpipe"

    @property
    def n_devices(self) -> int:
        return math.prod(self.mesh_shape.values()) or 1

    @property
    def factorization(self) -> Tuple[int, int, int]:
        dp = 1
        for a in ("pod", "data"):
            dp *= self.mesh_shape.get(a, 1)
        return (dp, self.mesh_shape.get("model", 1),
                self.mesh_shape.get("pipe", 1))


def cell_from_meta(meta: Mapping) -> Cell:
    """Reconstruct the measured cell from a snapshot's ``meta`` block
    (``launch/train.py`` records arch/mesh/batch/seq/scale_down/... there
    exactly so snapshots stay self-describing for this fitter)."""
    from repro_torch.configs import get_config, scale_config
    missing = [k for k in ("arch", "mesh", "batch", "seq") if k not in meta]
    if missing:
        raise CalibrationDataError(
            f"snapshot meta lacks {missing} — re-measure with the current "
            f"launch/train.py (older snapshots are not self-describing)")
    cfg = get_config(meta["arch"])
    sd = int(meta.get("scale_down", 1) or 1)
    if sd > 1:
        cfg = scale_config(cfg, sd)
    return Cell(cfg=cfg, mesh_shape=dict(meta["mesh"]),
                global_batch=int(meta["batch"]), seq_len=int(meta["seq"]),
                num_microbatches=int(meta.get("microbatches", 1) or 1),
                schedule=meta.get("pp_schedule", "gpipe"))


def predicted_step_seconds_for_cell(cell: Cell, *, intra=None, inter=None,
                                    device_flops: Optional[float] = None,
                                    step_overhead_s: Optional[float] = None
                                    ) -> Optional[float]:
    """Planner-scored seconds for the cell's own (dp, tp, pp) — THE same
    formula the planner ranks candidates with, with the constants
    overridable so the fitter can evaluate trial values without touching
    the process-wide active table."""
    from repro_torch.core.planner import score_hybrid_candidates
    scores = score_hybrid_candidates(
        cell.cfg, cell.n_devices, global_batch=cell.global_batch,
        seq_len=cell.seq_len, num_microbatches=cell.num_microbatches,
        schedule=cell.schedule, intra=intra, inter=inter,
        device_flops=device_flops, step_overhead_s=step_overhead_s,
        check_memory=False)
    return scores.get(cell.factorization)


def fit_device_flops(cell: Cell, step_seconds: float, *, intra=None,
                     inter=None, step_overhead_s: float = 0.0
                     ) -> Tuple[Optional[float], Dict]:
    """Solve the effective per-device FLOPs/s so the planner's score for
    ``cell`` equals the measured ``step_seconds``.

    The score is monotone decreasing in the FLOPs constant (compute time
    is the only term it touches), so bisection finds the unique root.
    Returns ``(None, meta)`` when the non-compute terms (collectives,
    boundary transfers, fitted overhead) already exceed the measured time
    — then the link fit, not the FLOPs constant, is what's off.
    """
    meta: Dict = {"target_step_s": step_seconds}

    def pred(flops: float) -> Optional[float]:
        return predicted_step_seconds_for_cell(
            cell, intra=intra, inter=inter, device_flops=flops,
            step_overhead_s=step_overhead_s)

    lo, hi = 1e6, 1e24
    floor = pred(hi)      # compute ~ 0: the non-compute floor
    if floor is None:
        meta["reason"] = ("cell's (dp, tp, pp) is outside the planner's "
                          "scored factorizations")
        return None, meta
    if step_seconds <= floor:
        meta["reason"] = (f"non-compute terms ({floor:.4g}s) already "
                          f"exceed the measured step ({step_seconds:.4g}s)")
        return None, meta
    if pred(lo) < step_seconds:
        meta["reason"] = "measured step slower than the 1 MFLOP/s bound"
        return None, meta
    for _ in range(200):
        mid = math.sqrt(lo * hi)          # bisect in log space
        if pred(mid) > step_seconds:
            lo = mid
        else:
            hi = mid
        if hi / lo < 1 + 1e-9:
            break
    flops = math.sqrt(lo * hi)
    got = pred(flops)
    meta["residual_rel"] = abs(got - step_seconds) / max(step_seconds, 1e-12)
    return flops, meta


# ---------------------------------------------------------------------------
# the full fit
# ---------------------------------------------------------------------------

def fit(events: Sequence[Mapping], snapshot: Mapping, *,
        sources: Sequence[str] = ()) -> CalibrationTable:
    """One pass over a run's obs data -> a :class:`CalibrationTable`.

    ``events`` is the JSONL stream (``collective_sample`` rows feed the
    link fit, the last ``bubble_probe`` feeds the pipe fit); ``snapshot``
    is a ``BENCH_*.json``-shaped document (``meta`` locates the cell,
    ``metrics`` carries the steady-state step histogram and the peak
    gauges).  Every degenerate piece falls back to its hand-set default
    with a :class:`CalibrationWarning` and a row in
    ``provenance["warnings"]``.
    """
    warns: List[Dict[str, str]] = []
    residuals: Dict[str, float] = {}
    meta = snapshot.get("meta", {})
    metrics = snapshot.get("metrics", {})
    gauges = metrics.get("gauges", {})
    hists = metrics.get("histograms", {})

    # -- links --------------------------------------------------------------
    link_samples = [e for e in events
                    if e.get("kind") == "collective_sample"]
    link, link_meta = fit_link(link_samples)
    if link is None:
        _warn(warns, "links", link_meta.get("reason", "unfittable"))
    elif "residual_rms_rel" in link_meta:
        residuals["link_rms_rel"] = link_meta["residual_rms_rel"]

    # -- pipeline tick + overhead -------------------------------------------
    probes = [e for e in events if e.get("kind") == "bubble_probe"]
    n_stages = int(dict(meta.get("mesh", {})).get("pipe", 1) or 1)
    a = b = None
    if probes:
        a, b, pipe_meta = fit_pipe(probes[-1])
        if b is None:
            _warn(warns, "pipe", pipe_meta.get("reason", "unfittable"))
        else:
            residuals["pipe_rms_s"] = pipe_meta.get("residual_rms_s", 0.0)
    elif n_stages > 1:
        # a non-pipelined cell legitimately has no probe; a pipelined one
        # without it cannot fit the tick/overhead split
        _warn(warns, "pipe", "pipelined cell has no bubble_probe event")
    overhead = 0.0
    if a is not None and b is not None:
        # the structural (S-1)*b share of the intercept is the bubble;
        # what remains is fixed per-step host overhead (dispatch, the
        # loss device_get, python loop) the nominal model never priced.
        overhead = max(0.0, a - (n_stages - 1) * b)

    # -- memory scale -------------------------------------------------------
    scale, mem_meta = fit_memory_scale(gauges)
    if scale is None:
        _warn(warns, "memory_scale", mem_meta.get("reason", "unfittable"))
        scale = 1.0

    # -- effective FLOPs ----------------------------------------------------
    from repro_torch.obs import report as report_mod
    flops = None
    step_hist = hists.get(report_mod.MEASURED_STEP_HISTOGRAM, {})
    n_steady = int(step_hist.get("count", 0) or 0)
    if n_steady < MIN_STEADY_STEPS:
        _warn(warns, "device_flops",
              f"{n_steady} steady-state steps (< {MIN_STEADY_STEPS})")
    else:
        try:
            cell = cell_from_meta(meta)
        except CalibrationDataError as e:
            cell = None
            _warn(warns, "device_flops", str(e))
        if cell is not None:
            flops, flops_meta = fit_device_flops(
                cell, float(step_hist["p50"]), intra=link, inter=link,
                step_overhead_s=overhead)
            if flops is None:
                _warn(warns, "device_flops",
                      flops_meta.get("reason", "unfittable"))
            else:
                residuals["step_rel"] = flops_meta["residual_rel"]

    provenance = {
        "fitted_at": time.time(),
        "sources": list(sources),
        "arch": meta.get("arch"),
        "mesh": dict(meta.get("mesh", {})),
        "n_collective_samples": len(link_samples),
        "n_steady_steps": n_steady,
        "residuals": residuals,
        "warnings": warns,
    }
    return CalibrationTable(
        intra=link, inter=link,     # single-level host: one fitted link
        device_flops=flops, step_overhead_s=overhead,
        pipe_tick_s=b, pipe_intercept_s=a,
        memory_scale=scale, provenance=provenance)


def fit_from_files(jsonl_paths: Sequence[str],
                   snapshot_path: Optional[str] = None) -> CalibrationTable:
    """Fit from on-disk obs data: one or more JSONL streams plus an
    optional committed ``BENCH_*.json`` snapshot.  Without an explicit
    snapshot the stream's own final ``{"kind": "metrics"}`` document (the
    same shape) is used."""
    from repro_torch.obs.sink import read_jsonl
    events: List[Mapping] = []
    for p in jsonl_paths:
        events.extend(read_jsonl(p))
    sources = list(jsonl_paths)
    if snapshot_path is not None:
        with open(snapshot_path) as f:
            snapshot = json.load(f)
        sources.append(snapshot_path)
    else:
        snaps = [e for e in events if e.get("kind") == "metrics"]
        if not snaps:
            raise CalibrationDataError(
                "no snapshot: pass snapshot_path or a JSONL stream whose "
                "run wrote a final metrics document")
        snapshot = snaps[-1]
    sources = [os.path.abspath(p) for p in sources]
    return fit(events, snapshot, sources=sources)
