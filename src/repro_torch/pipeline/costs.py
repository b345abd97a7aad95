"""Analytic cost model for inter-layer pipeline parallelism, a copy of
the reference's ``pipeline/costs.py`` (it uses no framework).

- **bubble fraction**: the idle share of a GPipe/1F1B schedule, (S-1) /
  (M+S-1) for S stages and M microbatches;
- **stage-boundary wire bytes**: each microbatch's activation block
  crosses every stage boundary once forward and once backward.

``core/planner.py`` scores (dp, tp, pp) candidates with these formulas,
``core/memory.py`` sizes a stage's stash with them, and the schedules'
point-to-point bytes are :func:`boundary_wire_bytes` exactly
(``pipeline/schedule.py``).  :data:`DEVICE_FLOPS` is the
reference's nominal per-device rate, not the H100's: a fitted rate comes
in through :mod:`repro_torch.core.calibrate`.
"""

from __future__ import annotations

from typing import Optional

#: the reference's nominal per-device rate used to turn FLOPs into
#: seconds (not a card's); only its magnitude relative to the alpha-beta
#: comms terms matters for ranking candidates.
DEVICE_FLOPS = 100e12


def device_flops() -> float:
    """Effective per-device FLOPs/s: the fitted value from the active
    calibration table when one is installed
    (:func:`repro_torch.core.calibrate.set_active`), else the nominal
    :data:`DEVICE_FLOPS`."""
    from repro_torch.core import calibrate
    fitted = calibrate.device_flops()
    return fitted if fitted else DEVICE_FLOPS


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    """Idle fraction of a GPipe/1F1B pipeline: (S-1)/(M+S-1)."""
    if n_stages <= 1:
        return 0.0
    m = max(1, n_microbatches)
    return (n_stages - 1) / (m + n_stages - 1)


def min_stash_slots(n_stages: int, n_microbatches: int) -> int:
    """Stage-input slots the explicit 1F1B ring buffer needs: min(M, 2S-1).

    The tick-parallel 1F1B in ``schedule.py`` runs one forward and one
    backward slot per tick, so stage s forwards microbatch m at tick m + s
    and backs it at tick m + 2(S-1) - s: the stage's input must stay live
    for 2(S-1) - 2s intervening forwards.  The worst stage (s = 0) needs
    2(S-1) + 1 slots; fewer than M microbatches can ever be live.  (The
    classic throttled 1F1B bound is min(M, S) — reaching it in SPMD would
    double the tick count, trading compiled step work for stash.)
    """
    if n_stages <= 1:
        return 1
    return min(max(1, n_microbatches), 2 * n_stages - 1)


def in_flight_microbatches(schedule: Optional[str], n_stages: int,
                           n_microbatches: int) -> int:
    """Microbatches whose activations a stage keeps live at peak.

    GPipe stashes every forward until the all-backwards phase (the scan
    transpose replays all M); the explicit 1F1B stashes only stage
    *inputs* (the ring) and recomputes one microbatch's body per backward
    slot, so its per-layer activation term is a single microbatch.
    """
    m = max(1, n_microbatches)
    if n_stages <= 1 or schedule is None:
        return 1
    if schedule == "gpipe":
        return m
    if schedule == "1f1b":
        return 1
    raise ValueError(f"unknown pipeline schedule {schedule!r}")


def boundary_act_bytes(microbatch: int, seq_len: int, d_model: int,
                       itemsize: int = 2) -> int:
    """Bytes of ONE microbatch's residual-stream activation block — the
    tensor a ``ppermute`` moves across a stage boundary (bf16 by default)."""
    return microbatch * seq_len * d_model * itemsize


def boundary_wire_bytes(act_bytes: int, n_stages: int,
                        n_microbatches: int, backward: bool = True) -> int:
    """Total stage-boundary bytes per step, summed over the S-1 boundaries.

    Forward sends every microbatch across every boundary once; the backward
    pass sends a same-shaped cotangent back (``backward=False`` prices an
    inference/forward-only pipeline).
    """
    if n_stages <= 1:
        return 0
    passes = 2 if backward else 1
    return passes * act_bytes * n_microbatches * (n_stages - 1)


def boundary_seconds(act_bytes: int, n_stages: int, n_microbatches: int,
                     link, backward: bool = True) -> float:
    """Alpha-beta time of the stage-boundary transfers on the critical path.

    A ppermute is point-to-point: every boundary crossing off the critical
    path overlaps with compute, so only the M + S - 2 transfers on the
    critical chain are charged (times 2 with a backward pass).
    """
    if n_stages <= 1:
        return 0.0
    passes = 2 if backward else 1
    hops = max(1, n_microbatches + n_stages - 2)
    per_hop = link.latency_s + act_bytes / link.bandwidth_Bps
    return passes * hops * per_hop


def pipeline_step_seconds(compute_s: float, n_stages: int,
                          n_microbatches: int, act_bytes: int,
                          link, backward: bool = True) -> float:
    """Cost-model seconds for one pipelined step.

    ``compute_s`` is the bubble-free compute time (all stages busy); the
    bubble stretches it by 1/(1 - bubble) and the boundary transfers add
    their critical-path alpha-beta term.
    """
    bf = bubble_fraction(n_stages, n_microbatches)
    return (compute_s / max(1e-12, 1.0 - bf)
            + boundary_seconds(act_bytes, n_stages, n_microbatches, link,
                               backward=backward))
