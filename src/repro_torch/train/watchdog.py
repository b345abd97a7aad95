"""Straggler detection: step-time watchdog (1000+-node posture, DESIGN §7),
copied from the reference's ``train/watchdog.py``, which imports no
framework.

On a real fleet slow steps correlate with failing hosts/links; the watchdog
keeps an EMA + variance of step time and flags z-score outliers.  The train
loop consults it to (a) log the anomaly, (b) trigger an early checkpoint —
the cheap insurance dMath's checkpoint-restart requirement (§2 req. e)
asks for.  Action is delivered through ``on_anomaly``: the launch driver
installs a hook that records the anomaly as an obs event and fires the
early checkpoint, so a flagged step leaves both a trace record and a
restart point instead of only a log line.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional


@dataclasses.dataclass
class StepTimeWatchdog:
    alpha: float = 0.1            # EMA coefficient
    z_threshold: float = 4.0
    warmup_steps: int = 5
    mean: float = 0.0
    var: float = 0.0
    n: int = 0
    ignored: int = 0              # non-finite / non-positive observations
    anomalies: List[int] = dataclasses.field(default_factory=list)
    #: called as on_anomaly(step, dt, msg) for every flagged step
    on_anomaly: Optional[Callable[[int, float, str], None]] = None

    def reset(self) -> None:
        """Forget the step-time distribution (NOT the hook).  Called on
        restart/resume: the EMA and variance were learned on the previous
        attempt's hardware and mesh — carrying them onto a re-planned
        (possibly smaller, slower-per-step) fleet would flag every healthy
        step or mask every real straggler."""
        self.mean = 0.0
        self.var = 0.0
        self.n = 0
        self.ignored = 0
        self.anomalies = []

    def observe(self, step: int, dt: float) -> Optional[str]:
        # a hung-then-killed step reports inf (or a clock glitch reports
        # <= 0); folding either into the EMA/variance poisons the
        # estimator forever, so such observations are counted and dropped
        if not math.isfinite(dt) or dt <= 0.0:
            self.ignored += 1
            return None
        self.n += 1
        if self.n <= self.warmup_steps:
            # prime the estimates, never flag during compile/warmup
            self.mean = dt if self.n == 1 else \
                (1 - self.alpha) * self.mean + self.alpha * dt
            self.var = max(self.var, (dt - self.mean) ** 2)
            return None
        std = math.sqrt(self.var) + 1e-9
        z = (dt - self.mean) / std
        self.mean = (1 - self.alpha) * self.mean + self.alpha * dt
        self.var = (1 - self.alpha) * self.var \
            + self.alpha * (dt - self.mean) ** 2
        if z > self.z_threshold:
            self.anomalies.append(step)
            msg = (f"straggler suspected at step {step}: "
                   f"{dt * 1e3:.1f} ms vs EMA {self.mean * 1e3:.1f} ms "
                   f"(z={z:.1f})")
            if self.on_anomaly is not None:
                self.on_anomaly(step, dt, msg)
            return msg
        return None
