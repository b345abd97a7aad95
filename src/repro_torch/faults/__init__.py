"""repro_torch.faults — deterministic fault injection + the exceptions the
resilient control loops recover from.

dMath's §2 requirement (e) is checkpoint-restart on a fleet where nodes
fail and links degrade.  This package makes every such failure a *named,
seeded, replayable event* so the recovery paths in
:mod:`repro_torch.train.resilience` and :mod:`repro_torch.serve` are
testable on CPU without a real fleet: a :class:`FaultPlan` lists
:class:`FaultSpec`\\ s (seam + step + magnitude), the instrumented seams
consult it, and the drill benchmark asserts zero unrecovered
injections.  A copy of the reference's package, which imports no
framework.
"""

from .inject import (SEAMS, CollectiveTimeout, FaultPlan, FaultSpec,
                     HostCrash, InjectedFault, arm_engine, get_active,
                     set_active, trace_seam, write_torn_checkpoint)

__all__ = [
    "SEAMS", "FaultSpec", "FaultPlan",
    "InjectedFault", "CollectiveTimeout", "HostCrash",
    "get_active", "set_active", "trace_seam",
    "arm_engine", "write_torn_checkpoint",
]
