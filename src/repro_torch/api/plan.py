"""ExecutablePlan and the train-step capability matrix, ported from the
reference's ``api/plan.py`` for the paths the port has: ``gspmd`` (one
rank) and ``comms`` (a data-parallel group)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

#: path -> what it supports; ``select_path`` picks the row.
CAPABILITIES: Dict[str, Dict[str, Any]] = {
    "gspmd": dict(
        title="one rank",
        axes="one rank: no gradient sync",
        schedules=(),
        grad_sync="none (the reference's implicit GSPMD psum over the "
                  "batch axes has nothing to reduce on one rank)",
        selected_when="no CommsPlan (comms='off' or None)",
    ),
    "comms": dict(
        title="explicit comms sync",
        axes="a data-parallel torch.distributed group",
        schedules=("psum",),
        grad_sync="repro_torch.comms bucketed (optionally bf16/int8-"
                  "compressed) all-reduce over the group",
        selected_when="a CommsPlan is attached (comms='auto' attaches one "
                      "on every group: the port's paths are data-parallel)",
    ),
}


def select_path(*, comms=None, pipeline=None) -> str:
    """The dispatch rule: a pipeline wins (not ported yet), then an
    attached CommsPlan selects the explicit path, else one rank."""
    if pipeline is not None:
        raise NotImplementedError("the pipeline path is not ported yet "
                                  "(ROADMAP queue 1, item 10)")
    return "comms" if comms is not None else "gspmd"


@dataclasses.dataclass
class ExecutablePlan:
    """A dispatchable train plan: ``Session.plan``'s return value."""

    cfg: Any                              # ModelConfig
    model: Any                            # repro_torch.models.Model
    path: str                             # gspmd | comms
    global_batch: int
    seq_len: int
    num_microbatches: int = 1
    adamw: Any = None
    comms: Any = None                     # CommsPlan routed to the step
    n_ranks: int = 1
