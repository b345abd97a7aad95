"""ExecutablePlan and the train-step capability matrix, ported from the
reference's ``api/plan.py`` for the paths the port has: ``gspmd`` (one
rank, or a ``(data, model)`` mesh with the implicit gradient sync) and
``comms`` (a data-parallel group)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

#: path -> what it supports; ``select_path`` picks the row.
CAPABILITIES: Dict[str, Dict[str, Any]] = {
    "gspmd": dict(
        title="plain / ZeRO (GSPMD)",
        axes="pod x data x model — DP x TP, FSDP/ZeRO storage sharding",
        schedules=(),
        grad_sync="implicit GSPMD psum over the batch axes",
        selected_when="no pipe axis and no CommsPlan (the default path)",
    ),
    "comms": dict(
        title="explicit comms sync",
        axes="pod x data only — every non-batch mesh axis must be 1",
        schedules=(),
        grad_sync="repro_torch.comms bucketed (optionally bf16/int8-"
                  "compressed) ring | rsag | tree | hierarchical "
                  "all-reduce over the batch axes",
        selected_when="a CommsPlan is attached and there is no pipe axis "
                      "(comms='auto' attaches one on a pure-DP mesh)",
    ),
}


def select_path(mesh, *, comms=None, pipeline=None) -> str:
    """The dispatch rule, as the reference's: a pipe axis (or a
    PipelineSpec) wins (not ported yet), then an attached CommsPlan
    selects the explicit path, else the gspmd path.  ``mesh`` is anything
    with a ``shape`` mapping (or the mapping itself)."""
    shape = dict(mesh.shape) if hasattr(mesh, "shape") else dict(mesh)
    if pipeline is not None or shape.get("pipe", 1) > 1:
        raise NotImplementedError("the pipeline path is not ported yet "
                                  "(ROADMAP queue 1, item 10)")
    return "comms" if comms is not None else "gspmd"


@dataclasses.dataclass
class ExecutablePlan:
    """A dispatchable train plan, ``Session.plan``'s return value, with
    its memory verdict: the per-stage footprints against the budget it
    was priced against and, when the planner's sweep ran, its scores
    and per-candidate refusals."""

    cfg: Any                              # ModelConfig
    model: Any                            # repro_torch.models.Model
    path: str                             # gspmd | comms
    global_batch: int
    seq_len: int
    num_microbatches: int = 1
    adamw: Any = None
    comms: Any = None                     # CommsPlan routed to the step
    n_ranks: int = 1
    mesh: Any = None                      # the Session's mesh
    parallel: Any = None                  # ParallelPlan (plan_for)
    schedule: str = "gpipe"               # pipeline schedule (none yet)
    pipeline: Any = None                  # PipelineSpec (not ported)
    budget: Any = None                    # MemoryBudget it was priced against
    footprints: Tuple = ()                # per-stage Footprints
    refused: Mapping = dataclasses.field(default_factory=dict)
    scores: Optional[Mapping] = None      # sweep scores when it ran

    def fits(self) -> bool:
        if not self.footprints or self.budget is None:
            return True
        return all(f.fits(self.budget) for f in self.footprints)
