"""ExecutablePlan + the train-step capability matrix, ported from the
reference's ``api/plan.py``.

One documented dispatch rule: ``Session.train_step`` selects exactly one
of the paths below from the mesh and the plan.  The matrix is the
reference's, word for word, and the port dispatches every row.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

#: The capability matrix: path x supported mesh axes x schedule x grad
#: sync.  ``select_path`` picks the row; each builder still validates its
#: own axis restriction and raises with the same wording it always had.
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
        grad_sync="repro.comms bucketed (optionally bf16/int8-compressed) "
                  "ring | rsag | tree | hierarchical all-reduce",
        selected_when="a CommsPlan is attached and there is no pipe axis",
    ),
    "pipeline": dict(
        title="pipeline (GPipe / 1F1B)",
        axes="pod x data x pipe — non-batch, non-pipe axes must be 1",
        schedules=("gpipe", "1f1b"),
        grad_sync="pmean over the batch axes, or the CommsPlan schedules "
                  "when one is attached",
        selected_when="the mesh has a pipe axis of size > 1 (or an "
                      "explicit PipelineSpec is passed)",
    ),
}


def capability_table() -> str:
    """The matrix rendered as a markdown table (README / --help)."""
    rows = ["| path | supported axes | schedules | gradient sync |",
            "|------|----------------|-----------|---------------|"]
    for key, cap in CAPABILITIES.items():
        sched = ", ".join(cap["schedules"]) or "—"
        rows.append(f"| `{key}` ({cap['title']}) | {cap['axes']} | {sched} "
                    f"| {cap['grad_sync']} |")
    return "\n".join(rows)


def select_path(mesh, *, comms=None, pipeline=None) -> str:
    """The dispatch rule, as the reference's: a pipe axis (or a
    PipelineSpec) wins (the pipeline path), then an attached CommsPlan
    selects the explicit path, else the gspmd path.  ``mesh`` is anything
    with a ``shape`` mapping (or the mapping itself)."""
    shape = dict(mesh.shape) if hasattr(mesh, "shape") else dict(mesh)
    if pipeline is not None or shape.get("pipe", 1) > 1:
        return "pipeline"
    return "comms" if comms is not None else "gspmd"


@dataclasses.dataclass
class ExecutablePlan:
    """A dispatchable plan, ``Session.plan``'s return value: the config,
    the :class:`~repro_torch.core.planner.ParallelPlan`, the built model,
    the dispatch path (a serve kind's path is the kind), the shape cell,
    the resolved microbatch count and the memory verdict (the per-stage
    footprints against the budget they were priced against and, when the
    planner's sweep ran, its scores and per-candidate refusals)."""

    cfg: Any                              # ModelConfig
    model: Any                            # repro_torch.models.Model
    path: str                             # gspmd | comms | pipeline | <kind>
    shape: Any                            # ShapeConfig
    num_microbatches: int = 1
    adamw: Any = None
    comms: Any = None                     # CommsPlan routed to the step
    n_ranks: int = 1
    mesh: Any = None                      # the Session's mesh
    parallel: Any = None                  # ParallelPlan (plan_for)
    schedule: str = "gpipe"               # pipeline schedule (if any)
    pipeline: Any = None                  # PipelineSpec (resolved)
    budget: Any = None                    # MemoryBudget it was priced against
    footprints: Tuple = ()                # per-stage Footprints (train only)
    refused: Mapping = dataclasses.field(default_factory=dict)
    scores: Optional[Mapping] = None      # sweep scores when it ran

    # -- derived views -----------------------------------------------------
    @property
    def kind(self) -> str:
        return self.shape.kind

    @property
    def global_batch(self) -> int:
        return self.shape.global_batch

    @property
    def seq_len(self) -> int:
        return self.shape.seq_len

    def capability(self) -> Optional[Dict[str, Any]]:
        return CAPABILITIES.get(self.path)

    def fits(self) -> bool:
        if not self.footprints or self.budget is None:
            return True
        return all(f.fits(self.budget) for f in self.footprints)

    def batch_specs(self):
        """(``meta`` stand-ins, layouts) for the step's data inputs."""
        from repro_torch.configs import input_specs
        return input_specs(self.cfg, self.shape, self.mesh, self.parallel)

    def describe(self) -> str:
        cap = self.capability()
        lines = [f"ExecutablePlan[{self.cfg.name} {self.shape.name}] "
                 f"path={self.path}"
                 + (f" ({cap['title']})" if cap else ""),
                 f"  mesh {dict(self.mesh.shape)}  "
                 f"microbatches={self.num_microbatches}"]
        if self.pipeline is not None:
            lines.append(f"  pipeline: {self.pipeline.n_stages} stages "
                         f"({self.pipeline.schedule}), bubble "
                         f"{self.pipeline.bubble_fraction():.2f}")
        if self.comms is not None:
            lines.append(f"  comms: {self.comms.schedule} schedule, bucket "
                         f"{self.comms.bucket_bytes >> 20} MiB")
        if self.footprints and self.budget is not None:
            from repro_torch.core import memory as mem_mod
            peak = mem_mod.peak_stage_footprint(self.footprints)
            lines.append(f"  memory: predicted peak "
                         f"{peak.total / mem_mod.GIB:.3f} GiB/device vs "
                         f"{self.budget.describe()} -> "
                         f"{'fits' if self.fits() else 'OOM'}")
        return "\n".join(lines)
