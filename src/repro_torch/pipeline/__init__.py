"""Pipeline parallelism (the third hybrid axis), ported from the
reference's ``repro.pipeline``:

- :mod:`~repro_torch.pipeline.partition`: the memory-balanced contiguous
  stage partitioner over the layer stack (``core/memory.py`` bytes);
- :mod:`~repro_torch.pipeline.spec`: :class:`PipelineSpec`, carried on
  :class:`repro_torch.core.planner.ParallelPlan`, and the param-spec
  rewrites that put the stacked layer leaves on the ``pipe`` mesh axis;
- :mod:`~repro_torch.pipeline.schedule`: the GPipe and 1F1B microbatch
  schedules, activations and cotangents crossing stage boundaries
  through ``core.distributed.exchange``;
- :mod:`~repro_torch.pipeline.costs`: the bubble fraction and the
  stage-boundary wire bytes, shared with ``core/planner.py`` and the
  memory model.

``train/step.py``'s :func:`~repro_torch.train.step.pipeline_train_step`
is the executable entry point; ``launch/train.py`` and
``launch/dryrun.py`` take a ``--pp`` degree.
"""

from . import costs, partition, schedule, spec
from .costs import (boundary_act_bytes, boundary_wire_bytes,
                    bubble_fraction, in_flight_microbatches,
                    min_stash_slots, pipeline_step_seconds)
from .partition import StagePartition, partition_layers, partition_model
from .schedule import (SCHEDULE_FNS, gpipe_grads, gpipe_loss,
                       one_f_one_b_grads)
from .spec import (PipelineSpec, pipeline_init_state, pipeline_param_specs,
                   pipeline_state_sds, pipeline_state_shardings,
                   pipeline_state_specs)

__all__ = [
    "costs", "partition", "schedule", "spec",
    "PipelineSpec", "StagePartition",
    "partition_layers", "partition_model",
    "bubble_fraction", "boundary_act_bytes", "boundary_wire_bytes",
    "pipeline_step_seconds", "in_flight_microbatches", "min_stash_slots",
    "gpipe_loss", "gpipe_grads", "one_f_one_b_grads", "SCHEDULE_FNS",
    "pipeline_param_specs", "pipeline_state_specs",
    "pipeline_state_shardings", "pipeline_state_sds",
    "pipeline_init_state",
]
