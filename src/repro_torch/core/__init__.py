"""repro_torch.core — the dMath distributed linear-algebra substrate on
``torch.distributed``.

Public surface (the reference's ``repro.core`` exports of these modules):

- :class:`~repro_torch.core.layout.Layout`, :func:`~repro_torch.core.layout.constrain`
- :class:`~repro_torch.core.distributed.Mesh`
- :class:`~repro_torch.core.dtensor.DistTensor` (+ global ``REGISTRY``)
- :func:`~repro_torch.core.redistribute.relayout` / ``relayout_explicit``
- :func:`~repro_torch.core.gemm.gemm_auto` and the named GEMM algorithms
- :mod:`~repro_torch.core.precision` policies, :mod:`~repro_torch.core.rng`
- :class:`~repro_torch.core.opcache.OpCache`,
  :class:`~repro_torch.core.autotune.AutoTuner`

- :class:`~repro_torch.core.planner.ParallelPlan`,
  :func:`~repro_torch.core.planner.plan_for` and the cost model's
  ``comms_plan_for``, ``score_comms_schedules``, ``grad_sync_topology``
  (the hybrid sweep ``score_hybrid_candidates`` / ``best_hybrid`` is in
  the module)
- :mod:`~repro_torch.core.memory` (budgets, the footprint model) and
  :mod:`~repro_torch.core.calibrate` (the fitter; imported on use)
- :mod:`~repro_torch.core.dry` (the dry trace on fake tensors; imported
  on use)
"""

from . import (autotune, gemm, memory, opcache, planner, precision,
               primitives, redistribute, rng)
from .distributed import Mesh
from .dtensor import REGISTRY, DistTensor, TensorRegistry
from .layout import Layout, best_divisor_axis, constrain
from .opcache import GLOBAL_CACHE, OpCache
from .planner import (ParallelPlan, approx_param_count, comms_plan_for,
                      grad_sync_topology, plan_for, score_comms_schedules)
from .precision import FULL, HALF_STORAGE, MIXED, Policy
from .redistribute import relayout, relayout_explicit, replicate
from .replication import (gathered, replicate_now, use_layout_of, zero_layout,
                          zero_layout_tree)

__all__ = [
    "Layout", "constrain", "best_divisor_axis", "Mesh",
    "DistTensor", "REGISTRY", "TensorRegistry",
    "relayout", "relayout_explicit", "replicate",
    "ParallelPlan", "plan_for", "comms_plan_for", "score_comms_schedules",
    "grad_sync_topology", "approx_param_count",
    "Policy", "FULL", "MIXED", "HALF_STORAGE",
    "OpCache", "GLOBAL_CACHE",
    "zero_layout", "zero_layout_tree", "gathered", "replicate_now",
    "use_layout_of",
    "gemm", "precision", "redistribute", "memory", "opcache", "planner",
    "autotune", "rng", "primitives",
]
