"""repro_torch.core — the dMath distributed linear-algebra substrate on
``torch.distributed``.

Public surface (the reference's ``repro.core`` exports of these modules):

- :class:`~repro_torch.core.layout.Layout`, :func:`~repro_torch.core.layout.constrain`
- :class:`~repro_torch.core.distributed.Mesh`
- :class:`~repro_torch.core.dtensor.DistTensor` (+ global ``REGISTRY``)
- :func:`~repro_torch.core.redistribute.relayout` / ``relayout_explicit``
- :func:`~repro_torch.core.gemm.gemm_auto` and the named GEMM algorithms
- :mod:`~repro_torch.core.precision` policies, :mod:`~repro_torch.core.rng`
- :class:`~repro_torch.core.opcache.OpCache`

The planner's layout part is :mod:`~repro_torch.core.planner`
(``ParallelPlan``, ``plan_for``); its hybrid sweep, the memory model and
the autotuner wait for ROADMAP queue 1, item 9.
"""

from . import gemm, opcache, precision, primitives, redistribute, rng
from .distributed import Mesh
from .dtensor import REGISTRY, DistTensor, TensorRegistry
from .layout import Layout, best_divisor_axis, constrain
from .opcache import GLOBAL_CACHE, OpCache
from .precision import FULL, HALF_STORAGE, MIXED, Policy
from .redistribute import relayout, relayout_explicit, replicate
from .replication import (gathered, replicate_now, use_layout_of, zero_layout,
                          zero_layout_tree)

__all__ = [
    "Layout", "constrain", "best_divisor_axis", "Mesh",
    "DistTensor", "REGISTRY", "TensorRegistry",
    "relayout", "relayout_explicit", "replicate",
    "Policy", "FULL", "MIXED", "HALF_STORAGE",
    "OpCache", "GLOBAL_CACHE",
    "zero_layout", "zero_layout_tree", "gathered", "replicate_now",
    "use_layout_of",
    "gemm", "precision", "redistribute", "opcache", "rng", "primitives",
]
