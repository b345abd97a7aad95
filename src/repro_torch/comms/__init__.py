"""Gradient synchronization over ``torch.distributed``: the all-reduce
schedules (psum, ring, rsag, tree, hier), the two-level topology cost
model that picks them, bucketing, the bf16/int8 wire formats and
:class:`CommsPlan`."""

from .plan import CommsPlan, sync_tree
from .topology import (SCHEDULES, LinkSpec, Topology, allreduce_design,
                       topology_from_mesh)

__all__ = ["CommsPlan", "sync_tree", "SCHEDULES", "LinkSpec", "Topology",
           "allreduce_design", "topology_from_mesh"]
