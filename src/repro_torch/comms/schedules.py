"""Explicit all-reduce schedules over a ``torch.distributed`` group,
ported from the reference's ``comms/schedules.py``.

Only ``psum`` is ported: ``torch.distributed.all_reduce`` over the group,
whose backend picks the wire pattern.  The reference's ring, rsag, tree
and hierarchical schedules (``ppermute``/``psum_scatter`` dataflows) wait
for the distributed substrate (ROADMAP queue 1, item 8).

On a gloo group a CUDA tensor goes to the collective as it is: gloo
stages it through host memory and reduces there (checked for int32 SUM
and fp32 MAX on PyTorch 2.11 with CUDA 12.8), so that copy is the wire's
first and last hop.  This is how the train path runs two ranks on one
card, where NCCL refuses two ranks on one device; on an NCCL group, for
ranks that each have their own card, the same call runs on the device.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

UNPORTED = ("ring", "rsag", "tree", "hier")


def all_reduce(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None,
               schedule: str = "psum", op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Reduce ``x`` over the group (sum by default) by schedule name, in
    place, and return it."""
    if schedule in UNPORTED:
        raise NotImplementedError(
            f"schedule {schedule!r} is not ported yet (ROADMAP queue 1, "
            "item 8); use 'psum'")
    if schedule != "psum":
        raise ValueError(f"unknown schedule {schedule!r}")
    dist.all_reduce(x, op=op, group=group)
    return x
