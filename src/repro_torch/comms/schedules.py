"""Explicit all-reduce schedules over a ``torch.distributed`` group,
ported from the reference's ``comms/schedules.py``.

Only ``psum`` is ported.  A floating sum adds the ranks in rank order,
as XLA's all-reduce does (``(x0 + x1) + x2``, a 16-bit type in fp32 and
rounded once), so a group of any size gives the reference's bits.  A
backend's ring starts each chunk's sum at another rank, which differs
from three ranks on: there :func:`ordered_sum` gathers the group's
tensors and adds them in order, at (n - 1) tensors received per rank
where a ring moves 2 (n - 1) / n of one, and n copies held at once.
Two addends sum the same in either order, so a group of two, like
integer sums (exact in any order) and MAX, goes to
``torch.distributed.all_reduce``: on two gloo ranks sharing an H100,
over qwen2-0.5b's 15 gradient leaves, the backend's sum took 0.60–0.64
of the gathered one's time and a fifth to a quarter of its device
memory, for the same bits (``scripts/gloo_sum_cost.py``).  The reference's ring, rsag,
tree and hierarchical schedules (``ppermute``/``psum_scatter``
dataflows) wait for the distributed substrate (ROADMAP queue 1, item 8).

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

from repro_torch.core import precision


UNPORTED = ("ring", "rsag", "tree", "hier")


def all_reduce(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None,
               schedule: str = "psum", op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Reduce ``x`` over the group (sum by default) by schedule name and
    return the result in ``x``'s dtype: a new tensor for a floating sum
    (``x`` is left as it is), ``x`` reduced in place otherwise."""
    if schedule in UNPORTED:
        raise NotImplementedError(
            f"schedule {schedule!r} is not ported yet (ROADMAP queue 1, "
            "item 8); use 'psum'")
    if schedule != "psum":
        raise ValueError(f"unknown schedule {schedule!r}")
    if x.is_floating_point():
        if op == dist.ReduceOp.SUM and dist.get_world_size(group) > 2:
            return ordered_sum(x, group)
        x = x.clone()             # a floating result is a new tensor
    dist.all_reduce(x, op=op, group=group)
    return x


def ordered_sum(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None
                ) -> torch.Tensor:
    """The group's sum of ``x`` added in rank order, a 16-bit type in fp32
    and rounded once: every rank gathers the group's tensors and adds
    them, so every rank gets the same bits, the reference's."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    acc = parts[0].to(torch.promote_types(x.dtype, torch.float32))
    for p in parts[1:]:
        acc += p
    return acc.to(x.dtype)


def pmean(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None
          ) -> torch.Tensor:
    """The group mean as XLA compiles the reference's ``pmean``: the sum,
    rounded to ``x``'s dtype, times fl32(1/n) (a 16-bit sum widened for
    the multiply and rounded once more)."""
    n = dist.get_world_size(group)
    return precision.div_count(all_reduce(x, group), n)
