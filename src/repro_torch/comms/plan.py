"""CommsPlan: how gradients cross the wire, ported from the reference's
``comms/plan.py``.

A :class:`CommsPlan` names the schedule, the wire dtype (fp32 / bf16 /
int8) and the bucket size; :func:`sync_tree` runs it on a gradient dict
over a ``torch.distributed`` group (the reference runs it inside a
``shard_map`` body over mesh axes).  With telemetry on
(:func:`repro_torch.obs.get_active`), every sync adds its buckets and
credited wire bytes to the ``comms.*`` counters and writes a
``comms_sync`` event: the reference records them once per compile of its
step, the port once per step it runs, so a counter over the run divided
by the steps is the reference's per-step figure.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import torch
import torch.distributed as dist

from repro_torch import obs as obs_mod
from repro_torch.core import precision

from . import bucketer, compressed


@dataclasses.dataclass(frozen=True)
class CommsPlan:
    """Declarative gradient-synchronization policy for one training cell."""

    schedule: str = "auto"               # auto -> psum for a group of one
    wire_dtype: Optional[str] = None     # None (fp32) | "bf16" | "int8"
    bucket_bytes: int = bucketer.DEFAULT_BUCKET_BYTES
    mean: bool = True                    # pmean (grads) vs psum semantics

    def resolve(self, n_ranks: int) -> str:
        """The concrete schedule for a group of ``n_ranks``.  ``auto``
        resolves to ``psum`` for a group of one, as the reference's cost
        model does on a one-device mesh (every score is 0); for a larger
        group the reference's model scores the explicit schedules (it
        picks ``tree`` at 2 ranks), which are not ported yet."""
        if self.schedule != "auto":
            return self.schedule
        if n_ranks == 1:
            return "psum"
        raise NotImplementedError(
            "schedule='auto' on a group of more than one rank needs the "
            "topology cost model and the explicit schedules (ROADMAP "
            "queue 1, item 8); pass schedule='psum'")


def sync_tree(grads: Mapping[str, torch.Tensor], plan: CommsPlan,
              group: Optional[dist.ProcessGroup] = None
              ) -> Dict[str, torch.Tensor]:
    """Synchronize a gradient dict over ``group``: bucket -> (compress ->)
    reduce per bucket -> unbucket.  With ``plan.mean`` the result is the
    group mean (each bucket's sum divided by the group size, in fp32),
    otherwise the sum; leaves come back in their own dtypes.  The mean is
    the reference's ``b / n`` as XLA compiles it: a multiply by fl32(1/n)
    in the bucket's dtype (:func:`precision.div_count`).

    A narrowing wire always packs with the fused prologue (the bucket
    narrows, or yields its absmax, in the packing pass), so a CUDA
    gradient always meets the quantize kernel.  The reference also keeps
    an unfused pack; the two are bitwise equal by construction (a cast
    commutes with concatenation, a max of maxes is exact), which the
    tests hold against the reference's unfused path."""
    n = dist.get_world_size(group)
    sched = plan.resolve(n)
    bplan = bucketer.plan_buckets(grads, plan.bucket_bytes)
    fused = plan.wire_dtype in ("bf16", "int8")
    if fused:
        buckets, absmaxes = bucketer.flatten_buckets_fused(
            bplan, grads, plan.wire_dtype)
    else:
        buckets, absmaxes = bucketer.flatten_buckets(bplan, grads), None
    obs = obs_mod.get_active()
    if obs.enabled:
        ratio = compressed.WIRE_RATIO.get(plan.wire_dtype, 1.0)
        payload = int(sum(4 * bplan.bucket_sizes[i]
                          for i in range(bplan.num_buckets)) * ratio)
        obs.counter(f"comms.{sched}.buckets").inc(len(buckets))
        obs.counter(f"comms.{sched}.wire_bytes").inc(payload)
        obs.counter("comms.wire_bytes").inc(payload)
        if fused:
            obs.counter("comms.fused_pack").inc(len(buckets))
        obs.event("comms_sync", schedule=sched,
                  wire_dtype=plan.wire_dtype or "fp32",
                  buckets=len(buckets), wire_bytes=payload,
                  fused=fused, ranks=n)
    reduced = []
    for i in range(len(buckets)):
        b, buckets[i] = buckets[i], None         # free each bucket once sent
        r = compressed.wire_all_reduce(
            b, group, sched, plan.wire_dtype,
            absmax=absmaxes[i] if absmaxes is not None else None,
            out_dtype=bplan.dtype)
        if plan.mean:
            r = precision.div_count(r, n)
        reduced.append(r)
    return bucketer.unflatten_buckets(bplan, reduced)
