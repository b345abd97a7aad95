"""CommsPlan: how gradients cross the wire, ported from the reference's
``comms/plan.py``.

A :class:`CommsPlan` names the schedule (``psum`` | ``ring`` | ``rsag`` |
``tree`` | ``hier`` | ``auto``), the wire dtype (fp32 / bf16 / int8), the
bucket size and the fast axis of ``hier``; :meth:`CommsPlan.resolve`
turns ``auto`` into a schedule through the topology cost model
(:mod:`repro_torch.comms.topology`), and :func:`sync_tree` runs the plan
on a gradient dict over axes of a
:class:`~repro_torch.core.distributed.Mesh` (the reference runs it
inside a ``shard_map`` body over the same axes).  With telemetry on
(:func:`repro_torch.obs.get_active`), every sync adds its buckets and
credited wire bytes to the ``comms.*`` counters and writes a
``comms_sync`` event: the reference records them once per compile of its
step, the port once per step it runs, so a counter over the run divided
by the steps is the reference's per-step figure.

A narrowing wire always packs with the fused prologue (the reference
also keeps an unfused pack, chosen by its ``fused`` field; the two are
bitwise equal by construction, which the tests hold).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch import obs as obs_mod
from repro_torch.core import precision

from . import bucketer, compressed, topology as topo_mod


@dataclasses.dataclass(frozen=True)
class CommsPlan:
    """Declarative gradient-synchronization policy for one training cell."""

    schedule: str = "auto"               # auto -> the cost model picks
    wire_dtype: Optional[str] = None     # None (fp32) | "bf16" | "int8"
    bucket_bytes: int = bucketer.DEFAULT_BUCKET_BYTES
    mean: bool = True                    # pmean (grads) vs psum semantics
    intra_axis: str = "model"            # fast axis for "hier"

    def resolve(self, mesh, nbytes: int,
                topo: Optional[topo_mod.Topology] = None) -> str:
        """The concrete schedule for a message of ``nbytes`` on ``mesh``
        (``auto``: the cost model's argmin at the bucket's size)."""
        if self.schedule != "auto":
            return self.schedule
        topo = topo or topo_mod.topology_from_mesh(
            mesh, intra_axes=(self.intra_axis,))
        return topo.best_schedule(min(nbytes, self.bucket_bytes))

    def estimate_seconds(self, mesh, nbytes: int,
                         topo: Optional[topo_mod.Topology] = None) -> float:
        """Cost-model seconds to sync ``nbytes`` of fp32 gradient; buckets
        are counted as :func:`sync_tree` packs them (from fp32 bytes), the
        wire format narrowing what each bucket's collective moves."""
        topo = topo or topo_mod.topology_from_mesh(
            mesh, intra_axes=(self.intra_axis,))
        sched = self.resolve(mesh, nbytes, topo)
        n_buckets = max(1, -(-int(nbytes) // self.bucket_bytes))
        per_bucket_wire = (nbytes / n_buckets
                           * compressed.WIRE_RATIO.get(self.wire_dtype, 1.0))
        return n_buckets * topo.allreduce_time(per_bucket_wire, sched)


def group_size(mesh_shape, axes: Sequence[str]) -> int:
    n = 1
    for ax in axes:
        n *= dict(mesh_shape)[ax]
    return n


def sync_tree(grads: Mapping[str, torch.Tensor], plan: CommsPlan, mesh,
              axes: Tuple[str, ...]) -> Dict[str, torch.Tensor]:
    """Synchronize a gradient dict over the mesh ``axes``: bucket ->
    (compress ->) reduce each bucket by the plan's schedule, resolved at
    the whole tree's fp32 bytes -> unbucket.  With ``plan.mean`` the
    result is the group mean (each bucket's sum times fl32(1/n) in the
    bucket's dtype, as XLA compiles the reference's ``b / n``:
    :func:`precision.div_count`), otherwise the sum; leaves come back in
    their own dtypes."""
    axes = tuple(axes)
    if not axes:
        return dict(grads)
    # fault seam: an armed FaultPlan (faults.set_active) raises
    # CollectiveTimeout HERE, before any bucket is packed or any
    # collective is entered.  The port runs eagerly, so the plan is
    # consulted at every call; every rank holds the same seeded plan, so
    # all ranks raise together and none waits in a collective.
    from repro_torch import faults as faults_mod
    faults_mod.trace_seam("comms.sync_tree")
    sched = plan.resolve(mesh, sum(4 * g.numel() for g in grads.values()))
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
                  fused=fused, axes=list(axes))
    n = group_size(mesh.shape, axes)
    reduced = []
    for i in range(len(buckets)):
        b, buckets[i] = buckets[i], None         # free each bucket once sent
        r = compressed.wire_all_reduce(
            b, mesh, axes, sched, plan.wire_dtype, plan.intra_axis,
            absmax=absmaxes[i] if absmaxes is not None else None,
            out_dtype=bplan.dtype)
        if plan.mean:
            r = precision.div_count(r, n)
        reduced.append(r)
    return bucketer.unflatten_buckets(bplan, reduced)
