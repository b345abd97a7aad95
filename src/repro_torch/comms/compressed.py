"""Reduced-precision wire formats for the all-reduce schedules, ported
from the reference's ``comms/compressed.py``; each composes with every
schedule of :mod:`repro_torch.comms.schedules`.

- ``bf16``: narrow before the collective, widen after.
- ``int8``: per-bucket absmax affine quantization.  The group agrees the
  scale with a MAX over the reduce axes so every rank dequantizes
  identically (a maximum is exact in any order), and computes it as the
  reference does under ``jit`` (``sync_tree`` runs inside its
  ``shard_map``): ``absmax / 127 + 1e-12`` compiled by XLA to
  ``fma(absmax, fl32(1/127), fl32(1e-12))``, which
  :func:`repro_torch.kernels.ref.int8_scale` reproduces on the device
  (IEEE division and a separate add round differently for ~15% of
  absmax values).  The reduction itself sums int32 (exact for up to
  ~2^24 ranks) through the schedule.  The quantize pass is
  :func:`repro_torch.kernels.ops.quantize_int8`, the CUDA kernel for a
  bucket on the card; its division by the scale stays a true division,
  as XLA keeps it for a traced divisor.

As in the reference, the int32 sum is what physically crosses the wire
(4 bytes per element).  Divisions by tensors only: ``tensor / float``
on the card multiplies by the reciprocal, which rounds differently from
the reference.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.kernels import ops, ref

from . import schedules

#: wire bytes per fp32 byte each format is credited with, as the
#: reference's telemetry and cost model count them; the int8 wire
#: physically moves its int32 sum here, as it does there
WIRE_RATIO = {None: 1.0, "none": 1.0, "bf16": 0.5, "int8": 0.25}


def _group_max(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    for ax in axes:
        if mesh.shape[ax] > 1:
            x = schedules.group_reduce(x.clone(), mesh.axis_group(ax),
                                       op=dist.ReduceOp.MAX)
    return x


def wire_all_reduce(x: torch.Tensor, mesh, axes: Sequence[str],
                    schedule: str = "psum",
                    wire_dtype: Optional[str] = None,
                    intra_axis: str = "model", *,
                    absmax: Optional[torch.Tensor] = None,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The sum of ``x`` over the mesh ``axes`` through the given schedule
    and wire format, in ``out_dtype`` (``x``'s dtype by default).

    This is both of the reference's forms.  A bucket packed by
    ``bucketer.flatten_buckets_fused`` (its ``wire_all_reduce_fused``)
    arrives with the wire's prologue done: narrowed to bf16, or with its
    local ``absmax`` for int8.  Any other ``x`` (its ``wire_all_reduce``)
    is narrowed here, or its absmax taken here; the two agree bitwise (a
    cast commutes with concatenation, a max of maxes is exact)."""
    axes = tuple(axes)
    out_dtype = out_dtype or x.dtype
    if not axes:
        return x.to(out_dtype)
    if wire_dtype in (None, "none", "fp32"):
        return schedules.all_reduce(x, mesh, axes, schedule, intra_axis,
                                    out_dtype=out_dtype)
    if wire_dtype == "bf16":
        return schedules.all_reduce(x.to(torch.bfloat16), mesh, axes,
                                    schedule, intra_axis,
                                    out_dtype=out_dtype)
    if wire_dtype == "int8":
        v = x.float().contiguous()
        if absmax is None:
            absmax = v.abs().max()
        scale = ref.int8_scale(_group_max(absmax, mesh, axes))
        q = ops.quantize_int8(v, scale).to(torch.int32)
        summed = schedules.all_reduce(q, mesh, axes, schedule, intra_axis)
        return (summed.float() * scale).to(out_dtype)
    raise ValueError(f"unknown wire_dtype {wire_dtype!r}; "
                     "expected None, 'bf16' or 'int8'")
