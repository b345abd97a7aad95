"""Reduced-precision wire formats for the all-reduce schedules, ported
from the reference's ``comms/compressed.py``.

- ``bf16``: narrow before the collective, widen after.
- ``int8``: per-bucket absmax affine quantization.  The group agrees the
  scale with an all-reduce MAX so every rank dequantizes identically,
  and computes it as the reference does under ``jit`` (``sync_tree``
  runs inside its ``shard_map``): ``absmax / 127 + 1e-12`` compiled by
  XLA to ``fma(absmax, fl32(1/127), fl32(1e-12))``, which
  :func:`repro_torch.kernels.ref.int8_scale` reproduces on the device
  (IEEE division and a separate add round differently for ~15% of
  absmax values).  The reduction itself sums int32 (exact for up to
  ~2^24 ranks).  The quantize pass is
  :func:`repro_torch.kernels.ops.quantize_int8`, the CUDA kernel for a
  bucket on the card; its division by the scale stays a true division,
  as XLA keeps it for a traced divisor.

As in the reference, the int32 sum is what physically crosses the wire
(4 bytes per element).  Divisions by tensors only: ``tensor / float``
on the card multiplies by the reciprocal, which rounds differently from
the reference.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.kernels import ops, ref

from . import schedules

#: wire bytes per fp32 byte each format is credited with, as the
#: reference's telemetry counts them (``comms.*.wire_bytes``); the int8
#: wire physically moves its int32 sum here, as it does there
WIRE_RATIO = {None: 1.0, "none": 1.0, "bf16": 0.5, "int8": 0.25}


def _group_max(x: torch.Tensor, group=None) -> torch.Tensor:
    return schedules.all_reduce(x.clone(), group, "psum",
                                op=dist.ReduceOp.MAX)


def wire_all_reduce(x: torch.Tensor, group=None, schedule: str = "psum",
                    wire_dtype: Optional[str] = None, *,
                    absmax: Optional[torch.Tensor] = None,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The group sum of one bucket through the given schedule and wire
    format, in ``out_dtype`` (``x`` may be reduced in place).  A narrowing
    wire takes buckets packed by ``bucketer.flatten_buckets_fused`` (the
    reference's ``wire_all_reduce_fused``), whose pass already ran the
    wire's prologue: a bf16 bucket arrives narrowed; an int8 bucket
    arrives with its local ``absmax``, which the group agrees with a MAX
    before the single quantize pass."""
    out_dtype = out_dtype or x.dtype
    if wire_dtype in (None, "none", "fp32"):
        return schedules.all_reduce(x, group, schedule).to(out_dtype)
    if wire_dtype == "bf16":
        if x.dtype != torch.bfloat16:
            raise TypeError(f"a fused bf16 bucket is bf16, got {x.dtype}")
        return schedules.all_reduce(x, group, schedule).to(out_dtype)
    if wire_dtype == "int8":
        if absmax is None:
            raise ValueError("the fused int8 path needs the packed absmax")
        scale = ref.int8_scale(_group_max(absmax, group))
        q = ops.quantize_int8(x.float().contiguous(), scale).to(torch.int32)
        summed = schedules.all_reduce(q, group, schedule)
        return (summed.float() * scale).to(out_dtype)
    raise ValueError(f"unknown wire_dtype {wire_dtype!r}; "
                     "expected None, 'bf16' or 'int8'")
