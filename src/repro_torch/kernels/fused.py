"""The int8 wire's quantize pass on the card (CUDA source:
``csrc/quantize.cu``).

Replaces the TPU kernel ``repro/kernels/fused.py::quantize_int8``
(``_q_kernel``): ``q = clip(round(x / scale), ±127)`` as int8, against a
scale the group has already agreed.  On the train path's int8 wire every
fp32 gradient bucket of every rank passes through it once per step
(``comms.compressed.wire_all_reduce``).  It reads 4 bytes and
writes 1 per element, so device memory bounds it.  The TPU kernel pads
the bucket to whole (32, 128) tiles and slices the result back; this one
takes the bucket's exact length, so no padded copy is made.  The scale
stays on the card as a 0-d tensor: the host never reads it.

The reference's ``quantize_compress`` (absmax and quantize in one call)
has no caller on a ported path yet and stays in ROADMAP queue 2.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, ref

launches = 0     # kernel launches since the last reset (ops.reset_launches)

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_void_p]


def quantize_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 of ``x``'s shape.  CPU tensors take the plain version
    (:func:`ref.quantize_int8`); CUDA tensors launch the kernel, which
    takes a contiguous fp32 ``x`` and a one-element fp32 ``scale`` on the
    same device, and raise on anything else."""
    global launches
    if x.device.type == "cpu" and scale.device.type == "cpu":
        return ref.quantize_int8(x, scale)
    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError(f"quantize_int8: x on {x.device}, scale on "
                         f"{scale.device}; the kernel needs both on one "
                         "CUDA device")
    if x.dtype != torch.float32 or scale.dtype != torch.float32:
        raise TypeError(f"quantize_int8 kernel takes fp32 x and scale, got "
                        f"{x.dtype} and {scale.dtype}")
    if scale.numel() != 1:
        raise ValueError(f"quantize_int8: scale has {scale.numel()} "
                         "elements; the wire agrees one per bucket")
    if not x.is_contiguous():
        raise ValueError("quantize_int8 kernel takes a contiguous x")
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    if x.numel() == 0:
        return q
    fn = _build.function("dmath_quantize_int8", _ARGTYPES)
    rc = fn(x.data_ptr(), scale.data_ptr(), q.data_ptr(), x.numel(),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "quantize_int8")
    launches += 1
    return q
