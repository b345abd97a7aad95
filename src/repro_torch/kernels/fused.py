"""The int8 format's kernels on the card (CUDA source:
``csrc/quantize.cu``).

- :func:`quantize_int8` replaces the TPU kernel
  ``repro/kernels/fused.py::quantize_int8`` (``_q_kernel``):
  ``q = clip(round(x / scale), ±127)`` as int8, against a scale the group
  has already agreed.  On the train path's int8 wire every fp32 gradient
  bucket of every rank passes through it once per step
  (``comms.compressed.wire_all_reduce``).  It reads 4 bytes and writes 1
  per element, so device memory bounds it.
- :func:`quantize_compress` replaces ``fused.py::quantize_compress``
  (``_qc_kernel``): absmax and quantize in one call, the scale taken from
  the tensor itself.  Two launches (an absmax pass writing one maximum per
  block, then the quantize pass, a programmatic dependent launch that
  folds those maxima): it reads the input twice and writes int8 once, 9
  bytes per fp32 element, bound by device memory.
- :func:`quantize_compress_ef` is the same kernel pair on ``v = g + err``
  with the error feedback fused: ``(deq, new_err, scale)``, the
  reference's jitted quantizer (``train/compression.py``) in one call.  On
  the compressed data-parallel SGD path
  (``train.compression.quantize_int8``) every gradient leaf of every rank
  passes through it once per int8 step; it counts under
  ``quantize_compress``.  With bf16 ``g`` it moves 20 bytes an element
  (g and err read twice, deq and new_err written).

The TPU kernels pad to whole (32, 128) tiles and slice the result back;
these take the exact length, so no padded copy is made.  Scales stay on
the card as 0-d tensors: the host never reads them.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build, ref

launches = 0     # quantize_int8 launches since the last reset (ops)
compress_launches = 0    # quantize_compress(_ef) calls, two launches each
BLOCKS = 132 * 8   # scratch words for the absmax pass's per-block maxima

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_void_p]
_COMPRESS_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_longlong, ctypes.c_void_p]
_EF_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_void_p]


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


def quantize_compress(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8 in ``x``'s shape, scale fp32 0-d on ``x``'s device).  CPU
    tensors take the plain version (:func:`ref.quantize_compress`); CUDA
    tensors launch the kernel, which takes a contiguous, non-empty fp32 or
    bf16 ``x``, and raise on anything else."""
    global compress_launches
    if x.device.type == "cpu":
        return ref.quantize_compress(x)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_compress: x on {x.device}; the kernel "
                         "needs a CUDA tensor")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"quantize_compress kernel takes fp32 or bf16 x, "
                        f"got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("quantize_compress kernel takes a contiguous x")
    if x.numel() == 0:
        raise ValueError("quantize_compress: an empty x has no absmax")
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty((), dtype=torch.float32, device=x.device)
    maxima = torch.empty(BLOCKS, dtype=torch.int32, device=x.device)
    fn = _build.function("dmath_quantize_compress", _COMPRESS_ARGTYPES)
    rc = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), maxima.data_ptr(),
            BLOCKS, q.data_ptr(), scale.data_ptr(), x.numel(),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "quantize_compress")
    compress_launches += 1
    return q, scale


def quantize_compress_ef(g: torch.Tensor, err: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(deq fp32, new_err fp32, both in ``g``'s shape; scale fp32 0-d) of
    ``v = g.float() + err``: ``q`` and the scale as
    :func:`quantize_compress` gives them for ``v``, ``deq = q * scale`` and
    ``new_err = fma(-q, scale, v)``.  ``g`` and ``err`` are left as they
    are.  CPU tensors take the plain version
    (:func:`ref.quantize_compress_ef`); CUDA tensors launch the kernel
    pair, which takes contiguous, non-empty bf16 or fp32 ``g`` and fp32
    ``err`` of its shape on one device, and raise on anything else."""
    global compress_launches
    if g.device.type == "cpu" and err.device.type == "cpu":
        return ref.quantize_compress_ef(g, err)
    if g.device.type != "cuda" or err.device != g.device:
        raise ValueError(f"quantize_compress_ef: g on {g.device}, err on "
                         f"{err.device}; the kernel needs both on one CUDA "
                         "device")
    if g.dtype not in (torch.float32, torch.bfloat16) \
            or err.dtype != torch.float32:
        raise TypeError(f"quantize_compress_ef kernel takes fp32 or bf16 g "
                        f"and fp32 err, got {g.dtype} and {err.dtype}")
    if g.shape != err.shape:
        raise ValueError(f"quantize_compress_ef: g {tuple(g.shape)} and err "
                         f"{tuple(err.shape)} differ in shape")
    if not (g.is_contiguous() and err.is_contiguous()):
        raise ValueError("quantize_compress_ef kernel takes contiguous g and "
                         "err")
    if g.numel() == 0:
        raise ValueError("quantize_compress_ef: an empty g has no absmax")
    deq = torch.empty(g.shape, dtype=torch.float32, device=g.device)
    new_err = torch.empty(g.shape, dtype=torch.float32, device=g.device)
    scale = torch.empty((), dtype=torch.float32, device=g.device)
    maxima = torch.empty(BLOCKS, dtype=torch.int32, device=g.device)
    fn = _build.function("dmath_quantize_compress_ef", _EF_ARGTYPES)
    rc = fn(g.data_ptr(), int(g.dtype == torch.bfloat16), err.data_ptr(),
            maxima.data_ptr(), BLOCKS, deq.data_ptr(), new_err.data_ptr(),
            scale.data_ptr(), g.numel(),
            torch.cuda.current_stream(g.device).cuda_stream)
    _build.check(rc, "quantize_compress_ef")
    compress_launches += 1
    return deq, new_err, scale
