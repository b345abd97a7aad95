"""Mixed-precision GEMM on the card: C = A @ B, bf16 operands, fp32
accumulator, one downcast (CUDA source: ``csrc/gemm.cu``).

Replaces the TPU kernel ``repro/kernels/gemm.py::matmul``
(``_matmul_kernel``), dMath's core kernel.  On the serve path every
projection, MLP and unembed product runs here, at M = batch slots
(decode) or M = one prefill chunk.  At those M each product does a few
operations per weight byte, far below the H100's ~295 bf16 FLOP/byte
ridge, so it is bound by the bytes of B over 3.35 TB/s (the unembed's
272 MB: ~81 us).  The design keeps B's bytes to one pass: each block owns
a 64x64 output tile, reads its B column panel once in 32-deep k-steps with
16-byte loads, and runs bf16 WMMA (tensor cores) into an fp32
accumulator, so the FLOPs never bound it.  The TPU kernel needs shapes
that tile exactly; this one masks ragged M, N and K edges itself.

Training differentiates through :func:`matmul` (a
``torch.autograd.Function``): the backward runs dA = dC·Bᵀ and dB = Aᵀ·dC
on the same kernel.  The kernel reads row-major operands only, so Bᵀ and
Aᵀ are first made contiguous: one extra read and write of each operand
per backward product (2·K·N·2 bytes for Bᵀ, 2·M·K·2 for Aᵀ in bf16;
for the train step at qwen2-0.5b about 3 GB per rank, ~0.9 ms at
3.35 TB/s), where transposed-operand loads would need strided tiles in
the kernel.  The cotangent dC arrives in fp32 (the forward's accumulator
type) and is rounded once to the operands' type, bf16, because the
kernel takes bf16 operands; JAX's transpose multiplies the fp32
cotangent and rounds the product instead.  The plain version rounds
dC the same way, so a CPU test sees exactly the card's deviation.

:func:`matmul_dequant` (CUDA source: ``csrc/gemm_dequant.cu``) replaces
the TPU kernel ``repro/kernels/gemm.py::matmul_dequant``: C = (A @ B_q) ·
scale[N] with int8 weights widened inside the kernel and the per-column
scale applied to the fp32 accumulator, so the dequantized B never exists
in device memory.  It is reached through ``ops.matmul_dequant`` only, as
in the reference (no model path calls it); at qwen2-0.5b's decode shapes
it is bound by the int8 bytes of B, half the bf16 GEMM's.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build, ref

launches = 0     # matmul launches since the last reset (ops.reset_launches)
dequant_launches = 0     # matmul_dequant launches

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p]

_DEQUANT_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                     ctypes.c_int, ctypes.c_int, ctypes.c_int,
                     ctypes.c_void_p]


class _MatMul(torch.autograd.Function):
    """C = A @ B with both backward products on the same kernel."""

    @staticmethod
    def forward(ctx, a, b, out_dtype):
        ctx.save_for_backward(a, b)
        return _product(a, b, out_dtype)

    @staticmethod
    def backward(ctx, dc):
        a, b = ctx.saved_tensors
        g = dc.to(torch.promote_types(a.dtype, b.dtype)).contiguous()
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _product(g, b.t().contiguous(), a.dtype)
        if ctx.needs_input_grad[1]:
            db = _product(a.t().contiguous(), g, b.dtype)
        return da, db, None


def matmul(a: torch.Tensor, b: torch.Tensor,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(M, K) @ (K, N) -> (M, N) in ``out_dtype`` (default ``a.dtype``).

    CPU tensors take the plain version (:func:`ref.matmul`); CUDA tensors
    launch the kernel, which takes contiguous bf16 operands and writes
    fp32 or bf16, and raise on anything else.  Differentiable: with
    autograd recording, the backward products run the same way."""
    out_dtype = out_dtype or a.dtype
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _MatMul.apply(a, b, out_dtype)
    return _product(a, b, out_dtype)


def _product(a: torch.Tensor, b: torch.Tensor,
             out_dtype: torch.dtype) -> torch.Tensor:
    global launches
    if a.device.type == "cpu" and b.device.type == "cpu":
        return ref.matmul(a, b, out_dtype)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"matmul: operands on {a.device} and {b.device}; "
                         "the kernel needs both on one CUDA device")
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError(f"matmul kernel takes bf16 operands, got "
                        f"{a.dtype} @ {b.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"matmul kernel writes fp32 or bf16, not {out_dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul: shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)} do not chain")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul kernel takes contiguous row-major operands")
    M, K = a.shape
    N = b.shape[1]
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    if M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    fn = _build.function("dmath_gemm_bf16", _ARGTYPES)
    rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K,
            int(out_dtype == torch.float32),
            torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(rc, "matmul")
    launches += 1
    return out


def matmul_dequant(a: torch.Tensor, b_q: torch.Tensor, b_scale: torch.Tensor,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(M, K) @ (K, N) int8, times ``b_scale`` (N,) per column -> (M, N) in
    ``out_dtype`` (default ``a.dtype``).

    CPU tensors take the plain version (:func:`ref.matmul_dequant`); CUDA
    tensors launch the kernel, which takes contiguous bf16 or fp32 ``a``,
    int8 ``b_q`` and fp32 ``b_scale`` on one device and writes fp32 or
    bf16, and raise on anything else.  Not differentiable (the reference
    has no backward)."""
    global dequant_launches
    out_dtype = out_dtype or a.dtype
    devs = {t.device for t in (a, b_q, b_scale)}
    if devs == {torch.device("cpu")}:
        return ref.matmul_dequant(a, b_q, b_scale, out_dtype)
    if len(devs) != 1 or a.device.type != "cuda":
        raise ValueError(f"matmul_dequant: operands on {sorted(map(str, devs))}"
                         "; the kernel needs all three on one CUDA device")
    if a.dtype not in (torch.bfloat16, torch.float32) \
            or b_q.dtype != torch.int8 or b_scale.dtype != torch.float32:
        raise TypeError(f"matmul_dequant kernel takes bf16/fp32 a, int8 b_q "
                        f"and fp32 b_scale, got {a.dtype}, {b_q.dtype}, "
                        f"{b_scale.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"matmul_dequant kernel writes fp32 or bf16, not "
                        f"{out_dtype}")
    if a.dim() != 2 or b_q.dim() != 2 or a.shape[1] != b_q.shape[0] \
            or tuple(b_scale.shape) != (b_q.shape[1],):
        raise ValueError(f"matmul_dequant: shapes {tuple(a.shape)} @ "
                         f"{tuple(b_q.shape)} * {tuple(b_scale.shape)} do "
                         "not chain")
    if not (a.is_contiguous() and b_q.is_contiguous()
            and b_scale.is_contiguous()):
        raise ValueError("matmul_dequant kernel takes contiguous operands")
    M, K = a.shape
    N = b_q.shape[1]
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    if M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    fn = _build.function("dmath_gemm_dequant", _DEQUANT_ARGTYPES)
    rc = fn(a.data_ptr(), int(a.dtype == torch.float32), b_q.data_ptr(),
            b_scale.data_ptr(), out.data_ptr(), M, N, K,
            int(out_dtype == torch.float32),
            torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(rc, "matmul_dequant")
    dequant_launches += 1
    return out
