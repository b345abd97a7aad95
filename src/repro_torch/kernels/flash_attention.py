"""Flash attention on the card (CUDA source: ``csrc/flash_attention.cu``).

Replaces the TPU kernel ``repro/kernels/flash_attention.py::attention``
(``_attn_kernel``): online-softmax attention with GQA (query head h reads
kv head h // g), causal masking, a sliding window, a tanh logit softcap
and a query offset.  On the serve path it runs each prefill chunk, q
(1, Hq, C, hd) against the sequence's keys gathered in logical order.
There it does ~4·C·T·hd FLOPs per head over ~2·T·hd·Hkv bytes of K/V, so
at C = 128 it sits under the ridge and moves few bytes: what bounds it
is latency and the FP32 rate of a small grid.  The design reads each K/V
tile once per query tile into shared memory, keeps the softmax state in
fp32 registers, and skips key tiles beyond the causal/window horizon
(the TPU kernel walks every tile and masks).  ``q_offset``, ``window`` and
``softcap`` are runtime arguments, where the TPU kernel compiles one
variant per value.

Rows with no visible key write zeros, as the model's attention in the
reference does; the TPU kernel gives mean(V) there.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build, ref

launches = 0     # kernel launches since the last reset (ops.reset_launches)

HEAD_DIMS = (32, 64, 128)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _I, _P]


def attention(
    q: torch.Tensor,                  # (B, Hq, S, D)
    k: torch.Tensor,                  # (B, Hkv, T, D)
    v: torch.Tensor,                  # (B, Hkv, T, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """CPU tensors take the plain version (:func:`ref.attention`); CUDA
    tensors launch the kernel (contiguous bf16, head dim 32/64/128) and
    raise on anything else."""
    global launches
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return ref.attention(q, k, v, causal=causal, window=window,
                             softcap=softcap, scale=scale, q_offset=q_offset)
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        raise ValueError(f"attention: tensors on {q.device}, {k.device}, "
                         f"{v.device}; the kernel needs one CUDA device")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise TypeError("attention kernel takes bf16 q, k, v")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"attention: q {tuple(q.shape)}, k {tuple(k.shape)},"
                         f" v {tuple(v.shape)}; want (B,Hq,S,D), (B,Hkv,T,D)")
    B, Hq, S, D = q.shape
    _, Hkv, T, _ = k.shape
    if k.shape[0] != B or k.shape[3] != D or Hq % Hkv:
        raise ValueError(f"attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not match")
    if D not in HEAD_DIMS:
        raise ValueError(f"attention kernel takes head dim in {HEAD_DIMS}, "
                         f"got {D}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("attention kernel takes contiguous q, k, v")
    if q_offset < 0 or (window is not None and window < 1):
        raise ValueError(f"attention: q_offset {q_offset} or window "
                         f"{window} out of range")
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = _build.function("dmath_flash_attention_bf16", _ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Hq, Hkv, S, T, D, int(causal),
            int(window) if window is not None else 0,
            float(softcap) if softcap is not None else 0.0,
            float(scale), int(q_offset),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "attention")
    launches += 1
    return out
