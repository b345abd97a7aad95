"""Flash attention on the card (CUDA source: ``csrc/flash_attention.cu``).

Replaces the TPU kernel ``repro/kernels/flash_attention.py::attention``
(``_attn_kernel``): online-softmax attention with GQA (query head h reads
kv head h // g), causal masking, a sliding window, a tanh logit softcap
and a query offset.  On the serve path it runs each prefill chunk, q
(1, Hq, C, hd) against the sequence's keys gathered in logical order;
in training, each layer's attention over 512-token sequences.  At those
sizes it is bound by latency, not by bytes or tensor-core work.  bf16
q, k, v run on Hopper's tensor cores: one warpgroup per 64 query rows,
QKᵀ and PV on wgmma with P kept in registers, K/V in 64-key tiles
aligned at key 0 through a cp.async ring, key tiles beyond the
causal/window horizon skipped (the TPU kernel walks every tile and
masks).  fp32 q, k, v take a CUDA-core kernel of the same semantics.
``q_offset``, ``window`` and ``softcap`` are runtime arguments, where the
TPU kernel compiles one variant per value.  Any head dim up to 256, as
the TPU kernel takes any: 32, 64, 128 and 256 (gemma-2b) on their own
tiles, the rest on the tile of the next of them with the columns past D
loaded as zeros (QKᵀ stays exact) and not stored.

A row's output and log-sum-exp do not depend on S, on its query tile or
on which prefill chunk it sits in (bitwise, on the card): the dense
prefill and the chunked paged prefill give the same bits.

Rows with no visible key write zeros, as the model's attention in the
reference does; the TPU kernel gives mean(V) there.

Training differentiates through :func:`attention` (a
``torch.autograd.Function``).  Its forward then also writes each row's
log-sum-exp, and its backward is a kernel of the port's own
(``csrc/flash_attention_bwd.cu``; the reference has no backward kernel
and trains through ``layers.flash_attention_jnp``): dQ, dK and dV on
wgmma, recomputing the probabilities from the log-sum-exp, with the same
GQA, causal, window, softcap and offset arguments, zero gradients on rows
with no visible key, and no atomics (the same bits from run to run).
The backward takes bf16 only: fp32 q, k, v cannot be differentiated on
the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor

from . import _build, ref, roofline

launches = 0       # forward launches since the last reset (ops.reset_launches)
bwd_launches = 0   # backward calls (four kernels each), the same way

MAX_HEAD_DIM = 256   # any D up to it: the tile of the next of 32, 64, 128, 256

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _I,
             _P]
_BWD_ARGTYPES = [_P] * 11 + [_I] * 8 + [_F, _F, _I, _P]
# the forward's C entry by element type: wgmma for bf16, CUDA cores for fp32
_ENTRIES = {torch.bfloat16: "dmath_flash_attention_bf16",
            torch.float32: "dmath_flash_attention_f32"}


def _check(q, k, v) -> None:
    """Raise unless the kernels take (q, k, v) as given."""
    if (q.device.type != "cuda" and not isinstance(q, FakeTensor)) \
            or k.device != q.device or v.device != q.device:
        raise ValueError(f"attention: tensors on {q.device}, {k.device}, "
                         f"{v.device}; the kernel needs one CUDA device")
    if q.dtype not in _ENTRIES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"attention kernel takes q, k, v all bf16 or all "
                        f"fp32, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"attention: q {tuple(q.shape)}, k {tuple(k.shape)},"
                         f" v {tuple(v.shape)}; want (B,Hq,S,D), (B,Hkv,T,D)")
    B, Hq, S, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or Hq % k.shape[1]:
        raise ValueError(f"attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not match")
    if not 0 < D <= MAX_HEAD_DIM:
        raise ValueError(f"attention kernel takes head dims up to "
                         f"{MAX_HEAD_DIM}, got {D}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("attention kernel takes contiguous q, k, v")


def _check_bf16(q) -> None:
    if q.dtype != torch.bfloat16:
        raise TypeError(f"attention backward kernel takes bf16 q, k, v, got "
                        f"{q.dtype}: fp32 attention runs on the card without "
                        "autograd only")


def _args(q, k, causal, window, softcap, scale, q_offset):
    B, Hq, S, D = q.shape
    return (B, Hq, k.shape[1], S, k.shape[2], D, int(causal),
            int(window) if window is not None else 0,
            float(softcap) if softcap is not None else 0.0, float(scale),
            int(q_offset), torch.cuda.current_stream(q.device).cuda_stream)


def _pairs(q, k, causal, window, q_offset) -> int:
    """(query, key) pairs a call attends, for its cost: all of them, or
    the causal ones within the window."""
    S, T = q.shape[2], k.shape[2]
    if not causal:
        return S * T
    return roofline.causal_pairs(S, T, q_offset, window)


def _forward(q, k, v, causal, window, softcap, scale, q_offset,
             with_lse: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    global launches
    out = torch.empty_like(q)
    lse = (torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return out, lse
    if isinstance(q, FakeTensor):          # a dry trace: no launch
        roofline.DRY.record("attention", roofline.attention_cost(
            q.shape, k.shape, _pairs(q, k, causal, window, q_offset),
            q.element_size(), with_lse))
        return out, lse
    fn = _build.function(_ENTRIES[q.dtype], _ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None,
            *_args(q, k, causal, window, softcap, scale, q_offset))
    _build.check(rc, "attention")
    launches += 1
    return out, lse


def attention_backward(q, k, v, out, d_out, lse, *, causal: bool = True,
                       window: Optional[int] = None,
                       softcap: Optional[float] = None,
                       scale: Optional[float] = None, q_offset: int = 0
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in bf16 from the forward's ``out`` and per-row
    log-sum-exp ``lse`` (fp32 (B, Hq, S)) for the cotangent ``d_out``, by
    the backward kernel.  CUDA tensors only: on the CPU autograd runs
    through the plain version (:func:`ref.attention_backward`)."""
    global bwd_launches
    _check(q, k, v)
    _check_bf16(q)
    d_out = d_out.to(torch.bfloat16).contiguous()
    if out.shape != q.shape or d_out.shape != q.shape \
            or out.dtype != q.dtype or lse.shape != q.shape[:3] \
            or lse.dtype != torch.float32:
        raise ValueError("attention_backward: out, d_out and lse do not "
                         "match q")
    scale = scale if scale is not None else 1.0 / (q.shape[3] ** 0.5)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    # fp32 scratch: delta = rowsum(dO * O), and the shares the last pass
    # adds in order: dK's and dV's of each query head and parity of its
    # query tiles, then dQ's of each parity of its key tiles
    B, Hq, S, D = q.shape
    delta = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    part = torch.empty(B * Hq * D * (4 * k.shape[2] + 2 * S),
                       dtype=torch.float32, device=q.device)
    if isinstance(q, FakeTensor):          # a dry trace: no launch
        roofline.DRY.record("attention_backward",
                            roofline.attention_backward_cost(
                                q.shape, k.shape,
                                _pairs(q, k, causal, window, q_offset)))
        return dq, dk, dv
    fn = _build.function("dmath_flash_attention_bwd_bf16", _BWD_ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.contiguous()
            .data_ptr(), d_out.data_ptr(), lse.contiguous().data_ptr(),
            delta.data_ptr(), part.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(),
            *_args(q, k, causal, window, softcap, scale, q_offset))
    _build.check(rc, "attention_backward")
    bwd_launches += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The forward kernel with its log-sum-exp, the backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale, q_offset):
        out, lse = _forward(q, k, v, causal, window, softcap, scale,
                            q_offset, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = dict(causal=causal, window=window, softcap=softcap,
                      scale=scale, q_offset=q_offset)
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = attention_backward(q, k, v, out, d_out, lse, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None


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
    """CPU tensors take the plain version (:func:`ref.attention`, which
    autograd differentiates); CUDA tensors launch the kernel (contiguous,
    all bf16 or all fp32, any head dim up to 256: the tile of the next of
    32, 64, 128 and 256 with the columns past D masked, a D that is not a
    multiple of 8 loading element by element) and raise on anything else.
    With autograd recording (bf16 only), the forward keeps its
    log-sum-exp and the backward kernel gives the gradients."""
    if all(t.device.type == "cpu" for t in (q, k, v)) \
            and not isinstance(q, FakeTensor):
        return ref.attention(q, k, v, causal=causal, window=window,
                             softcap=softcap, scale=scale, q_offset=q_offset)
    _check(q, k, v)
    if q_offset < 0 or (window is not None and window < 1):
        raise ValueError(f"attention: q_offset {q_offset} or window "
                         f"{window} out of range")
    scale = scale if scale is not None else 1.0 / (q.shape[3] ** 0.5)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        _check_bf16(q)
        return _FlashAttention.apply(q, k, v, causal, window, softcap, scale,
                                     q_offset)
    return _forward(q, k, v, causal, window, softcap, scale, q_offset,
                    with_lse=False)[0]
