"""Paged decode attention on the card (CUDA source:
``csrc/paged_attention.cu``).

Replaces the TPU kernel
``repro/kernels/paged_attention.py::paged_decode_attention``
(``_paged_decode_kernel``): one query token per sequence against a KV
pool of fixed-size pages, sequence b's logical page j being physical page
``block_table[b, j]`` and positions at or past ``seq_lens[b]`` masked.
It runs at every decode step, where it is bound by latency, not by its
~1 MB of K/V.  The kernel is split-sequence flash-decoding: each
sequence's keys are cut at fixed positions into splits of ``SPLIT`` keys,
one block per (split, kv head, sequence) with the g query heads of the kv
head as the rows of one tensor-core tile, and a second kernel adds the
splits in order (:func:`ref.paged_decode_split_combine` is that order in
plain PyTorch).  Blocks past a sequence's length exit at once, so only
live pages are read, where the TPU kernel streams the whole table row
and masks the tail.

The number of splits follows the table's width, never ``seq_lens``: the
contract ``seq_lens >= 1`` (page 0 of the row holds position 0) is
checked by the caller that holds the positions on the host (the serve
engines), not here, since reading device memory would stall the stream.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor

from . import _build, ref, roofline

launches = 0     # calls that launched the kernels since the last reset
                 # (ops.reset_launches); a call runs two device kernels

HEAD_DIMS = (32, 64, 128, 256)
MAX_GROUP = 16          # query heads per kv head the kernel holds as rows
SPLIT = 128             # keys per split (KS in csrc/paged_attention.cu)
KERNELS_PER_CALL = 2    # the splits, then their ordered combine

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 7 + [_I] * 6 + [_F, _P]


def paged_decode_attention(
    q: torch.Tensor,              # (B, Hq, hd)
    k_pages: torch.Tensor,        # (P, page, Hkv, hd)
    v_pages: torch.Tensor,        # (P, page, Hkv, hd)
    block_table: torch.Tensor,    # (B, n_pages) int32
    seq_lens: torch.Tensor,       # (B,) int32
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """CPU tensors take the plain version
    (:func:`ref.paged_decode_attention`); CUDA tensors launch the kernel
    (contiguous bf16 q and pages starting 16-byte aligned, int32 table
    and lengths, head dim 32/64/128/256, at most 16 query heads per kv
    head) and raise on anything else."""
    global launches
    tensors = (q, k_pages, v_pages, block_table, seq_lens)
    fake = isinstance(q, FakeTensor)       # a dry trace: no launch
    if all(t.device.type == "cpu" for t in tensors) and not fake:
        return ref.paged_decode_attention(q, k_pages, v_pages, block_table,
                                          seq_lens, scale=scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "paged_decode_attention: the kernel has no backward; "
            "decode is a serving step, which trains nothing")
    if (q.device.type != "cuda" and not fake) \
            or any(t.device != q.device for t in tensors):
        raise ValueError("paged_decode_attention: the kernel needs every "
                         "tensor on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.bfloat16 for t in (q, k_pages, v_pages)):
        raise TypeError("paged_decode_attention kernel takes bf16 q and "
                        "pages")
    if block_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("paged_decode_attention kernel takes int32 "
                        "block_table and seq_lens")
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"paged_decode_attention: q {tuple(q.shape)}, "
                         f"pages {tuple(k_pages.shape)}")
    B, Hq, hd = q.shape
    P, page, Hkv, hd2 = k_pages.shape
    if hd2 != hd or Hq % Hkv or block_table.dim() != 2 \
            or block_table.shape[0] != B or tuple(seq_lens.shape) != (B,):
        raise ValueError(f"paged_decode_attention: q {tuple(q.shape)}, pages"
                         f" {tuple(k_pages.shape)}, table "
                         f"{tuple(block_table.shape)}, lens "
                         f"{tuple(seq_lens.shape)} do not match")
    if hd not in HEAD_DIMS or Hq // Hkv > MAX_GROUP:
        raise ValueError(f"paged_decode_attention kernel takes head dim in "
                         f"{HEAD_DIMS} and <= {MAX_GROUP} query heads per "
                         f"kv head, got {hd} and {Hq // Hkv}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_decode_attention kernel takes contiguous "
                         "tensors")
    if not fake and any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError("paged_decode_attention kernel loads q and the "
                         "pages 16 bytes at a time: they must start 16-byte "
                         "aligned")
    scale = scale if scale is not None else 1.0 / (hd ** 0.5)
    out = torch.empty_like(q)
    n_pages = block_table.shape[1]
    if out.numel() == 0 or n_pages * page == 0:
        return out.zero_()
    splits = -(-n_pages * page // SPLIT)
    scratch = torch.empty(B * Hq * splits * (hd + 2), dtype=torch.float32,
                          device=q.device)
    if fake:
        # the data decides the live positions: the table's capacity
        roofline.DRY.record("paged_decode_attention",
                            roofline.paged_decode_cost(
                                B, Hq, Hkv, hd, B * n_pages * page,
                                block_table.numel()))
        return out
    fn = _build.function("dmath_paged_decode_bf16", _ARGTYPES)
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_table.data_ptr(), seq_lens.data_ptr(), scratch.data_ptr(),
            out.data_ptr(), B, Hq, Hkv, hd, page, n_pages, float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "paged_decode_attention")
    launches += 1
    return out
