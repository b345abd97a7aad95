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

Any head dim up to 256 runs, as the TPU kernel takes any: on the tile of
the next of 32, 64, 128 and 256, the columns past hd loaded as zeros and
not stored (an hd that is not a multiple of 8 loads element by element).

Serving on a mesh, where the KV cache is sharded on the sequence, runs
the kernel's shard mode (:func:`paged_decode_partials`): a table entry
< 0 is a page this rank does not hold, and the split kernel alone runs,
returning its per-split partials; the ranks all-gather them in rank
order and :func:`paged_decode_combine` adds them (the one-rank call's
combine, generalised to n ranks: the one-rank call is its n = 1 case).
Flash-decoding's sum over the sequence shards is so a fixed-order sum,
the same bits on every rank.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor

from . import _build, ref, roofline

launches = 0     # calls that launched the kernels since the last reset
                 # (ops.reset_launches); a call runs two device kernels
shard_launches = 0     # shard-mode calls (the split kernel alone)
combine_launches = 0   # combines of the ranks' partials

MAX_HEAD_DIM = 256      # any hd up to it (the tile of the next power)
MAX_GROUP = 16          # query heads per kv head the kernel holds as rows
SPLIT = 128             # keys per split (KS in csrc/paged_attention.cu)
KERNELS_PER_CALL = 2    # the splits, then their ordered combine

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 7 + [_I] * 6 + [_F, _P]
_PART_ARGTYPES = [_P] * 6 + [_I] * 6 + [_F, _P]
_COMBINE_ARGTYPES = [_P] * 2 + [_I] * 5 + [_P]


def splits_of(n_pages: int, page: int) -> int:
    """The splits of a table row of ``n_pages`` pages of ``page``."""
    return -(-n_pages * page // SPLIT)


def _on_cpu(tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors) \
        and not isinstance(tensors[0], FakeTensor)


def _check(name, q, k_pages, v_pages, block_table, seq_lens) -> None:
    """Raise unless the kernel takes these tensors as given."""
    tensors = (q, k_pages, v_pages, block_table, seq_lens)
    fake = isinstance(q, FakeTensor)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: the kernel has no backward; decode is a serving "
            "step, which trains nothing")
    if (q.device.type != "cuda" and not fake) \
            or any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: the kernel needs every tensor on one "
                         "CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.bfloat16 for t in (q, k_pages, v_pages)):
        raise TypeError(f"{name} kernel takes bf16 q and pages")
    if block_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError(f"{name} kernel takes int32 block_table and "
                        "seq_lens")
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)}")
    B, Hq, hd = q.shape
    P, page, Hkv, hd2 = k_pages.shape
    if hd2 != hd or Hq % Hkv or block_table.dim() != 2 \
            or block_table.shape[0] != B or tuple(seq_lens.shape) != (B,):
        raise ValueError(f"{name}: q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)}, table "
                         f"{tuple(block_table.shape)}, lens "
                         f"{tuple(seq_lens.shape)} do not match")
    if not 0 < hd <= MAX_HEAD_DIM or Hq // Hkv > MAX_GROUP:
        raise ValueError(f"{name} kernel takes head dims up to "
                         f"{MAX_HEAD_DIM} and <= {MAX_GROUP} query heads "
                         f"per kv head, got {hd} and {Hq // Hkv}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} kernel takes contiguous tensors")
    if not fake and any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError(f"{name} kernel loads q and the pages 16 bytes at "
                         "a time: they must start 16-byte aligned")


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
    and lengths, any head dim up to 256, at most 16 query heads per kv
    head) and raise on anything else."""
    global launches
    tensors = (q, k_pages, v_pages, block_table, seq_lens)
    if _on_cpu(tensors):
        return ref.paged_decode_attention(q, k_pages, v_pages, block_table,
                                          seq_lens, scale=scale)
    _check("paged_decode_attention", *tensors)
    B, Hq, hd = q.shape
    P, page, Hkv, _ = k_pages.shape
    scale = scale if scale is not None else 1.0 / (hd ** 0.5)
    out = torch.empty_like(q)
    n_pages = block_table.shape[1]
    if out.numel() == 0 or n_pages * page == 0:
        return out.zero_()
    splits = splits_of(n_pages, page)
    scratch = torch.empty(B * Hq * splits * (hd + 2), dtype=torch.float32,
                          device=q.device)
    if isinstance(q, FakeTensor):          # a dry trace: no launch
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


def paged_decode_partials(
    q: torch.Tensor,              # (B, Hq, hd)
    k_pages: torch.Tensor,        # (P, page, Hkv, hd) this rank's pages
    v_pages: torch.Tensor,        # (P, page, Hkv, hd)
    block_table: torch.Tensor,    # (B, n_pages) int32; < 0: not held here
    seq_lens: torch.Tensor,       # (B,) int32
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The shard mode: one rank's partials, flat fp32 ``o`` (B, Hq, ns,
    hd), ``m``, ``l`` (B, Hq, ns), ns = :func:`splits_of` the table row
    (:func:`ref.paged_decode_partials` on CPU tensors, the split kernel
    alone on CUDA tensors, under the same checks as
    :func:`paged_decode_attention`).  A split with no live key here has
    m = -inf and l = 0, and its o is left unwritten by the kernel (a dry
    trace counts every split live: the data decides)."""
    global shard_launches
    tensors = (q, k_pages, v_pages, block_table, seq_lens)
    if _on_cpu(tensors):
        return ref.paged_decode_partials(q, k_pages, v_pages, block_table,
                                         seq_lens, scale=scale)
    _check("paged_decode_partials", *tensors)
    B, Hq, hd = q.shape
    P, page, Hkv, _ = k_pages.shape
    n_pages = block_table.shape[1]
    splits = splits_of(n_pages, page)
    scale = scale if scale is not None else 1.0 / (hd ** 0.5)
    part = torch.empty(B * Hq * splits * (hd + 2), dtype=torch.float32,
                       device=q.device)
    if part.numel() == 0:
        return part
    if isinstance(q, FakeTensor):          # a dry trace: no launch
        roofline.DRY.record("paged_decode_partials",
                            roofline.paged_partials_cost(
                                B, Hq, Hkv, hd, P * page,
                                block_table.numel(), splits, B * splits))
        return part
    fn = _build.function("dmath_paged_partials_bf16", _PART_ARGTYPES)
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_table.data_ptr(), seq_lens.data_ptr(), part.data_ptr(),
            B, Hq, Hkv, hd, page, n_pages, float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "paged_decode_partials")
    shard_launches += 1
    return part


def paged_decode_combine(parts: torch.Tensor, B: int, Hq: int, hd: int,
                         splits: int) -> torch.Tensor:
    """(B, Hq, hd) bf16 from ``parts`` (n, B * Hq * splits * (hd + 2)),
    the n ranks' :func:`paged_decode_partials` in rank order: the plain
    version (:func:`ref.paged_decode_combine`) on a CPU tensor, the
    combine kernel on a CUDA one."""
    global combine_launches
    n = parts.shape[0]
    if parts.dim() != 2 or parts.shape[1] != B * Hq * splits * (hd + 2):
        raise ValueError(f"paged_decode_combine: parts {tuple(parts.shape)}"
                         f" for B {B}, Hq {Hq}, hd {hd}, splits {splits}")
    fake = isinstance(parts, FakeTensor)
    if parts.device.type == "cpu" and not fake:
        return ref.paged_decode_combine(parts, B, Hq, hd, splits)
    if parts.device.type != "cuda" and not fake:
        raise ValueError("paged_decode_combine: the kernel needs a CUDA "
                         f"tensor, got {parts.device}")
    if parts.dtype != torch.float32 or not parts.is_contiguous():
        raise TypeError("paged_decode_combine kernel takes contiguous fp32 "
                        "partials")
    out = torch.empty((B, Hq, hd), dtype=torch.bfloat16,
                      device=parts.device)
    if out.numel() == 0:
        return out
    if fake:
        roofline.DRY.record("paged_decode_combine",
                            roofline.paged_combine_cost(
                                n, B, Hq, hd, splits, n * B * splits))
        return out
    fn = _build.function("dmath_paged_combine_ranks_bf16", _COMBINE_ARGTYPES)
    rc = fn(parts.data_ptr(), out.data_ptr(), n, B, Hq, hd, splits,
            torch.cuda.current_stream(parts.device).cuda_stream)
    _build.check(rc, "paged_decode_combine")
    combine_launches += 1
    return out
