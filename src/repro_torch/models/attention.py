"""Attention, ported from the reference's ``models/attention.py``: the
full-sequence forward of the train path and the dense prefill, one decode
step against a dense KV cache or a local layer's sliding-window ring, and
against the paged KV pool one decode step and one prefill chunk.

The caches are updated **in place** (``index_put_``), where the
reference's jitted steps donate them and return new ones; the functions
still return them so their signatures match the reference's.  Indices
the reference would clamp on device (a chunk past the end of its table
row) raise here instead.  The dense cache's decode step, and the ring's,
attend through the paged-decode kernel, each slot's cache row (or ring)
being one page.

Serving on a mesh (the dense family) has functions of its own at the
end of this module: the residual whole on every rank of the model axis,
the KV cache sharded on the sequence, flash-decoding over the shards.

On a ``(data, model)`` mesh :func:`forward` dispatches on the plan's
``attn_mode`` as the reference's does: head-TP over the sequence-sharded
residual (:func:`_tp_attention_shardmap`: the bf16 residual gathered
over the model axis, this rank's heads over the whole sequence, the
partial out-projection reduce-scattered in bf16), head-TP over a
replicated residual (the reference's constrained branch, for
``seq_parallel_residual=False``), or sequence-parallel attention
(:func:`_sp_attention`: the local query block against the gathered K/V
at ``q_offset = idx * S/tp``) where the head counts do not divide the
axis.  qk-norm, windows and the softcap apply as on one rank.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import distributed as dist_mod
from repro_torch.core import precision
from repro_torch.core.layout import Layout, constrain
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.params import ParamSpec, plan_layout


def attn_specs(cfg, plan=None, mesh=None) -> Dict[str, ParamSpec]:
    """The attention leaves; given a plan and a mesh, with the plan's
    layouts (the reference's ``attn_specs``)."""
    D, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    lay = functools.partial(plan_layout, plan, mesh)
    s = {
        "wq": ParamSpec((D, H, hd), layout=lay("attn_qkv", (D, H, hd))),
        "wk": ParamSpec((D, Hkv, hd), layout=lay("attn_qkv", (D, Hkv, hd))),
        "wv": ParamSpec((D, Hkv, hd), layout=lay("attn_qkv", (D, Hkv, hd))),
        "wo": ParamSpec((H, hd, D), init="scaled",
                        scale=0.02 / max(1, 2 * cfg.n_layers) ** 0.5,
                        layout=lay("attn_out", (H, hd, D))),
    }
    head = (plan.tp_axis if plan is not None and plan.attn_mode == "head_tp"
            else None)
    vec = None if plan is None else Layout((head, None))
    if cfg.qkv_bias:
        s["bq"] = ParamSpec((H, hd), init="zeros", layout=vec)
        s["bk"] = ParamSpec((Hkv, hd), init="zeros", layout=vec)
        s["bv"] = ParamSpec((Hkv, hd), init="zeros", layout=vec)
    if cfg.qk_norm:
        norm = None if plan is None else Layout((None,))
        s["q_norm"] = ParamSpec((hd,), init="ones", layout=norm)
        s["k_norm"] = ParamSpec((hd,), init="ones", layout=norm)
    return s


def _qkv(x, p, cfg, positions, policy):
    """Projections (+ bias), qk-norm and rotary; x (B, S, D) -> q, k, v
    (B, S, H, hd) in x's dtype.  Bias, the per-head RMSNorm of q and k and
    rotary apply to the fp32 products, as in the reference."""
    q = precision.einsum("bsd,dhk->bshk", x, p["wq"], policy=policy)
    k = precision.einsum("bsd,dhk->bshk", x, p["wk"], policy=policy)
    v = precision.einsum("bsd,dhk->bshk", x, p["wv"], policy=policy)
    if cfg.qkv_bias:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    if cfg.qk_norm:
        q = layers.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = layers.rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = layers.rotary(q, positions, cfg.rope_theta)
    k = layers.rotary(k, positions, cfg.rope_theta)
    return q.to(x.dtype), k.to(x.dtype), v.to(x.dtype)


def _flash(q, k, v, cfg, window, q_offset=0):
    """:func:`ops.attention` on (B, S, H, hd) tensors, causal."""
    return ops.attention(
        q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
        v.transpose(1, 2).contiguous(), causal=True, window=window,
        softcap=cfg.attn_softcap, q_offset=q_offset,
    ).transpose(1, 2)                                          # (B,S,H,hd)


def forward(
    x: torch.Tensor,               # (B, S, D)
    p: dict,
    cfg,
    *,
    policy=precision.MIXED,
    window: Optional[int] = None,
    with_cache: bool = False,
    mesh=None,
    plan=None,
    hidden: Optional[Layout] = None,
):
    """Full-sequence causal attention (train, and the dense prefill):
    projections and rotary at positions 0..S-1,
    :func:`repro_torch.kernels.ops.attention` over the whole sequence,
    output projection.  Returns ``y``, or with ``with_cache`` ``(y, (k,
    v))``, the rotated keys and values (B, S, Hkv, hd) in x's dtype for
    the decode cache.  The reference's single-device ``head_tp`` branch;
    Given a ``mesh`` and its ``plan``, ``x`` is this rank's block of the
    residual in the ``hidden`` layout and ``p`` this rank's blocks; the
    result is in the same layout (no cache: serving on a mesh runs
    :func:`prefill_mesh` and the decode functions below)."""
    if mesh is not None:
        return _forward_mesh(x, p, cfg, plan, mesh, hidden, policy=policy,
                             window=window)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    q, k, v = _qkv(x, p, cfg, positions, policy)              # (B,S,H,hd)
    out = ops.attention(
        q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
        v.transpose(1, 2).contiguous(), causal=True, window=window,
        softcap=cfg.attn_softcap,
    ).transpose(1, 2)                                          # (B,S,H,hd)
    y = precision.einsum("bshk,hkd->bsd", out, p["wo"], policy=policy)
    if with_cache:
        return y.to(x.dtype), (k, v)
    return y.to(x.dtype)


def _forward_mesh(x, p, cfg, plan, mesh, hidden, *, policy, window):
    tp = plan.tp_axis
    if plan.attn_mode == "head_tp" and plan.seq_parallel_residual:
        return _tp_attention_shardmap(x, p, cfg, plan, mesh, policy=policy,
                                      window=window)
    if plan.attn_mode == "head_tp":
        # the residual is whole on every rank of the axis; each runs its
        # heads, and the out-projection's shares are summed in bf16
        x = dist_mod.copy_ad(x, mesh, tp)
        positions = torch.arange(x.shape[1], device=x.device)
        q, k, v = _qkv(x, p, cfg, positions, policy)
        out = _flash(q, k, v, cfg, window)
        y = precision.einsum("bshk,hkd->bsd", out, p["wo"], policy=policy)
        return dist_mod.psum_ad(y.to(x.dtype), mesh, tp)
    seq = Layout((hidden.dims[0], tp, None))
    out = _sp_attention(constrain(x, seq, mesh, src=hidden), p, cfg, plan,
                        mesh, policy=policy, window=window)
    y = precision.einsum("bshk,hkd->bsd", out, p["wo"], policy=policy)
    return constrain(y.to(x.dtype), hidden, mesh, src=seq)


def _tp_attention_shardmap(x, p, cfg, plan, mesh, *, policy, window):
    """Head-TP attention with explicit bf16 collectives: gather the
    sequence-sharded residual (B, S/tp, D) once, project this rank's
    heads (the weights' head blocks), flash over the whole sequence, the
    partial out-projection, and the bf16 reduce-scatter back onto the
    sequence shards."""
    tp = plan.tp_axis
    xg = dist_mod.all_gather_ad(x, mesh, tp, 1)                # bf16 wire
    positions = torch.arange(xg.shape[1], device=x.device)
    q, k, v = _qkv(xg, p, cfg, positions, policy)
    out = _flash(q, k, v, cfg, window)
    y = precision.einsum("bshk,hkd->bsd", out, p["wo"], policy=policy)
    return dist_mod.psum_scatter_ad(y.to(x.dtype), mesh, tp, 1)


def _sp_attention(x, p, cfg, plan, mesh, *, policy, window):
    """Sequence-parallel attention: ``x`` is this rank's sequence block
    (B, S/tp, D); its queries at positions ``idx * S/tp + j`` attend to
    the K/V all-gathered over the model axis, with ``q_offset = idx *
    S/tp`` (the only collectives).  Returns the block of the attention
    output (B, S/tp, H, hd)."""
    tp = plan.tp_axis
    s_loc = x.shape[1]
    off = mesh.coords[tp] * s_loc
    positions = off + torch.arange(s_loc, device=x.device)
    q, k, v = _qkv(x, p, cfg, positions, policy)
    kg = dist_mod.all_gather_ad(k, mesh, tp, 1)                # (B,S,Hkv,hd)
    vg = dist_mod.all_gather_ad(v, mesh, tp, 1)
    return _flash(q, kg, vg, cfg, window, q_offset=off)


def decode(
    x: torch.Tensor,               # (B, 1, D)
    p: dict,
    cfg,
    k_cache: torch.Tensor,         # (B, T, Hkv, hd), written in place
    v_cache: torch.Tensor,
    pos: torch.Tensor,             # scalar or (B,) position of the new token
    *,
    policy=precision.MIXED,
    window: Optional[int] = None,
    block_table: Optional[torch.Tensor] = None,
    seq_lens: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step against the dense cache: each slot's new K/V are
    written at its own position, then attention runs through
    :func:`repro_torch.kernels.ops.paged_decode_attention` with the cache
    as a pool of B pages of T positions, slot b's row being page b
    (``block_table = arange(B)[:, None]``, ``seq_lens = pos + 1``).  The
    kernel splits at fixed positions whatever the page size and never
    reads past ``seq_lens``, so positions past a prompt may hold stale
    values, and its result is bitwise that of the same K/V in any other
    paging.  A caller stepping every layer passes ``block_table`` and
    ``seq_lens`` built once per step.  The caller guarantees ``0 <= pos
    < T``.

    The reference attends with the plain ``layers.decode_attention``,
    which also takes a sliding window and a softcap; the kernel takes
    neither, and no config reaches them (no config sets a softcap;
    gemma3's global layers take no window and its local layers decode on
    their ring, :func:`decode_ring`), so they raise."""
    if window is not None or cfg.attn_softcap is not None:
        raise NotImplementedError(
            "dense-cache decode with a sliding window or a logit softcap: "
            "the paged-decode kernel takes neither (ROADMAP queue 2, item "
            "3); a windowed config's local layers decode on their ring "
            "(attention.decode_ring)")
    pos_b = pos.expand(x.shape[0])
    if seq_lens is None:
        seq_lens = (pos_b + 1).to(torch.int32)
    return _decode_rows(x, p, cfg, k_cache, v_cache, pos, pos_b,
                        block_table, seq_lens, policy)


def _decode_rows(x, p, cfg, k_rows, v_rows, pos, slot, block_table,
                 seq_lens, policy):
    """The one-page-a-slot decode step of :func:`decode` and
    :func:`decode_ring`: each slot's new K/V written at index ``slot`` of
    its row ``block_table[b, 0]`` of ``k_rows``/``v_rows`` (in place),
    then the paged-decode kernel over the rows' first ``seq_lens``
    entries and the output projection."""
    B = x.shape[0]
    positions = pos[None] if pos.dim() == 0 else pos[:, None]
    q, k, v = _qkv(x, p, cfg, positions, policy)              # (B,1,H,hd)
    if block_table is None:
        block_table = torch.arange(B, dtype=torch.int32,
                                   device=x.device)[:, None]
    rows = block_table[:, 0]
    k_rows.index_put_((rows, slot), k[:, 0].to(k_rows.dtype))
    v_rows.index_put_((rows, slot), v[:, 0].to(v_rows.dtype))
    out = ops.paged_decode_attention(
        q[:, 0].to(k_rows.dtype).contiguous(), k_rows, v_rows,
        block_table, seq_lens)                                 # (B,H,hd)
    y = precision.einsum("bshk,hkd->bsd", out[:, None].to(q.dtype),
                         p["wo"], policy=policy)
    return y.to(x.dtype), k_rows, v_rows


def decode_ring(
    x: torch.Tensor,               # (B, 1, D)
    p: dict,
    cfg,
    k_ring: torch.Tensor,          # (B, W, Hkv, hd) sliding-window ring
    v_ring: torch.Tensor,
    pos: torch.Tensor,             # scalar or (B,) position of the new token
    *,
    policy=precision.MIXED,
    block_table: Optional[torch.Tensor] = None,
    seq_lens: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step of a local (sliding-window) layer on its O(window)
    ring: each slot's new K/V go to ring slot ``pos mod W``, then
    attention runs through
    :func:`repro_torch.kernels.ops.paged_decode_attention` with each
    slot's ring as one page of W (``block_table = arange(B)[:, None]``)
    and ``seq_lens = min(pos + 1, W)``.  A ring filled in order holds its
    live positions (those >= 0 in the reference's
    ``decode_attention_ring``) at slots j < min(pos + 1, W); the kernel
    takes the keys as a set, rotated at their absolute positions, and
    reads nothing past ``seq_lens``, so slots a longer earlier prompt left
    after a refill are never read.  A caller stepping every layer passes
    ``block_table`` and ``seq_lens`` built once per step.  The kernel
    takes no softcap, so one raises, as in :func:`decode`."""
    if cfg.attn_softcap is not None:
        raise NotImplementedError(
            "ring decode with a logit softcap: the paged-decode kernel "
            "takes none (ROADMAP queue 2, item 3)")
    W = k_ring.shape[1]
    pos_b = pos.expand(x.shape[0])
    if seq_lens is None:
        seq_lens = torch.clamp(pos_b + 1, max=W).to(torch.int32)
    return _decode_rows(x, p, cfg, k_ring, v_ring, pos,
                        torch.remainder(pos_b, W), block_table, seq_lens,
                        policy)


def decode_paged(
    x: torch.Tensor,               # (B, 1, D)
    p: dict,
    cfg,
    k_pages: torch.Tensor,         # (P, page, Hkv, hd), written in place
    v_pages: torch.Tensor,
    block_table: torch.Tensor,     # (B, n_pages) int32 logical -> physical
    pos: torch.Tensor,             # scalar or (B,) position of the new token
    *,
    policy=precision.MIXED,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step: the new token's K/V go to physical page
    ``block_table[b, pos // page]`` at offset ``pos % page``, then
    attention walks the sequence's pages through
    :func:`repro_torch.kernels.ops.paged_decode_attention` with
    ``seq_lens = pos + 1``.  The caller guarantees
    ``0 <= pos < n_pages * page`` (the engines check it on the host)."""
    B = x.shape[0]
    page = k_pages.shape[1]
    positions = pos[None] if pos.dim() == 0 else pos[:, None]
    q, k, v = _qkv(x, p, cfg, positions, policy)              # (B,1,H,hd)

    pos_b = pos.expand(B).long()
    phys = block_table[torch.arange(B, device=x.device), pos_b // page]
    off = pos_b % page
    k_pages.index_put_((phys.long(), off), k[:, 0].to(k_pages.dtype))
    v_pages.index_put_((phys.long(), off), v[:, 0].to(v_pages.dtype))

    seq_lens = (pos_b + 1).to(torch.int32)
    out = ops.paged_decode_attention(
        q[:, 0].to(k_pages.dtype).contiguous(), k_pages, v_pages,
        block_table, seq_lens)                                 # (B,H,hd)
    y = precision.einsum("bshk,hkd->bsd", out[:, None].to(q.dtype),
                         p["wo"], policy=policy)
    return y.to(x.dtype), k_pages, v_pages


def prefill_chunk_paged(
    x: torch.Tensor,               # (1, C, D) one prompt chunk, end-padded
    p: dict,
    cfg,
    k_pages: torch.Tensor,         # (P, page, Hkv, hd), written in place
    v_pages: torch.Tensor,
    table_row: torch.Tensor,       # (n_pages,) int32 logical -> physical
    start: int,                    # absolute position of chunk[0]
    *,
    policy=precision.MIXED,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fixed-size prefill chunk for ONE sequence.

    Scatters the chunk's K/V into the sequence's pages through the table,
    gathers the row back in LOGICAL page order and runs flash attention
    with ``q_offset=start``, so the result does not depend on which
    physical pages the allocator handed out.  End-padding positions lie
    beyond every real query's causal horizon.  Only the pages up to the
    chunk's last position are gathered: the keys after it are masked for
    every query of the chunk, so leaving them out changes no value.

    Raises when the chunk runs past the end of the table row, where the
    reference's clamped scatter would overwrite live positions of the
    row's last page."""
    C = x.shape[1]
    page = k_pages.shape[1]
    n_pages = table_row.shape[0]
    if start < 0 or start + C > n_pages * page:
        raise ValueError(
            f"prefill chunk [{start}, {start + C}) runs past the table row "
            f"({n_pages} pages of {page}); the chunk size must divide the "
            "row length")
    positions = start + torch.arange(C, device=x.device)
    q, k, v = _qkv(x, p, cfg, positions, policy)              # (1,C,H,hd)

    row = table_row.long()
    phys = row[positions // page]
    off = positions % page
    k_pages.index_put_((phys, off), k[0].to(k_pages.dtype))
    v_pages.index_put_((phys, off), v[0].to(v_pages.dtype))

    n_live = -(-(start + C) // page)
    shape = (1, n_live * page) + tuple(k_pages.shape[2:])
    k_row = k_pages[row[:n_live]].reshape(shape)
    v_row = v_pages[row[:n_live]].reshape(shape)
    out = ops.attention(
        q.transpose(1, 2).contiguous(), k_row.transpose(1, 2).contiguous(),
        v_row.transpose(1, 2).contiguous(), causal=True,
        softcap=cfg.attn_softcap, q_offset=start,
    ).transpose(1, 2)                                          # (1,C,H,hd)
    y = precision.einsum("bshk,hkd->bsd", out, p["wo"], policy=policy)
    return y.to(x.dtype), k_pages, v_pages


# ---------------------------------------------------------------------------
# serving on a mesh: the KV cache sharded on the sequence
# ---------------------------------------------------------------------------
#
# Every rank of the model axis holds the whole residual (B, S, D) of its
# rows; the projections take the plan's layouts (this rank's heads under
# head-TP, whole heads under SP), and the KV cache holds a shard of the
# sequence with every kv head.  The new tokens' K/V (and a decode's q) are
# gathered over the heads once, only the rank that owns a position writes
# it, and attention over the shards is flash-decoding: each rank's
# shard-mode partials, all-gathered in rank order and combined by the
# kernel (the reference's GSPMD psum of the softmax statistics).  Under
# head-TP the output projection takes this rank's heads and the fp32
# shares are summed over the model axis.

def flat_index(mesh, axes) -> int:
    """This rank's index over ``axes`` (major first), the order in which
    ``distributed.all_gather`` concatenates their blocks."""
    i = 0
    for a in axes:
        i = i * mesh.shape[a] + mesh.coords[a]
    return i


def page_shard(table: torch.Tensor, n: int, r: int):
    """Physical page p > 0 of the global pool lives on rank (p - 1) % n
    of the ``n`` sequence shards, at local page (p - 1) // n + 1; every
    rank's local page 0 is its own NULL page (the global NULL page 0 is
    held nowhere).  Returns (held, local): whether this rank ``r`` holds
    each entry of ``table`` and its local page (0 where not held)."""
    held = (table > 0) & (torch.remainder(table - 1, n) == r)
    local = torch.where(held, torch.div(table - 1, n, rounding_mode="floor")
                        + 1, torch.zeros_like(table))
    return held, local


def local_pages(num_pages: int, n: int) -> int:
    """The pages of one rank's shard of a global pool of ``num_pages``
    (the NULL page included): its own NULL page and ceil((num_pages -
    1) / n), i.e. ceil(num_pages / n) when n divides num_pages - 1."""
    return 1 + -(-(num_pages - 1) // n)


def _heads_whole(ts, plan, mesh):
    """Tensors (B, S, H_i, hd) of this rank's heads -> of every head:
    under head-TP each rank projected its block of the heads, all of them
    gathered over the model axis in one all-gather (the blocks side by
    side, split back by rank); under SP every rank projected them all."""
    if plan.attn_mode != "head_tp":
        return ts
    n = mesh.shape[plan.tp_axis]
    sizes = [t.shape[2] for t in ts]
    every = dist_mod.all_gather(torch.cat(ts, 2).contiguous(), mesh,
                                plan.tp_axis, 2)
    every = every.unflatten(2, (n, sum(sizes)))
    return [p.flatten(2, 3) for p in every.split(sizes, 3)]


def _local_heads(t, plan, mesh):
    """This rank's block of the heads (dim 2) under head-TP, else all."""
    if plan.attn_mode != "head_tp":
        return t
    n, r = mesh.shape[plan.tp_axis], mesh.coords[plan.tp_axis]
    h = t.shape[2] // n
    return t[:, :, r * h:(r + 1) * h]


def _out_proj(out, p, plan, mesh, policy, dtype):
    """``out`` (B, S, H_rank, hd), this rank's heads under head-TP (all
    heads under SP), against ``p["wo"]``'s block: under head-TP the fp32
    shares summed over the model axis in rank order, then rounded once."""
    y = precision.einsum("bshk,hkd->bsd", out, p["wo"], policy=policy)
    if plan.attn_mode == "head_tp":
        y = dist_mod.psum(y.float().contiguous(), mesh, plan.tp_axis)
    return y.to(dtype)


def _combine_shards(q, k_rows, v_rows, table, lens, mesh, seq_axes):
    """Flash-decoding over the sequence shards: this rank's shard-mode
    partials, all-gathered over ``seq_axes`` in rank order, combined by
    the kernel.  q (B, H, hd) -> (B, H, hd) bf16, the same bits on every
    rank."""
    B, H, hd = q.shape
    part = ops.paged_decode_partials(q, k_rows, v_rows, table, lens)
    parts = dist_mod.all_gather(part[None], mesh, seq_axes, 0)
    splits = part.numel() // (B * H * (hd + 2))
    return ops.paged_decode_combine(parts.contiguous(), B, H, hd, splits)


def decode_mesh(x, p, cfg, k_rows, v_rows, pos, *, plan, mesh, seq_axes,
                offset: int, policy=precision.MIXED):
    """:func:`decode` on a rank's shard of the dense cache: ``k_rows``
    (B, T_loc, Hkv, hd) hold positions ``[offset, offset + T_loc)`` of this
    rank's rows ``x`` (B, 1, D) at positions ``pos`` (B,).  The rank that
    owns ``pos`` writes the new K/V; the shard-mode kernel reads the live
    positions of the shard (the lengths clipped to it) and the ranks'
    partials are combined over ``seq_axes``."""
    B = x.shape[0]
    T_loc = k_rows.shape[1]
    q, k, v = _heads_whole(_qkv(x, p, cfg, pos[:, None], policy), plan,
                               mesh)
    loc = pos - offset
    own = ((loc >= 0) & (loc < T_loc))[:, None, None]
    rows = torch.arange(B, device=x.device)
    idx = loc.clamp(0, T_loc - 1)
    for cache, new in ((k_rows, k), (v_rows, v)):
        cache.index_put_((rows, idx), torch.where(
            own, new[:, 0].to(cache.dtype), cache[rows, idx]))
    table = rows.to(torch.int32)[:, None]
    lens = (loc + 1).clamp(0, T_loc).to(torch.int32)
    out = _combine_shards(q[:, 0].to(k_rows.dtype).contiguous(), k_rows,
                          v_rows, table, lens, mesh, seq_axes)
    out = _local_heads(out[:, None].to(q.dtype), plan, mesh)
    return _out_proj(out, p, plan, mesh, policy, x.dtype)


def decode_paged_mesh(x, p, cfg, k_pages, v_pages, block_table, pos, *,
                      plan, mesh, seq_axes, policy=precision.MIXED):
    """:func:`decode_paged` on a rank's shard of the page pool
    (:func:`page_shard`: the global table's pages this rank holds, -1 for
    the rest): the owner of the new token's page writes it (the others
    write their own NULL page, never read), then the shard-mode partials
    are combined over ``seq_axes``."""
    B = x.shape[0]
    page = k_pages.shape[1]
    n, r = math.prod(mesh.shape[a] for a in seq_axes), flat_index(
        mesh, seq_axes)
    q, k, v = _heads_whole(_qkv(x, p, cfg, pos[:, None], policy), plan,
                               mesh)
    phys = block_table[torch.arange(B, device=x.device), pos // page]
    _, dst = page_shard(phys, n, r)
    k_pages.index_put_((dst.long(), pos % page), k[:, 0].to(k_pages.dtype))
    v_pages.index_put_((dst.long(), pos % page), v[:, 0].to(v_pages.dtype))
    held, local = page_shard(block_table, n, r)
    table = torch.where(held, local, -1).to(torch.int32)
    out = _combine_shards(q[:, 0].to(k_pages.dtype).contiguous(), k_pages,
                          v_pages, table, (pos + 1).to(torch.int32), mesh,
                          seq_axes)
    out = _local_heads(out[:, None].to(q.dtype), plan, mesh)
    return _out_proj(out, p, plan, mesh, policy, x.dtype)


def prefill_mesh(x, p, cfg, *, plan, mesh, policy=precision.MIXED):
    """The dense prefill's attention on a mesh: the whole prompt on every
    rank of the model axis, this rank's heads under head-TP, flash over
    them, the output projection summed over the axis.  Returns ``y`` and
    the prompt's K/V (B, S, Hkv, hd) with every kv head (gathered over
    the axis under head-TP: the relayout onto the cache's sequence
    shards, of which the caller keeps its own)."""
    positions = torch.arange(x.shape[1], device=x.device)
    q, k, v = _qkv(x, p, cfg, positions, policy)
    out = _flash(q, k, v, cfg, None)
    y = _out_proj(out, p, plan, mesh, policy, x.dtype)
    return y, tuple(_heads_whole((k, v), plan, mesh))


def held_pages(live_pages, n: int):
    """The live pages of a table row (host ints, logical order) by owner:
    for each of the ``n`` ranks the logical indices of the pages it holds
    (page p > 0 on rank (p - 1) % n, :func:`page_shard`).  The NULL page
    0 is held by none."""
    return [[j for j, p in enumerate(live_pages)
             if p > 0 and (p - 1) % n == r] for r in range(n)]


def prefill_chunk_paged_mesh(x, p, cfg, k_pages, v_pages, table_row, start,
                             *, plan, mesh, seq_axes, live_pages=None,
                             policy=precision.MIXED):
    """:func:`prefill_chunk_paged` on a rank's shard of the page pool: the
    chunk's K/V (every head) written by the owners of their pages, then
    the row's live pages gathered from their owners for flash over this
    rank's heads.  Each rank sends only the pages it holds
    (:func:`held_pages`), padded to the most any rank holds, so a rank
    receives (n - 1) times that many pages, about ceil(n_live / n), not
    the whole row.  A NULL entry (the end padding of a chunk past the
    prompt's last page) is read as zeros: its keys lie past every real
    query.  ``live_pages`` is the row's live pages on the host
    (``table_row[:ceil((start + C) / page)]``; read here when not given,
    one device-to-host copy: a caller stepping every layer passes it)."""
    C = x.shape[1]
    page = k_pages.shape[1]
    n_pages = table_row.shape[0]
    if start < 0 or start + C > n_pages * page:
        raise ValueError(
            f"prefill chunk [{start}, {start + C}) runs past the table row "
            f"({n_pages} pages of {page}); the chunk size must divide the "
            "row length")
    n, r = math.prod(mesh.shape[a] for a in seq_axes), flat_index(
        mesh, seq_axes)
    positions = start + torch.arange(C, device=x.device)
    q, k, v = _qkv(x, p, cfg, positions, policy)               # (1,C,H,hd)
    _, dst = page_shard(table_row[positions // page], n, r)
    for pages, new in zip((k_pages, v_pages),
                          _heads_whole((k, v), plan, mesh)):
        pages.index_put_((dst.long(), positions % page),
                         new[0].to(pages.dtype))

    n_live = -(-(start + C) // page)
    if live_pages is None:
        live_pages = table_row[:n_live].tolist()
    owned = held_pages(live_pages, n)
    most = max(len(o) for o in owned)
    # this rank's held pages (K and V), padded with its NULL page, in one
    # all-gather; then each logical page taken from its owner's block
    mine = torch.tensor([(live_pages[j] - 1) // n + 1 for j in owned[r]]
                        + [0] * (most - len(owned[r])), device=x.device)
    every = dist_mod.all_gather(
        torch.stack([k_pages[mine], v_pages[mine]], 1)[None].contiguous(),
        mesh, seq_axes, 0).flatten(0, 1)     # (n * most, 2, page, Hkv, hd)
    every = torch.cat([every, every.new_zeros((1,) + every.shape[1:])])
    src = {j: o * most + i for o, js in enumerate(owned)
           for i, j in enumerate(js)}
    got = every[torch.tensor([src.get(j, n * most) for j in range(n_live)],
                             device=x.device)]
    kv_rows = [_local_heads(got[:, j].reshape(
        (1, n_live * page) + got.shape[3:]), plan, mesh).contiguous()
        for j in (0, 1)]
    out = _flash(q, kv_rows[0], kv_rows[1], cfg, None, q_offset=start)
    return _out_proj(out, p, plan, mesh, policy, x.dtype)
