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
    result is in the same layout (no cache: serving on a mesh raises in
    the model)."""
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
