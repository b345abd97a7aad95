"""Common layers: norm, activation, rotary, gated MLP, embedding,
unembedding, the LM loss and decode attention over a dense cache and
over a sliding-window ring, ported from the reference's
``models/layers.py``.

Every product of the model's layers runs through
:func:`repro_torch.core.precision.einsum` (bf16 operands, fp32
accumulation, the GEMM kernel on the card).  :func:`decode_attention` is
the plain fp32 function the reference's dense decode step runs, and
:func:`decode_attention_ring` its local layers' ring; the port's decode
steps attend through the paged-decode kernel instead
(``attention.decode`` and ``attention.decode_ring``), and these functions
are their oracles.

On a ``(data, model)`` mesh each rank runs its blocks
(:mod:`repro_torch.core.planner`'s layouts): :func:`embed_shard_map`
takes from its D-column block of the table, :func:`glu_mlp_shardmap`
gathers the sequence-sharded bf16 residual, runs its column and row
blocks and reduce-scatters the bf16 result, :func:`glu_mlp` with
``tp_axis`` is the reference's GSPMD-style MLP on a replicated residual,
and :func:`lm_loss_sharded` is the loss over vocab shards.  Every
collective is one of :mod:`repro_torch.core.distributed`'s counted,
differentiable ones.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import distributed as dist_mod
from repro_torch.core import precision

NEG = -1e30


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * w.float()).to(x.dtype)


def _silu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.silu is x * sigmoid(x); ``F.silu`` divides by 1 + exp(-x)
    # instead and rounds an fp32 result otherwise in ~1/4 of values
    return x * torch.sigmoid(x)


def act_fn(name: str):
    # jax.nn.gelu defaults to the tanh approximation
    return (functools.partial(F.gelu, approximate="tanh") if name == "gelu"
            else _silu)


def rotary(x: torch.Tensor, positions: torch.Tensor, theta: float
           ) -> torch.Tensor:
    """x: (..., S, H, D) with D even; positions: (S,) or broadcastable."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].float() * freqs             # (S, half)
    cos = torch.cos(angles)[..., None, :]                      # (S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


def decode_attention(
    q: torch.Tensor,              # (B, Hq, 1, D) one new token
    k: torch.Tensor,              # (B, T, Hkv, D) cache, seq-major
    v: torch.Tensor,
    pos: torch.Tensor,            # scalar or (B,): index of the new token
    *,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One query token per slot against its dense cache row, in fp32:
    q widened and scaled, both products fp32 (the reference's
    ``precision.FULL``), the optional softcap, and keys after ``pos`` (or
    ``window`` or more before it) masked.  ``pos`` may be per slot."""
    B, Hq, _, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    qf = q.float().reshape(B, Hkv, g, D) * scale
    s = torch.einsum("bkgd,btkd->bkgt", qf, k.float())
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    kpos = torch.arange(T, device=q.device)
    if pos.dim() == 0:
        mask = kpos <= pos
        if window is not None:
            mask &= kpos > pos - window
        mask = mask[None, None, None, :]
    else:                          # per-slot positions: (B, T) mask
        mask = kpos[None, :] <= pos[:, None]
        if window is not None:
            mask &= kpos[None, :] > pos[:, None] - window
        mask = mask[:, None, None, :]
    p = torch.softmax(torch.where(mask, s, NEG), dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p, v.float())
    return out.reshape(B, Hq, 1, D).to(q.dtype)


def decode_attention_ring(
    q: torch.Tensor,              # (B, Hq, 1, D)
    k: torch.Tensor,              # (B, W, Hkv, D) ring buffer
    v: torch.Tensor,
    pos: torch.Tensor,            # scalar or (B,): the new token's position
    *,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Sliding-window decode over a ring-buffer cache, in fp32 as
    :func:`decode_attention`: slot j holds absolute position ``pos - ((pos
    - j) mod W)`` (its last write), and slots whose position is negative
    (not yet written) are masked.  The oracle of the local layers' decode
    (``attention.decode_ring``), which attends through the paged-decode
    kernel instead."""
    B, Hq, _, D = q.shape
    W, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    qf = q.float().reshape(B, Hkv, g, D) * scale
    s = torch.einsum("bkgd,bwkd->bkgw", qf, k.float())
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    j = torch.arange(W, device=q.device)
    if pos.dim() == 0:
        abs_pos = pos - torch.remainder(pos - j, W)
        mask = (abs_pos >= 0)[None, None, None, :]
    else:                          # per-slot positions: (B, W) mask
        abs_pos = pos[:, None] - torch.remainder(pos[:, None] - j[None, :],
                                                 W)
        mask = (abs_pos >= 0)[:, None, None, :]
    p = torch.softmax(torch.where(mask, s, NEG), dim=-1)
    out = torch.einsum("bkgw,bwkd->bkgd", p, v.float())
    return out.reshape(B, Hq, 1, D).to(q.dtype)


def glu_mlp(x, w_gate, w_in, w_out, *, act: str = "silu",
            policy: precision.Policy = precision.MIXED,
            wide: bool = False, pinned: Optional[bool] = None, mesh=None,
            tp_axis: Optional[str] = None) -> torch.Tensor:
    """Gated MLP: act(x @ w_gate) * (x @ w_in) @ w_out.

    By default ``act(g)`` and ``h`` are each rounded to ``x``'s dtype and
    multiplied there, as the reference's ``glu_mlp`` (its paged and decode
    steps); ``pinned`` first rounds ``g`` and ``h`` to the activation
    dtype, as its ``h_layout`` form does (zamba2's shared block on a
    replicated residual).  ``wide`` multiplies them in fp32 and rounds
    the product once, as the reference's ``glu_mlp_shardmap`` (its
    full-sequence forward on one device, where the default plan sets
    ``seq_parallel_residual``).

    With ``tp_axis`` (the reference's ``h_layout`` / ``out_layout`` MLP of
    the ``seq_parallel_residual=False`` plan): ``x`` is the residual every
    rank of the axis holds, the weights are this rank's column (gate,
    in) and row (out) blocks, ``g`` and ``h`` are pinned in the
    activation dtype, and the row products' shares are summed over the
    axis in fp32 (the reference's constraint on the fp32 product);
    ``pinned=False`` leaves ``g`` and ``h`` as the one-device form rounds
    them (serving on a mesh, whose tokens are the one-device ones).
    ``pinned`` defaults to whether ``tp_axis`` is given."""
    if pinned is None:
        pinned = tp_axis is not None
    if tp_axis is not None:
        x = dist_mod.copy_ad(x, mesh, tp_axis)
    g = precision.einsum("bsd,df->bsf", x, w_gate, policy=policy)
    h = precision.einsum("bsd,df->bsf", x, w_in, policy=policy)
    if pinned:
        g, h = g.to(policy.activation_dtype), h.to(policy.activation_dtype)
    if wide:
        h = (act_fn(act)(g.float()) * h.float()).to(x.dtype)
    else:
        h = act_fn(act)(g.float()).to(x.dtype) * h.to(x.dtype)
    out = precision.einsum("bsf,fd->bsd", h, w_out, policy=policy)
    if tp_axis is not None:
        out = dist_mod.psum_ad(out, mesh, tp_axis)
    return out.to(x.dtype)


def glu_mlp_shardmap(x, w_gate, w_in, w_out, *, act: str, mesh, plan,
                     policy: precision.Policy = precision.MIXED
                     ) -> torch.Tensor:
    """Tensor-parallel gated MLP with explicit bf16 collectives: gather
    the sequence-sharded residual ``x`` (B, S/tp, D) over the model axis,
    the column blocks (D, F/tp), ``act(g) * h`` in fp32, the row block
    (F/tp, D), and the bf16 reduce-scatter back onto the sequence shards.
    The backward is the transpose: a reduce-scatter of d_x, an
    all-gather of d_out, both bf16."""
    tp = plan.tp_axis
    xg = dist_mod.all_gather_ad(x, mesh, tp, 1)                # bf16 wire
    g = precision.einsum("bsd,df->bsf", xg, w_gate, policy=policy)
    h = precision.einsum("bsd,df->bsf", xg, w_in, policy=policy)
    h = act_fn(act)(g.float()) * h.float()
    out = precision.einsum("bsf,fd->bsd", h.to(x.dtype), w_out,
                           policy=policy)
    return dist_mod.psum_scatter_ad(out.to(x.dtype), mesh, tp, 1)


def embed(tokens: torch.Tensor, table: torch.Tensor, *, scale: bool
          ) -> torch.Tensor:
    x = table[tokens]
    if scale:
        x = x * torch.tensor(table.shape[-1] ** 0.5, dtype=x.dtype)
    return x


def embed_shard_map(tokens: torch.Tensor, table: torch.Tensor, mesh, *,
                    tp_axis: str, scale: bool) -> torch.Tensor:
    """This rank's rows ``tokens`` (B, S) against its (V, D/tp) column
    block of the table: a local take, (B, S, D/tp), the block of
    ``Layout((batch, None, tp_axis))``.  The backward scatter-adds into
    the block (duplicate ids add up).  The scale is the whole width's."""
    x = table[tokens]
    if scale:
        d_full = table.shape[-1] * mesh.shape[tp_axis]
        x = x * torch.tensor(d_full ** 0.5, dtype=x.dtype)
    return x


def unembed(x: torch.Tensor, w: torch.Tensor, *,
            policy: precision.Policy = precision.MIXED) -> torch.Tensor:
    """fp32 logits (the einsum's accumulator, as in the reference)."""
    return precision.einsum("bsd,dv->bsv", x, w, policy=policy)


def lm_loss(logits: torch.Tensor, labels: torch.Tensor, *, vocab_real: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean cross-entropy over the labels >= 0 and its denominator (the
    count of those labels, at least 1), as the reference's ``lm_loss``.
    Vocab padding columns (``>= vocab_real``) are masked to ``NEG``.  The
    gold logit is gathered where the reference reduces an iota == label
    mask: the same value (a sum of one logit and zeros), without a
    second (B, S, V) tensor."""
    V = logits.shape[-1]
    lf = logits.float()
    pad = torch.arange(V, device=lf.device) >= vocab_real
    lf = torch.where(pad, NEG, lf)
    logz = torch.logsumexp(lf, dim=-1)                       # (B, S)
    valid = labels >= 0
    gold = torch.gather(lf, -1, torch.where(valid, labels, 0).long()
                        [..., None])[..., 0]
    validf = valid.float()
    nll = (logz - gold) * validf
    denom = torch.clamp(validf.sum(), min=1.0)
    return nll.sum() / denom, denom


class _VocabShardedLoss(torch.autograd.Function):
    """Cross-entropy of this rank's rows over logits sharded on the vocab
    (the block (B, S, V/tp) from column ``v0``): forward with a max and a
    sum across the axis; backward, softmax minus one-hot on the local
    shard, scaled by the row's validity over the global denominator."""

    @staticmethod
    def forward(ctx, logits, labels, mesh, axis, v0, vocab_real, denom):
        lf = logits.float()
        col = v0 + torch.arange(lf.shape[-1], device=lf.device)
        lf = torch.where(col >= vocab_real, NEG, lf)
        m = dist_mod.pmax(lf.amax(-1), mesh, axis)               # (B, S)
        se = dist_mod.psum(torch.exp(lf - m[..., None]).sum(-1), mesh, axis)
        logz = m + torch.log(se)
        hit = col == labels[..., None]
        gold = dist_mod.psum(torch.where(hit, lf, 0.0).sum(-1), mesh, axis)
        validf = (labels >= 0).float()
        ctx.save_for_backward(lf, logz, hit, validf, denom)
        ctx.dtype = logits.dtype
        return ((logz - gold) * validf).sum() / denom

    @staticmethod
    def backward(ctx, g):
        lf, logz, hit, validf, denom = ctx.saved_tensors
        p = torch.exp(lf - logz[..., None])
        d = (p - hit.float()) * (validf * (g / denom))[..., None]
        return d.to(ctx.dtype), None, None, None, None, None, None


def lm_loss_sharded(logits: torch.Tensor, labels: torch.Tensor, *,
                    vocab_real: int, mesh, tp_axis: str, batch_axes
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`lm_loss` on this rank's rows and vocab shard: ``logits``
    (B, S, V/tp), this rank's block of ``Layout((batch, None, tp))``,
    ``labels`` (B, S) its rows.  The log-sum-exp takes a max and a sum
    across ``tp_axis``; the gold logit is a masked local sum plus a sum
    across it; padding columns (at or past ``vocab_real``) are masked on
    whichever shard holds them; the denominator counts the valid labels
    of every rank (a sum over ``batch_axes``, empty when the rows are not
    split).  Returns ``(share, loss, denom)``: ``share``, this rank's
    rows' part of the mean, is what the rank differentiates (the loss is
    their sum over ``batch_axes``, and the same on every rank of
    ``tp_axis``: each seeds its backward with one, and the gradient of
    its local logits is whole); ``loss`` is the mean over the global
    batch."""
    v0 = logits.shape[-1] * mesh.coords[tp_axis]
    valid = (labels >= 0).float().sum()
    denom = torch.clamp(dist_mod.psum(valid, mesh, batch_axes), min=1.0) \
        if batch_axes else torch.clamp(valid, min=1.0)
    share = _VocabShardedLoss.apply(logits, labels, mesh, tp_axis, v0,
                                    vocab_real, denom)
    loss = dist_mod.psum(share.detach(), mesh, batch_axes) if batch_axes \
        else share.detach()
    return share, loss, denom
