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
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

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
            wide: bool = False) -> torch.Tensor:
    """Gated MLP: act(x @ w_gate) * (x @ w_in) @ w_out.

    By default ``act(g)`` and ``h`` are each rounded to ``x``'s dtype and
    multiplied there, as the reference's ``glu_mlp`` (its paged and decode
    steps).  ``wide`` multiplies them in fp32 and rounds the product once,
    as the reference's ``glu_mlp_shardmap`` (its full-sequence forward on
    one device, where the default plan sets ``seq_parallel_residual``)."""
    g = precision.einsum("bsd,df->bsf", x, w_gate, policy=policy)
    h = precision.einsum("bsd,df->bsf", x, w_in, policy=policy)
    if wide:
        h = (act_fn(act)(g.float()) * h.float()).to(x.dtype)
    else:
        h = act_fn(act)(g.float()).to(x.dtype) * h.to(x.dtype)
    out = precision.einsum("bsf,fd->bsd", h, w_out, policy=policy)
    return out.to(x.dtype)


def embed(tokens: torch.Tensor, table: torch.Tensor, *, scale: bool
          ) -> torch.Tensor:
    x = table[tokens]
    if scale:
        x = x * torch.tensor(table.shape[-1] ** 0.5, dtype=x.dtype)
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
