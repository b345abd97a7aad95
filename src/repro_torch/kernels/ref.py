"""Plain PyTorch versions of the ported kernels.

Each function is the semantic definition its CUDA kernel is held against
(fp32 math throughout), following the JAX reference's ``kernels/ref.py``.
The wrappers in ``gemm.py``, ``flash_attention.py``,
``paged_attention.py``, ``ssd_scan.py`` and ``fused.py`` run them for
tensors on the CPU;
on the card they only serve as the comparison in tests and
``chip_smoke.py``.  ``paged_decode_split_combine`` is the paged
kernel's split-and-combine order, for tests; ``paged_decode_partials``
and ``paged_decode_combine`` are its shard mode (a rank's shard of the
sequence) and the combine of the ranks' partials.  ``attention_backward`` is
autograd through the plain
``attention``: the definition the backward kernel is held against.  ``ssd`` is
the sequential definition of the SSD scan, which tests hold the chunked
plain version (``ssd_scan.ssd_plain``) and the kernel against;
``ssd_step`` is the single-token decode step, which is plain PyTorch on
every device, as in the reference.

The int8 functions round as the reference does under ``jit`` (its
production form), not as eager JAX does: XLA compiles the scale
``absmax / 127 + 1e-12`` to ``fma(absmax, fl32(1/127), fl32(1e-12))``,
which :func:`int8_scale` reproduces; the divisions by a scale stay true
divisions, as XLA keeps them for a traced divisor.

One deliberate difference: an attention row with no visible key gives
zeros, as the model's attention in the reference does
(``layers.flash_attention_jnp``), where the reference oracle gives NaN;
its gradients are zero too.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def matmul(a: torch.Tensor, b: torch.Tensor,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """C = A @ B with fp32 accumulation regardless of storage dtype;
    batched, (E, M, K) @ (E, K, N), the 2-D product per slice."""
    out_dtype = out_dtype or a.dtype
    if a.dim() == 3 or b.dim() == 3:
        if a.shape[:-2] != b.shape[:-2] or a.shape[-1] != b.shape[-2]:
            raise ValueError(f"matmul: shapes {tuple(a.shape)} @ "
                             f"{tuple(b.shape)} do not chain")
        return torch.stack([matmul(x, y, out_dtype) for x, y in zip(a, b)])
    return torch.matmul(a.float(), b.float()).to(out_dtype)


def matmul_dequant(a: torch.Tensor, b_q: torch.Tensor,
                   b_scale: torch.Tensor,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """C = (A @ B_q) * scale[N]: the int8 weights widened to ``a``'s dtype
    (exact, |q| <= 127), the product with an fp32 accumulator, the
    per-column scale applied to the fp32 result, one cast to
    ``out_dtype`` (default ``a.dtype``)."""
    out_dtype = out_dtype or a.dtype
    c = torch.matmul(a.float(), b_q.to(a.dtype).float())
    return (c * b_scale.float()[None, :]).to(out_dtype)


# fl32(1/127) and fl32(1e-12): the constants of the reference's jitted scale
_INV127 = float.fromhex("0x1.020408p-7")
_EPS = float.fromhex("0x1.197998p-40")


def int8_scale(absmax: torch.Tensor) -> torch.Tensor:
    """The int8 format's scale as the reference computes it under ``jit``:
    ``fmaf(absmax, fl32(1/127), fl32(1e-12))``, fp32, on ``absmax``'s
    device and of its shape.  Computed in float64, where the product of
    two fp32 values is exact, with one add and one rounding to fp32 (a
    double rounding that ``tests/test_torch_comms.py`` pins against the
    jitted reference over a sweep of absmax values)."""
    return (absmax.double() * _INV127 + _EPS).float()


def quantize_compress(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8 in ``x``'s shape, scale fp32 0-d): absmax and quantize in
    one, ``scale = int8_scale(max|x|)`` and ``q = clip(round(x / scale),
    ±127)`` with IEEE fp32 division and round-half-to-even; fp32 or bf16
    ``x`` (widened exactly)."""
    v = x.float()
    scale = int8_scale(v.abs().max())
    q = torch.clamp(torch.round(v / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_compress_ef(g: torch.Tensor, err: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(deq, new_err, scale) of ``v = g.float() + err``: ``q, scale =
    quantize_compress(v)``, ``deq = q * scale`` in fp32 and the new error
    ``v - q * scale`` rounded once, as XLA's ``fma(-q, scale, v)`` (exact
    in float64: q * scale has at most 32 significant bits, and its
    difference from v spans at most 33)."""
    v = g.float() + err
    q, scale = quantize_compress(v)
    deq = q.float() * scale
    new_err = (v.double() - q.double() * scale.double()).float()
    return deq, new_err, scale


def quantize_int8_per_channel(w: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-column int8 weights for :func:`matmul_dequant`:
    (q (K, N) int8, scale (N,) fp32), each column's scale
    ``int8_scale(max |w[:, n]|)``."""
    v = w.float()
    scale = int8_scale(v.abs().amax(dim=0))
    q = torch.clamp(torch.round(v / scale[None, :]), -127, 127).to(
        torch.int8)
    return q, scale


def quantize_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Round/clip/cast against a precomputed (group-agreed) scale:
    ``clip(round(x / scale), ±127)`` as int8, with IEEE fp32 division and
    round-half-to-even, as the reference's ``ref.quantize_int8``."""
    v = x.float()
    return torch.clamp(torch.round(v / scale.float()), -127, 127).to(
        torch.int8)


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
    B, Hq, S, D = q.shape
    _, Hkv, T, _ = k.shape
    g = Hq // Hkv
    scale = scale if scale is not None else 1.0 / (D ** 0.5)

    qf = q.float() * scale
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    scores = qf @ kf.transpose(-1, -2)
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)

    qpos = torch.arange(S, device=q.device) + q_offset
    kpos = torch.arange(T, device=q.device)
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    # a row with no visible key softmaxes zeros instead of all -inf, so
    # neither its output nor its gradient sees a NaN; it is then zeroed
    seen = mask.any(-1)[:, None]
    scores = torch.where(seen, scores.masked_fill(~mask, float("-inf")), 0.0)
    probs = torch.where(seen, torch.softmax(scores, dim=-1), 0.0)
    return (probs @ vf).to(q.dtype)


def attention_backward(q, k, v, d_out, **kw
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`attention` for the cotangent ``d_out``, by
    autograd through it, in the inputs' dtypes."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = attention(*leaves, **kw)
        return torch.autograd.grad(out, leaves, d_out)


def paged_decode_attention(
    q: torch.Tensor,              # (B, Hq, hd) one query token per sequence
    k_pages: torch.Tensor,        # (P, page, Hkv, hd)
    v_pages: torch.Tensor,        # (P, page, Hkv, hd)
    block_table: torch.Tensor,    # (B, n_pages) int32
    seq_lens: torch.Tensor,       # (B,) int32, live length (pos + 1)
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Gather-then-attend: logical page j of sequence b is physical page
    ``block_table[b, j]``; positions ``t >= seq_lens[b]`` are masked."""
    B, Hq, hd = q.shape
    _, page, Hkv, _ = k_pages.shape
    n_pages = block_table.shape[1]
    g = Hq // Hkv
    T = n_pages * page
    scale = scale if scale is not None else 1.0 / (hd ** 0.5)

    tbl = block_table.long()
    kf = k_pages[tbl].reshape(B, T, Hkv, hd).float()
    vf = v_pages[tbl].reshape(B, T, Hkv, hd).float()
    qf = q.float().reshape(B, Hkv, g, hd) * scale

    s = torch.einsum("bkgd,btkd->bkgt", qf, kf)
    mask = torch.arange(T, device=q.device)[None, :] < seq_lens[:, None]
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p, vf)
    return out.reshape(B, Hq, hd).to(q.dtype)


def paged_decode_split_combine(
    q: torch.Tensor,              # (B, Hq, hd)
    k_pages: torch.Tensor,        # (P, page, Hkv, hd)
    v_pages: torch.Tensor,        # (P, page, Hkv, hd)
    block_table: torch.Tensor,    # (B, n_pages) int32
    seq_lens: torch.Tensor,       # (B,) int32
    *,
    scale: Optional[float] = None,
    split: int = 128,
) -> torch.Tensor:
    """:func:`paged_decode_attention` in the CUDA kernel's order of work
    (used by tests only): each sequence's keys cut at fixed positions
    ``[s * split, (s + 1) * split)``, each split's max, sum and
    unnormalised output in fp32, then the splits below
    ``ceil(seq_lens[b] / split)`` rescaled to their common max and added
    in split order.  Splits past the length are never read."""
    B, Hq, hd = q.shape
    _, page, Hkv, _ = k_pages.shape
    g = Hq // Hkv
    T = block_table.shape[1] * page
    ns = -(-T // split)
    scale = scale if scale is not None else 1.0 / (hd ** 0.5)

    tbl = block_table.long()
    pad = (0, 0, 0, 0, 0, ns * split - T)
    kf = torch.nn.functional.pad(
        k_pages[tbl].reshape(B, T, Hkv, hd).float(), pad)
    vf = torch.nn.functional.pad(
        v_pages[tbl].reshape(B, T, Hkv, hd).float(), pad)
    qf = q.float().reshape(B, Hkv, g, hd)
    s = torch.einsum("bkgd,btkd->bkgt", qf, kf) * scale
    live = torch.arange(ns * split, device=q.device)[None, :] \
        < seq_lens[:, None]
    s = s.masked_fill(~live[:, None, None, :], float("-inf"))
    s = s.reshape(B, Hkv, g, ns, split)
    m = s.amax(-1)                                        # (B,Hkv,g,ns)
    p = torch.exp(s - torch.where(torch.isinf(m), 0.0, m)[..., None])
    l = p.sum(-1)
    acc = torch.einsum("bkgst,bstkd->bkgsd", p,
                       vf.reshape(B, ns, split, Hkv, hd))
    n_live = -(-seq_lens.long().clamp(min=0, max=T) // split)   # (B,)
    used = torch.arange(ns, device=q.device)[None, :] < n_live[:, None]
    m = torch.where(used[:, None, None, :], m, float("-inf"))
    M = m.amax(-1)                                        # (B,Hkv,g)
    out = torch.zeros((B, Hkv, g, hd), dtype=torch.float32, device=q.device)
    den = torch.zeros((B, Hkv, g), dtype=torch.float32, device=q.device)
    for j in range(ns):                                  # in split order
        f = torch.where(used[:, None, None, j],
                        torch.exp(m[..., j] - M), 0.0)
        den = den + f * l[..., j]
        out = out + f[..., None] * torch.where(
            used[:, None, None, j, None], acc[:, :, :, j], 0.0)
    out = out / torch.where(den > 0, den, 1.0)[..., None]
    return out.reshape(B, Hq, hd).to(q.dtype)


LOG2E = 1.4426950408889634


def paged_decode_partials(
    q: torch.Tensor,              # (B, Hq, hd)
    k_pages: torch.Tensor,        # (P, page, Hkv, hd) this rank's pages
    v_pages: torch.Tensor,        # (P, page, Hkv, hd)
    block_table: torch.Tensor,    # (B, n_pages) int32, < 0: not held here
    seq_lens: torch.Tensor,       # (B,) int32
    *,
    scale: Optional[float] = None,
    split: int = 128,
) -> torch.Tensor:
    """The shard-mode decode on one rank's shard of the sequence: a table
    entry < 0 is a page this rank does not hold, whose keys are masked
    with those at or past ``seq_lens`` (a shard of a dense row passes its
    live length clipped to the shard).  Each sequence's keys are cut at
    fixed positions ``[s * split, (s + 1) * split)`` of the table row, and
    every split gives, per query head, the max ``m`` of its scaled scores
    in log2 units (``scale * log2 e`` times q·k; -inf with no live key),
    ``l = sum 2^(score - m)`` and the unnormalised ``o = sum 2^(score - m)
    v``, all fp32.  Returns them flat, ``o`` (B, Hq, ns, hd), then ``m``
    and ``l`` (B, Hq, ns), ns = ceil(n_pages * page / split): the layout
    the ranks all-gather and :func:`paged_decode_combine` reads.  ``o``
    of a split with ``l = 0`` means nothing: zeros here, left unwritten
    by the kernel (:func:`live_partials` compares the two)."""
    B, Hq, hd = q.shape
    _, page, Hkv, _ = k_pages.shape
    g = Hq // Hkv
    T = block_table.shape[1] * page
    ns = -(-T // split)
    scale = scale if scale is not None else 1.0 / (hd ** 0.5)

    tbl = block_table.long()
    held = (tbl >= 0).repeat_interleave(page, 1)             # (B, T)
    pad = (0, 0, 0, 0, 0, ns * split - T)
    kf = torch.nn.functional.pad(
        k_pages[tbl.clamp(min=0)].reshape(B, T, Hkv, hd).float(), pad)
    vf = torch.nn.functional.pad(
        v_pages[tbl.clamp(min=0)].reshape(B, T, Hkv, hd).float(), pad)
    live = torch.nn.functional.pad(held, (0, ns * split - T)) & (
        torch.arange(ns * split, device=q.device)[None, :]
        < seq_lens[:, None])
    qf = q.float().reshape(B, Hkv, g, hd)
    s = torch.einsum("bkgd,btkd->bkgt", qf, kf) * (scale * LOG2E)
    s = s.masked_fill(~live[:, None, None, :], float("-inf"))
    s = s.reshape(B, Hkv, g, ns, split)
    m = s.amax(-1)                                        # (B,Hkv,g,ns)
    p = torch.exp2(s - torch.where(torch.isinf(m), 0.0, m)[..., None])
    l = p.sum(-1)
    o = torch.einsum("bkgst,bstkd->bkgsd", p,
                     vf.reshape(B, ns, split, Hkv, hd))
    return torch.cat([o.reshape(-1), m.reshape(-1), l.reshape(-1)])


def paged_decode_combine(
    parts: torch.Tensor,          # (n, B * Hq * ns * (hd + 2)) fp32
    B: int, Hq: int, hd: int, splits: int,
    *,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """The ordered combine of ``n`` ranks' :func:`paged_decode_partials`,
    in rank order: every (rank, split) of a query head rescaled to their
    common max and added rank by rank, each rank's splits in split order,
    a split with ``l = 0`` (no live key) contributing nothing; a head with
    no live key anywhere gives zeros.  Returns (B, Hq, hd) in
    ``out_dtype``."""
    n = parts.shape[0]
    per = B * Hq * splits
    o = parts[:, :per * hd].reshape(n, B, Hq, splits, hd)
    m = parts[:, per * hd:per * (hd + 1)].reshape(n, B, Hq, splits)
    l = parts[:, per * (hd + 1):].reshape(n, B, Hq, splits)
    M = m.amax((0, 3))                                    # (B, Hq)
    out = torch.zeros((B, Hq, hd), dtype=torch.float32, device=parts.device)
    den = torch.zeros((B, Hq), dtype=torch.float32, device=parts.device)
    for r in range(n):                                   # in rank order
        for j in range(splits):                          # in split order
            used = l[r, :, :, j] > 0
            f = torch.where(used, torch.exp2(m[r, :, :, j] - M), 0.0)
            den = den + f * l[r, :, :, j]
            out = out + f[..., None] * torch.where(
                used[..., None], o[r, :, :, j], 0.0)
    out = out / torch.where(den > 0, den, 1.0)[..., None]
    return out.to(out_dtype)


def live_partials(parts: torch.Tensor, B: int, Hq: int, hd: int,
                  splits: int) -> torch.Tensor:
    """``parts`` (..., B * Hq * splits * (hd + 2)), partials as
    :func:`paged_decode_partials` lays them out, with ``o`` zeroed on the
    splits with ``l = 0``: the part of them that has a meaning, which
    two runs of the kernel, or the kernel and this plain version, share."""
    per = B * Hq * splits
    o = parts[..., :per * hd].unflatten(-1, (per, hd))
    live = (parts[..., per * (hd + 1):] > 0)[..., None]
    return torch.cat([torch.where(live, o, 0.0).flatten(-2),
                      parts[..., per * hd:]], -1)


def ssd(
    x: torch.Tensor,               # (B, S, H, P)   inputs per head
    dt: torch.Tensor,              # (B, S, H)      softplus-activated steps
    A: torch.Tensor,               # (H,)           negative decay rates
    Bm: torch.Tensor,              # (B, S, G, N)   input matrices
    C: torch.Tensor,               # (B, S, G, N)   output matrices
    *,
    init_state: Optional[torch.Tensor] = None,   # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential SSD recurrence (the definition, S steps)::

        h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t x_t^T
        y_t = C_t^T h_t          (per head; B/C broadcast over groups)

    Returns (y (B, S, H, P) in x's dtype, final state (B, H, P, N) fp32).
    """
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    ys = []
    for t in range(S):
        y, h = ssd_step(x[:, t].float(), dt[:, t], A, Bm[:, t], C[:, t], h)
        ys.append(y)
    y = (torch.stack(ys, 1) if ys
         else torch.zeros((Bsz, 0, H, P), device=x.device))
    return y.to(x.dtype), h


def ssd_step(
    x: torch.Tensor,               # (B, H, P)   one token
    dt: torch.Tensor,              # (B, H)
    A: torch.Tensor,               # (H,)
    Bm: torch.Tensor,              # (B, G, N)
    C: torch.Tensor,               # (B, G, N)
    state: torch.Tensor,           # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step of the SSD recurrence: (y (B, H, P) in x's dtype,
    new state (B, H, P, N) fp32)."""
    rep = x.shape[1] // Bm.shape[1]
    xf, dtf = x.float(), dt.float()
    Bf = Bm.float().repeat_interleave(rep, 1)                  # (B,H,N)
    Cf = C.float().repeat_interleave(rep, 1)
    decay = torch.exp(dtf * A.float()[None])[..., None, None]
    upd = (dtf[..., None] * xf)[..., None] * Bf[:, :, None, :]
    new_state = decay * state.float() + upd
    y = torch.einsum("bhpn,bhn->bhp", new_state, Cf)
    return y.to(x.dtype), new_state


def ssd_backward_chunks(
    x: torch.Tensor,               # (B, S, H, P)
    dt: torch.Tensor,              # (B, S, H)
    A: torch.Tensor,               # (H,)
    Bm: torch.Tensor,              # (B, S, G, N)
    C: torch.Tensor,               # (B, S, G, N)
    dy: torch.Tensor,              # (B, S, H, P)
    d_state: Optional[torch.Tensor] = None,      # (B, H, P, N)
    *,
    init_state: Optional[torch.Tensor] = None,   # (B, H, P, N)
    chunk: int = 64,
):
    """The gradients of the chunked SSD scan in the backward kernel's
    order of work (``csrc/ssd_scan_bwd.cu``; used by tests only), fp32:
    ``(dx, ddt, dA, dB, dC, d_init)``, ``d_init`` None without an
    initial state.  Per chunk of ``chunk`` steps and head, with ``a`` the
    inclusive cumsum of dt A, ``u = dt x``, ``L_ij = exp(a_i - a_j)`` on
    j <= i and ``H_c`` the state entering the chunk:

    1. the states' backward, a reverse recurrence over the chunks from
       ``d_state``: each chunk's ``dH_c`` from y, then the gradient of
       each chunk's own state and of its total decay, and ``d_init``;
    2. the chunks' backward, every chunk at once, from those gradients:
       da's diagonal and state terms, dC and dB (both terms each), du
       (both terms) and da's share of the chunk's own state; then dt A's
       gradient as the reverse cumsum of da, ddt, dx and dA;
    3. dB and dC summed over each group's heads."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    nc = -(-S // chunk)
    pad = nc * chunk - S
    f = lambda t: torch.nn.functional.pad(
        t.float(), (0, 0) * (t.dim() - 2) + (0, pad))
    xf = f(x).reshape(Bsz, nc, chunk, H, P)
    dyf = f(dy).reshape(Bsz, nc, chunk, H, P)
    dtf = f(dt).reshape(Bsz, nc, chunk, H)
    Bf = f(Bm).repeat_interleave(rep, 2).reshape(Bsz, nc, chunk, H, N)
    Cf = f(C).repeat_interleave(rep, 2).reshape(Bsz, nc, chunk, H, N)
    Af = A.float()
    a = torch.cumsum(dtf * Af, dim=2)                       # (B,nc,Q,H)
    aQ = a[:, :, -1]                                        # (B,nc,H)
    ea = torch.exp(a)
    w = torch.exp(aQ[:, :, None] - a)
    u = dtf[..., None] * xf
    # the states entering each chunk, as the forward leaves them
    own = torch.einsum("bcjhn,bcjhp->bchpn", Bf * w[..., None], u)
    h = (torch.zeros((Bsz, H, P, N), device=x.device) if init_state is None
         else init_state.float())
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = torch.exp(aQ[:, c])[..., None, None] * h + own[:, c]
    h_in = torch.stack(h_in, 1)                             # (B,nc,H,P,N)

    # 1. the states' backward, in reverse chunk order
    dH = torch.einsum("bcihp,bcihn->bchpn", dyf * ea[..., None], Cf)
    g = (torch.zeros((Bsz, H, P, N), device=x.device) if d_state is None
         else d_state.float())
    dS, daQ = [None] * nc, [None] * nc
    for c in reversed(range(nc)):
        f_c = torch.exp(aQ[:, c])[..., None, None]
        dS[c] = g
        daQ[c] = (g * f_c * h_in[:, c]).sum((-2, -1))
        g = dH[:, c] + f_c * g
    dS, daQ = torch.stack(dS, 1), torch.stack(daQ, 1)       # daQ (B,nc,H)

    # 2. the chunks' backward
    causal = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                   device=x.device))[None, None, :, :, None]
    diff = a[:, :, :, None, :] - a[:, :, None, :, :]        # (B,nc,i,j,H)
    L = torch.exp(diff.masked_fill(~causal, float("-inf")))
    s_cb = torch.einsum("bcihn,bcjhn->bcijh", Cf, Bf) * L
    du_dy = torch.einsum("bcihp,bcjhp->bcijh", dyf, u)      # dy_i . u_j
    s_du = du_dy * L
    E = torch.einsum("bcihp,bchpn->bcihn", dyf, h_in)
    M = s_cb * du_dy
    da = M.sum(3) - M.sum(2) + ea * (Cf * E).sum(-1)
    dC = ea[..., None] * E + torch.einsum("bcijh,bcjhn->bcihn", s_du, Bf)
    dB = torch.einsum("bcijh,bcihn->bcjhn", s_du, Cf) \
        + w[..., None] * torch.einsum("bcjhp,bchpn->bcjhn", u, dS)
    T = torch.einsum("bcjhn,bchpn->bcjhp", Bf, dS)
    du = w[..., None] * T + torch.einsum("bcijh,bcihp->bcjhp", s_cb, dyf)
    r = w * (u * T).sum(-1)
    da = da - r
    da[:, :, -1] += daQ + r.sum(2)
    ddtA = torch.flip(torch.cumsum(torch.flip(da, [2]), 2), [2])
    ddt = ddtA * Af + (du * xf).sum(-1)
    dx = du * dtf[..., None]
    dA = (ddtA * dtf).sum((0, 1, 2))
    grp = lambda t: t.reshape(Bsz, nc * chunk, G, rep, N).sum(3)[:, :S]
    return (dx.reshape(Bsz, nc * chunk, H, P)[:, :S],
            ddt.reshape(Bsz, nc * chunk, H)[:, :S], dA, grp(dB), grp(dC),
            None if init_state is None else g)
