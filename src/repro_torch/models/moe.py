"""Mixture-of-Experts with replicated-routing expert parallelism, ported
from the reference's ``models/moe.py``.

dMath predates MoE, but expert parallelism is its layout-independence
story: the expert bank is a distributed (E, D, F) tensor row-blocked over
the ``model`` axis, and token dispatch is a redistribution.  Every rank of
the axis routes the whole local token block (the router is replicated, so
routing is the same everywhere and no metadata moves), packs the tokens
whose top-k choices land on its E/tp experts into an (E/tp, C, D)
capacity buffer (sort-free ranking by a one-hot cumsum), runs its three
expert products, gathers each token's k outputs back weighted by their
gates, and one bf16 ``psum`` over ``model`` (a ``psum_scatter`` onto the
sequence-sharded residual where the plan has one) combines the ranks.

Capacity C = max(ceil(T * top_k / E * capacity_factor), 8) comes from the
call's own token count T (per batch shard on a mesh); a token past its
expert's capacity is dropped (its combine weight is 0).  The aux loss is
the switch-style load balance, E * sum_e mean_prob_e * frac_routed_e.

What the port adds to keep the reference's results on the card:

- **Ties.** ``jax.lax.top_k`` takes the lower expert index first among
  equal probabilities; ``torch.topk`` promises no order, so the top k come
  from a stable descending sort.
- **One launch per bank product.** The three expert products are batched
  einsums (``ecd,edf->ecf``, ``ecf,efd->ecd``) on the GEMM kernel's
  batched mode (``kernels/gemm.py``): one launch for all local experts.
- **Deterministic backward.** The dispatch reads each token's k copies
  from an expanded (T, K, D) view, whose backward is a fixed-order sum
  over k, not an ``index_add_``; the capacity buffer is written with
  distinct indices (all dropped copies go to one sentinel row, as zeros)
  and the combine's gather (:class:`_Take`) writes its gradient back with
  distinct indices too.  No atomics: two runs give the same bits, and a
  recompute under ``remat="full"`` routes every token as the forward did
  (the router product is the GEMM's fp32 path, never TF32).
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import distributed as dist_mod
from repro_torch.core import precision
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.params import ParamSpec, plan_layout

# (token, layer) routes of every routed call while recording: one dict a
# call, ``idx`` (T, K) its own top k, ``kept`` (T, K) the experts it
# dispatched to with E where this rank's capacity dropped the copy (or
# another rank holds the expert) and ``margin`` (T,) the gap between the
# K-th and (K+1)-th probability (see :func:`record_routes`)
_ROUTES: Optional[List[Dict[str, torch.Tensor]]] = None
# while forcing: each routed call's experts (T, K), in call order
_FORCED: Optional[List[torch.Tensor]] = None


@contextlib.contextmanager
def record_routes():
    """Within the block every routed call appends its top-k sets, kept
    experts and margins (on the CPU) to the list it yields, in call
    order: one entry per layer per forward."""
    global _ROUTES
    prev, _ROUTES = _ROUTES, []
    try:
        yield _ROUTES
    finally:
        _ROUTES = prev


@contextlib.contextmanager
def force_routes(routes: List[torch.Tensor]):
    """Within the block each routed call dispatches to the experts of the
    next entry of ``routes`` ((T, K) expert indices, in call order, as
    :func:`record_routes` gives them of another run) in place of its own
    top k, with gates its own probabilities there: two runs of the same
    layers whose roundings part (the card and the CPU) stay on one
    routing, so their outputs differ by roundings alone, and where a
    run's own top k differs from the forced one (what
    :func:`record_routes` records) its margin says how near the tie
    was."""
    global _FORCED
    prev, _FORCED = _FORCED, list(routes)
    try:
        yield
    finally:
        _FORCED = prev


def moe_specs(cfg, plan=None, mesh=None) -> Dict[str, ParamSpec]:
    """The layer's leaves (the reference's ``moe_specs``); the router is
    fp32.  Given a plan and a mesh, with the plan's layouts: the banks
    row-blocked over ``model``, the router replicated, the shared experts
    as the dense MLP's column and row blocks."""
    D, E, Fe = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    out_scale = 0.02 / max(1, 2 * cfg.n_layers) ** 0.5
    lay = functools.partial(plan_layout, plan, mesh)
    s = {
        "router": ParamSpec((D, E), dtype=torch.float32,
                            layout=lay("router", (D, E))),
        "w_gate": ParamSpec((E, D, Fe), layout=lay("experts", (E, D, Fe))),
        "w_in": ParamSpec((E, D, Fe), layout=lay("experts", (E, D, Fe))),
        "w_out": ParamSpec((E, Fe, D), init="scaled", scale=out_scale,
                           layout=lay("experts", (E, Fe, D))),
    }
    if cfg.n_shared_experts:
        Fs = cfg.d_shared_ff
        s["shared_gate"] = ParamSpec((D, Fs), layout=lay("ffn_in", (D, Fs)))
        s["shared_in"] = ParamSpec((D, Fs), layout=lay("ffn_in", (D, Fs)))
        s["shared_out"] = ParamSpec((Fs, D), init="scaled", scale=out_scale,
                                    layout=lay("ffn_out", (Fs, D)))
    return s


def capacity(cfg, tokens: int) -> int:
    """Slots per expert for a call routing ``tokens`` tokens (at least 8)."""
    return max(int(math.ceil(tokens * cfg.top_k / cfg.n_experts
                             * cfg.capacity_factor)), 8)


def route(t: torch.Tensor, router: torch.Tensor, k: int):
    """(probs (T, E) fp32, gate values (T, k), expert indices (T, k), the
    margin (T,) between the k-th and (k+1)-th probability) of tokens
    ``t`` (T, D): the fp32 router product, softmax and the top k in
    descending order, the lower index first among ties."""
    logits = ops.matmul(t.float().contiguous(), router.float().contiguous(),
                        out_dtype=torch.float32)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    margin = (vals[:, k - 1] - vals[:, k] if k < probs.shape[-1]
              else vals[:, k - 1])
    return probs, vals[:, :k], idx[:, :k], margin


class _Take(torch.autograd.Function):
    """Rows ``src[idx]`` where index ``n = len(src)`` reads a zero row, for
    indices that are distinct except for that sentinel: the backward
    writes each row's gradient back without accumulating (no atomics;
    what lands on the sentinel row is dropped)."""

    @staticmethod
    def forward(ctx, src, idx):
        ctx.save_for_backward(idx)
        ctx.n = src.shape[0]
        return F.pad(src, (0, 0, 0, 1))[idx]

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        out = g.new_zeros((ctx.n + 1,) + tuple(g.shape[1:]))
        out[idx] = g
        return out[:ctx.n], None


def _local(t: torch.Tensor, p: dict, cfg, cap: int, e0: int,
           policy) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``shard_map`` body on tokens ``t`` (T, D) and this
    rank's experts ``e0 .. e0 + E_loc - 1``: (y (T, D) fp32, this
    token block's aux loss)."""
    T, D = t.shape
    E, K = cfg.n_experts, cfg.top_k
    e_loc = p["w_gate"].shape[0]

    # -- routing (identical on every model rank) --------------------------
    probs, gate_vals, gate_idx, margin = route(t, p["router"], K)
    own = gate_idx
    if _FORCED is not None:
        gate_idx = _FORCED.pop(0).to(t.device)
        gate_vals = probs.gather(1, gate_idx)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    experts = torch.arange(E, device=t.device)
    frac = precision.div_count(
        (gate_idx[..., None] == experts).float().sum(1).sum(0), T)
    aux = E * torch.sum(precision.div_count(probs.sum(0), T) * frac)

    # -- capacity ranking (sort-free, deterministic) ----------------------
    flat_e = gate_idx.reshape(-1)                            # (T*K,)
    flat_w = gate_vals.reshape(-1)
    onehot = (flat_e[:, None] == experts).to(torch.int32)    # (T*K, E)
    pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) - 1
    rank = pos.gather(1, flat_e[:, None])[:, 0]
    local_e = flat_e - e0
    keep = (local_e >= 0) & (local_e < e_loc) & (rank < cap)
    dst = torch.where(keep, local_e * cap + rank,
                      torch.full_like(local_e, e_loc * cap))   # sentinel
    if _ROUTES is not None:
        _ROUTES.append({"idx": own.detach().cpu(),
                        "kept": torch.where(keep, flat_e, E).reshape(T, K)
                        .detach().cpu(),
                        "margin": margin.detach().cpu()})

    # each token's K copies from a (T, K, D) view: the backward sums over k
    src = t[:, None, :].expand(T, K, D).reshape(T * K, D)
    src = torch.where(keep[:, None], src, torch.zeros((), dtype=t.dtype,
                                                      device=t.device))
    buf = torch.index_put(t.new_zeros((e_loc * cap + 1, D)), (dst,), src)
    eb = buf[:-1].reshape(e_loc, cap, D)

    # -- expert FFN: one batched launch per bank --------------------------
    g = precision.einsum("ecd,edf->ecf", eb, p["w_gate"], policy=policy)
    h = precision.einsum("ecd,edf->ecf", eb, p["w_in"], policy=policy)
    h = layers.act_fn(cfg.act)(g) * h
    yb = precision.einsum("ecf,efd->ecd", h.to(eb.dtype), p["w_out"],
                          policy=policy)                     # (E_loc, C, D)

    # -- combine: gather each (token, k) slot, sum over k in fp32 ---------
    picked = _Take.apply(yb.reshape(e_loc * cap, D), dst)
    w_eff = (flat_w * keep).float()
    y = torch.sum(picked.reshape(T, K, D).float()
                  * w_eff.reshape(T, K, 1), dim=1)
    return y, aux


def forward(x: torch.Tensor, p: dict, cfg, *,
            policy=precision.MIXED) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer on one device (the reference's ``forward`` on a (1, 1)
    mesh): ``x`` (B, S, D) -> (y in ``x``'s dtype, the aux loss, fp32)."""
    B, S, D = x.shape
    y, aux = _local(x.reshape(B * S, D), p, cfg, capacity(cfg, B * S), 0,
                    policy)
    y = y.to(x.dtype).reshape(B, S, D)
    if cfg.n_shared_experts:
        y = y + _shared(x, p["shared_gate"], p["shared_in"],
                        p["shared_out"], act=cfg.act,
                        policy=policy).to(x.dtype)
    return y, aux


class _AuxMean(torch.autograd.Function):
    """The aux loss's mean over the batch shards (the reference's
    ``pmean``).  Every rank of the model axis computes the same value
    from the same routes, and each differentiates it: the backward hands
    each rank 1/(shards * tp) of the cotangent, so the router's gradient
    summed over the batch and model axes is the mean's, as the
    reference's transpose of a replicated output divides it."""

    @staticmethod
    def forward(ctx, aux, mesh, rows, tp):
        nb = math.prod(mesh.shape[a] for a in rows)
        ctx.n = nb * mesh.shape[tp]
        if rows:
            aux = dist_mod.psum(aux, mesh, rows)
        return precision.div_count(aux, nb)

    @staticmethod
    def backward(ctx, g):
        return precision.div_count(g, ctx.n), None, None, None


def forward_mesh(x: torch.Tensor, p: dict, cfg, plan, mesh, *,
                 rows: Tuple[str, ...] = (),
                 policy=precision.MIXED) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer on this rank's block ``x`` of the residual (the plan's
    hidden layout: (B/nb, S/tp, D) under ``seq_parallel_residual``, else
    (B/nb, S, D)) and its blocks ``p`` at their use layouts (its E/tp
    experts of each bank, the whole router, the shared experts' column
    and row blocks, or whole under ``ffn_replicated``); ``rows`` are the
    axes the batch splits over.  Returns (y in ``x``'s layout and dtype,
    the aux loss averaged over the batch shards).

    The sequence is gathered (bf16) under ``seq_parallel_residual``, and
    the combine reduce-scattered back onto it; else the combine is a bf16
    ``psum``.  Capacity comes from this rank's whole token block.  Where a
    value the line shares enters work split over it, the split's entry
    sums the ranks' shares in the backward (``all_gather_ad``,
    ``copy_ad``), as in the dense MLP."""
    tp = plan.tp_axis
    tp_n = mesh.shape[tp]
    sp = plan.seq_parallel_residual
    xg = (dist_mod.all_gather_ad(x, mesh, tp, 1) if sp
          else dist_mod.copy_ad(x, mesh, tp))
    B, S, D = xg.shape
    e_loc = cfg.n_experts // tp_n
    y, aux = _local(xg.reshape(B * S, D), p, cfg, capacity(cfg, B * S),
                    mesh.coords[tp] * e_loc, policy)
    y = y.to(x.dtype).reshape(B, S, D)
    y = (dist_mod.psum_scatter_ad(y, mesh, tp, 1) if sp
         else dist_mod.psum_ad(y, mesh, tp))
    aux = _AuxMean.apply(aux, mesh, tuple(rows), tp)
    if cfg.n_shared_experts:
        w = (p["shared_gate"], p["shared_in"], p["shared_out"])
        if plan.ffn_replicated:
            f = _shared(x, *w, act=cfg.act, policy=policy).to(x.dtype)
        elif sp:
            f = dist_mod.psum_scatter_ad(
                _shared(xg, *w, act=cfg.act, policy=policy), mesh, tp,
                1).to(x.dtype)
        else:
            f = layers.glu_mlp(x, *w, act=cfg.act, policy=policy,
                               mesh=mesh, tp_axis=tp)
        y = y + f
    return y, aux


def _shared(x, w_gate, w_in, w_out, *, act, policy):
    """The shared experts' gated MLP, rounded as the reference's
    ``glu_mlp`` under the ``h_layout`` its moe layer always passes: g and
    h pinned in the activation dtype, ``act(g)`` and ``h`` each rounded to
    ``x``'s dtype and multiplied there.  Returns the fp32 out product (on
    a mesh, this rank's column and row blocks' share)."""
    g = precision.einsum("bsd,df->bsf", x, w_gate, policy=policy)
    h = precision.einsum("bsd,df->bsf", x, w_in, policy=policy)
    g, h = g.to(policy.activation_dtype), h.to(policy.activation_dtype)
    h = layers.act_fn(act)(g.float()).to(x.dtype) * h.to(x.dtype)
    return precision.einsum("bsf,fd->bsd", h, w_out, policy=policy)
