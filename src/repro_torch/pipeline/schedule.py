"""GPipe and 1F1B microbatch schedules over ``torch.distributed``, ported
from the reference's ``pipeline/schedule.py``.

Layer-partitioned model parallelism (Hewett & Grady 2019; dMath's third
hybrid axis): the layer stack is split into S contiguous stages over the
``pipe`` mesh axis, a rank runs its stage, and activations cross each
stage boundary point to point.  The reference moves them with
``jax.lax.ppermute`` inside a ``shard_map``; here each rank runs its own
stage and moves them with :func:`repro_torch.core.distributed.exchange`
along its ``pipe`` line (on gloo through host memory: gloo cannot send
device memory).  Only valid microbatches cross the wire, where the
reference's ppermute also moves zeros on bubble ticks, so the
``send_recv`` bytes a pipe line receives in a step are exactly
``costs.boundary_wire_bytes``.

Two schedules, the same math per microbatch:

- **gpipe**: the M forwards tick by tick (microbatch ``t - s`` on stage s
  at tick t), each stage's autograd graph kept (under ``remat="full"``
  only each layer's input), then the M backwards in reverse microbatch
  order, as the reference's scan transpose replays its ticks; each
  stage input's bf16 cotangent goes up.
- **1f1b**: the reference's tick table: at tick t a stage runs a forward
  slot for microbatch ``t - s`` (without autograd) and a backward slot
  for microbatch ``t - 2(S-1) + s``, which recomputes the stage body
  under autograd from its stashed input; only stage inputs are stashed,
  in a ring of ``spec.resolved_stash_slots()`` = min(M, 2S-1) slots.

Both ends of a boundary derive their sends and receives from the same
tick table, so every exchange is matched.  A received activation is a
leaf that takes a gradient: its ``.grad`` is the cotangent sent up.
Gradients accumulate in fp32 (GPipe in reverse microbatch order, 1F1B in
forward order).  The first stage alone embeds; the last alone runs
``final_norm -> unembed -> lm_loss`` (interior stages never allocate the
fp32 ``(b_mb, T, V)`` logits).  Each stage runs its layers with their
global indices (a windowed config's windows are the global layer's).
The dense, moe, audio and ssm families run; the hybrid and vlm families
are refused, as the reference's ``_stage_apply`` refuses them.  A moe
stage carries its layers' aux loss as the reference's ``_stage_apply``
does: its backward seeds each microbatch's aux with
``router_aux_coef / (M * n_layers)`` (the reference's 1F1B cotangent
scale), and the metrics' aux is its sum over the stages and the mean over
the microbatches.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import distributed as dist_mod
from repro_torch.core import precision
from repro_torch.models import layers
from repro_torch.pipeline.spec import PipelineSpec

Tensors = Dict[str, torch.Tensor]

# --------------------------------------------------------------------------
# one stage's work: [embed ->] local layer slice [-> head + loss]
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Geometry:
    """This rank's stage: its index, the stage count, its first layer's
    global index and its layer count."""

    s: int
    n_stages: int
    i0: int
    n_local: int

    @property
    def is_first(self) -> bool:
        return self.s == 0

    @property
    def is_last(self) -> bool:
        return self.s == self.n_stages - 1


def _stage_geometry(model, spec: PipelineSpec, mesh) -> _Geometry:
    cfg = model.cfg
    if cfg.family not in ("dense", "moe", "audio", "ssm"):
        # the reference's _stage_apply refuses them too: the hybrid's
        # shared block cannot sit in one stage, and its stage body has no
        # vision prefix
        raise NotImplementedError(
            f"pipeline schedules do not support family {cfg.family!r} (nor "
            "does the reference's pipeline)")
    n_local = cfg.n_layers // spec.n_stages
    s = mesh.coords[spec.axis]
    return _Geometry(s, spec.n_stages, s * n_local, n_local)


def _stage_apply(model, params: Tensors, x: torch.Tensor,
                 geo: _Geometry):
    """This stage's layers, layer i0 + j taking its global index; each
    checkpointed while autograd records unless ``remat="none"`` (the
    reference checkpoints its scanned stage body).  Returns ``(x, the
    stage's moe aux loss or None)``."""
    remat = model.remat != "none" and torch.is_grad_enabled()
    lps = model._unbind_layers(params)
    if len(lps) != geo.n_local:
        raise ValueError(f"stage {geo.s} holds {len(lps)} layers; its "
                         f"stage has {geo.n_local}")
    if model.cfg.family != "ssm":
        return model._dense_layers(x, lps, geo.i0, remat)
    for lp in lps:
        x = (checkpoint(model._ssm_layer, x, lp, use_reentrant=False)
             if remat else model._ssm_layer(x, lp))
    return x, None


def _stage_fn(model, params: Tensors, x_in: Optional[torch.Tensor],
              mb: Tensors, geo: _Geometry):
    """(the stage's output activation, its moe aux loss or None, lm loss,
    token count); the last two are None off the last stage."""
    x = (model._embed(params, mb["tokens"], ()) if geo.is_first else x_in)
    x, aux = _stage_apply(model, params, x, geo)
    if not geo.is_last:
        return x, aux, None, None
    lm, denom = layers.lm_loss(model._head(params, x), mb["labels"],
                               vocab_real=model.cfg.vocab_size)
    return x, aux, lm, denom


def _split_local_microbatches(batch: Tensors, m: int) -> List[Tensors]:
    rows = next(iter(batch.values())).shape[0]
    if rows % m:
        raise ValueError(f"local batch {rows} not divisible by "
                         f"num_microbatches={m}")
    return [dict(zip(batch, parts))
            for parts in zip(*(v.split(rows // m) for v in batch.values()))]


def _total_loss(cfg, lm_mean, aux_mean):
    loss = lm_mean
    if cfg.family == "moe":
        loss = loss + cfg.router_aux_coef * aux_mean / cfg.n_layers
    return loss


class _Stage:
    """The per-step state of this rank's stage: its microbatches, the
    parameter leaves it differentiates, the fp32 gradient accumulators,
    the loss sums and the boundary buffers' shape."""

    def __init__(self, model, spec: PipelineSpec, params: Tensors,
                 batch: Tensors, mesh):
        self.model, self.spec, self.mesh = model, spec, mesh
        self.geo = _stage_geometry(model, spec, mesh)
        self.M = spec.num_microbatches
        self.mbs = _split_local_microbatches(batch, self.M)
        self.names = list(params)
        self.leaves = [params[n] for n in self.names]
        self.params = params
        tokens = batch["tokens"]
        self.act_shape = (tokens.shape[0] // self.M, tokens.shape[1],
                          model.cfg.d_model)
        self.device = self.leaves[0].device
        self.grads: Dict[str, torch.Tensor] = {}
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        self.lm_acc, self.den_acc = zero, zero.clone()
        self.aux_acc = zero.clone()
        # the reference's cotangent of each microbatch's lm: d(lm_acc/M),
        # and of its aux: router_aux_coef / (M * n_layers)
        self.inv_m = torch.tensor(1.0 / self.M, dtype=torch.float32,
                                  device=self.device)
        cfg = model.cfg
        self.aux_cot = (torch.tensor(
            cfg.router_aux_coef / (self.M * cfg.n_layers),
            dtype=torch.float32, device=self.device)
            if cfg.family == "moe" else None)

    def run(self, x_in, m: int):
        return _stage_fn(self.model, self.params, x_in, self.mbs[m],
                         self.geo)

    def count(self, aux, lm, den) -> None:
        if aux is not None:
            self.aux_acc = self.aux_acc + aux.detach().float()
        if lm is not None:
            self.lm_acc = self.lm_acc + lm.detach().float()
            self.den_acc = self.den_acc + den.detach().float()

    def backward(self, x_in, out, aux, lm, cot) -> Optional[torch.Tensor]:
        """Accumulate the stage's parameter gradients of one microbatch;
        return the cotangent of its input (None on the first stage)."""
        inputs = self.leaves + ([x_in] if x_in is not None else [])
        outs, cots = ([lm], [self.inv_m]) if self.geo.is_last \
            else ([out], [cot])
        if aux is not None:
            outs.append(aux)
            cots.append(self.aux_cot)
        grads = torch.autograd.grad(outs, inputs, cots, allow_unused=True)
        for name, g in zip(self.names, grads):
            if g is None:
                continue
            if name in self.grads:
                self.grads[name] += g.float()
            else:
                self.grads[name] = g.float()
        return grads[-1] if x_in is not None else None

    def exchange(self, sends: Dict[int, torch.Tensor],
                 recv_from: Tuple[int, ...]) -> Dict[int, torch.Tensor]:
        """Send ``sends`` (line index -> tensor) and receive one bf16
        activation-shaped block from each index of ``recv_from``, all at
        once."""
        recvs = {j: torch.empty(self.act_shape, dtype=torch.bfloat16,
                                device=self.device) for j in recv_from}
        dist_mod.exchange({i: t.detach() for i, t in sends.items()}, recvs,
                          self.mesh, self.spec.axis)
        return recvs

    def finish(self, combine: bool = True) -> Tuple[Tensors, Tensors]:
        """The combined gradients (with ``combine``) and the metrics: the
        lm and token sums over ``pipe`` (only the last stage's are
        nonzero), each a mean over the M microbatches."""
        cfg = self.model.cfg
        grads = (_combine_edge_grads(self.grads, self.params, self.spec,
                                     self.mesh) if combine else {})
        sums = dist_mod.psum(torch.stack([self.lm_acc, self.aux_acc,
                                          self.den_acc]),
                             self.mesh, self.spec.axis)
        lm_mean, aux_mean, den_mean = precision.div_count(
            sums, self.M).unbind()
        return grads, {"loss": _total_loss(cfg, lm_mean, aux_mean),
                       "aux": aux_mean, "tokens": den_mean}


def _leaf(x: torch.Tensor) -> torch.Tensor:
    return x.detach().requires_grad_(True)


# --------------------------------------------------------------------------
# GPipe: all forwards, then the backwards in reverse microbatch order
# --------------------------------------------------------------------------

def _gpipe_forward(st: "_Stage") -> List[Optional[tuple]]:
    """The forward ticks: microbatch t - s on stage s at tick t, its
    output sent down at the end of the tick; returns each microbatch's
    (input leaf, output, lm loss), with their graphs when autograd
    records."""
    geo, M = st.geo, st.M
    s, S = geo.s, geo.n_stages
    live: List[Optional[tuple]] = [None] * M
    act = None
    for t in range(M + S - 1):
        m, sends = t - s, {}
        if 0 <= m < M:
            x_in = None if geo.is_first else _leaf(act)
            out, aux, lm, den = st.run(x_in, m)
            live[m] = (x_in, out, aux, lm)
            st.count(aux, lm, den)
            if not geo.is_last:
                sends[s + 1] = out
        nxt = t + 1 - s
        recvs = st.exchange(sends, (s - 1,) if s > 0 and 0 <= nxt < M
                            else ())
        act = recvs.get(s - 1)
    return live


def gpipe_loss(model, spec: PipelineSpec, params: Tensors, batch: Tensors,
               mesh) -> Tuple[torch.Tensor, Tensors]:
    """The pipelined loss of this rank's rows without gradients: (this
    stage's share of the loss, lm_acc / M, nonzero on the last stage
    only; the metrics, summed over ``pipe``)."""
    st = _Stage(model, spec, params, batch, mesh)
    with torch.no_grad():
        _gpipe_forward(st)
    local = precision.div_count(st.lm_acc, st.M)
    _, metrics = st.finish(combine=False)
    return local, metrics


def gpipe_grads(model, spec: PipelineSpec, params: Tensors, batch: Tensors,
                mesh) -> Tuple[Tensors, Tensors]:
    """(grads, metrics) of this rank's stage under GPipe: its stage-local
    layer gradients and the edge gradients combined over ``pipe``, in
    fp32; ``batch`` is this rank's rows.  Tick t of the forward runs
    microbatch t - s; tick t of the backward, taken in reverse, the same
    microbatch, so a stage's cotangent for microbatch m arrives from the
    stage below one backward tick before it is used."""
    st = _Stage(model, spec, params, batch, mesh)
    geo, M = st.geo, st.M
    s, S = geo.s, geo.n_stages
    with torch.enable_grad():
        live = _gpipe_forward(st)
    cot = None
    for t in reversed(range(M + S - 1)):
        m, sends = t - s, {}
        if 0 <= m < M:
            x_in, out, aux, lm = live[m]
            live[m] = None
            dx = st.backward(x_in, out, aux, lm, cot)
            if dx is not None:
                sends[s - 1] = dx
        nxt = t - 1 - s
        recvs = st.exchange(sends, (s + 1,) if s < S - 1 and 0 <= nxt < M
                            else ())
        cot = recvs.get(s + 1)
    return st.finish()


# --------------------------------------------------------------------------
# 1F1B: the forward/backward interleave with a stage-input stash
# --------------------------------------------------------------------------

def one_f_one_b_grads(model, spec: PipelineSpec, params: Tensors,
                      batch: Tensors, mesh) -> Tuple[Tensors, Tensors]:
    """(grads, metrics) of this rank's stage under 1F1B.

    Tick t runs (on stage s) a forward slot for microbatch ``t - s`` and a
    backward slot for microbatch ``t - 2(S-1) + s``: the last stage backs
    each microbatch the tick its forward completes, interior stages
    alternate one forward and one backward in the steady state.  Stage
    inputs are stashed and the stage body recomputed under autograd at the
    backward slot, so a stage keeps O(in-flight) inputs rather than M
    graphs.  The stash is a ring of ``spec.resolved_stash_slots()`` slots
    indexed by microbatch mod ring: microbatch m's input is written at
    its forward tick m + s and last read at its backward tick
    m + 2(S-1) - s, so a 2S-1 ring never overwrites a live slot.  At the
    end of each tick one exchange sends the forward's output down and the
    backward's input cotangent up, and receives the next tick's."""
    st = _Stage(model, spec, params, batch, mesh)
    geo, M = st.geo, st.M
    s, S = geo.s, geo.n_stages
    n_slots = spec.resolved_stash_slots()
    stash: List[Optional[torch.Tensor]] = [None] * n_slots
    act = cot = None
    for t in range(M + 2 * (S - 1)):
        sends = {}
        mf = t - s                                   # forward slot
        if 0 <= mf < M:
            with torch.no_grad():
                out, aux, lm, den = st.run(act, mf)
            st.count(aux, lm, den)
            if not geo.is_last:
                sends[s + 1] = out
            if not geo.is_first:
                stash[mf % n_slots] = act
        mb = t - 2 * (S - 1) + s                     # backward slot
        if 0 <= mb < M:
            x_in = None if geo.is_first else _leaf(stash[mb % n_slots])
            with torch.enable_grad():
                out, aux, lm, _ = st.run(x_in, mb)
                dx = st.backward(x_in, out, aux, lm, cot)
            if dx is not None:
                sends[s - 1] = dx
        recv_from = []
        if s > 0 and 0 <= t + 1 - s < M:
            recv_from.append(s - 1)
        if s < S - 1 and 0 <= t + 1 - 2 * (S - 1) + s < M:
            recv_from.append(s + 1)
        recvs = st.exchange(sends, tuple(recv_from))
        act, cot = recvs.get(s - 1), recvs.get(s + 1)
    return st.finish()


def _edge_stage(name: str, n_stages: int) -> int:
    """The stage that uses an edge leaf: the first embeds, the last runs
    the final norm and the unembed."""
    return 0 if name == "embed" else n_stages - 1


def _combine_edge_grads(grads: Tensors, params: Tensors, spec: PipelineSpec,
                        mesh) -> Tensors:
    """Every leaf's fp32 gradient on this rank: the stage-local layer
    gradients as they are, each edge leaf's gradient summed over the
    ``pipe`` line, as the reference's psum.  Only the stage that uses an
    edge leaf holds a nonzero gradient of it, so the sum is that stage's
    gradient, bit for bit: it is broadcast from that stage."""
    out = {}
    for name, p in params.items():
        g = grads.get(name)
        if name.startswith("layers."):
            out[name] = (g if g is not None else
                         torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device))
            continue
        src = _edge_stage(name, spec.n_stages)
        if g is None:
            g = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        out[name] = dist_mod.broadcast(g, mesh, spec.axis, src)
    return out


SCHEDULE_FNS = {"gpipe": gpipe_grads, "1f1b": one_f_one_b_grads}
