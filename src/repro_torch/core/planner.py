"""Per-architecture layout planner — hybrid parallelism (paper §4), ported
from the reference's ``core/planner.py``: its layout part.

dMath trains with *hybrid* data/model parallelism (DP where activations
dominate, MP where parameters dominate).  On a named ``(data, model)``
mesh (``pod`` before ``data`` where there is one):

  batch        -> ("pod", "data")                     (pure DP axes)
  FFN / vocab  -> "model"                             (tensor parallel)
  attention    -> "model" on heads if both head counts divide the axis,
                  else sequence-parallel over "model" (SP)
  storage      -> parameter sharding over "data" (FSDP) for a stack whose
                  use-time bytes pass ``fsdp_tensor_bytes``

:class:`ParallelPlan` is the reference's whole (every parameter and
activation layout method); :func:`plan_for` and
:func:`approx_param_count` are the reference's.  ``plan.comms`` is the
cost model's gradient-sync :class:`~repro_torch.comms.plan.CommsPlan`
(:func:`comms_plan_for`, scored over the batch axes by
:func:`grad_sync_topology`); ``plan.pipeline`` is the
:class:`~repro_torch.pipeline.PipelineSpec` of a mesh with a ``pipe``
axis (:func:`pipeline_spec_for`), else None.  The hybrid sweep
(:func:`score_hybrid_candidates`, :func:`best_hybrid`) scores every (dp,
tp, pp) factorization with the alpha-beta links, ``pipeline/costs.py``
and the memory model, refusing what does not fit.  Links, the FLOPs rate
and the step overhead are the reference's nominals unless a calibration
table is active.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

from .layout import Layout

GiB = 1024**3


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    """All layout decisions for one (config, mesh) cell."""

    batch_axes: Tuple[str, ...]         # ("data",) or ("pod", "data")
    tp_axis: str                        # tensor/expert/sequence axis
    attn_mode: str                      # "head_tp" | "sp" | "none"
    fsdp: bool                          # shard weight storage over data axis
    seq_parallel_residual: bool         # shard residual stream on seq dim
    ffn_replicated: bool = False        # SP small-FFN: fully local MLP
    fsdp_axis: str = "data"
    n_layers: int = 1                   # for per-tensor FSDP sizing
    fsdp_tensor_bytes: float = 4 * GiB  # FSDP only stacks bigger than this
    comms: Optional[object] = None      # repro_torch.comms.CommsPlan
    pipeline: Optional[object] = None   # repro_torch.pipeline.PipelineSpec

    # ---- parameter layouts --------------------------------------------------
    def _maybe_fsdp(self, layout: Layout, shape, mesh, dim: int) -> Layout:
        """Shard ``dim`` over the FSDP axis, but only for a tensor whose
        whole-stack use-time footprint (bf16 bytes x ``n_layers`` over its
        TP shards) reaches ``fsdp_tensor_bytes``."""
        if not self.fsdp or layout.dims[dim] is not None:
            return layout
        if self.fsdp_axis in layout.mesh_axes_used():
            return layout
        tp_shards = 1
        for ax in layout.mesh_axes_used():
            tp_shards *= mesh.shape.get(ax, 1)
        use_bytes = 2.0 * math.prod(shape) * self.n_layers / tp_shards
        if use_bytes < self.fsdp_tensor_bytes:
            return layout
        n = mesh.shape.get(self.fsdp_axis, 1)
        if shape[dim] % n == 0:
            return layout.with_dim(dim, self.fsdp_axis)
        return layout

    def embed(self, shape, mesh) -> Layout:
        # (V, D): shard D so the token gather is comm-free; FSDP on V
        return self._maybe_fsdp(Layout((None, self.tp_axis)), shape, mesh, 0)

    def unembed(self, shape, mesh) -> Layout:
        # (D, V): vocab-TP (the paper's model-parallel FC classifier)
        return self._maybe_fsdp(Layout((None, self.tp_axis)), shape, mesh, 0)

    def attn_qkv(self, shape, mesh) -> Layout:
        # (D, H, hd) col-parallel on heads, or replicated under SP
        if self.attn_mode == "head_tp":
            return self._maybe_fsdp(
                Layout((None, self.tp_axis, None)), shape, mesh, 0)
        return self._maybe_fsdp(Layout((None, None, None)), shape, mesh, 0)

    def attn_out(self, shape, mesh) -> Layout:
        # (H, hd, D) row-parallel on heads
        if self.attn_mode == "head_tp":
            return self._maybe_fsdp(
                Layout((self.tp_axis, None, None)), shape, mesh, 2)
        return self._maybe_fsdp(Layout((None, None, None)), shape, mesh, 2)

    def ffn_in(self, shape, mesh) -> Layout:      # (D, F) col-parallel
        if self.ffn_replicated:
            return self._maybe_fsdp(Layout((None, None)), shape, mesh, 0)
        return self._maybe_fsdp(Layout((None, self.tp_axis)), shape, mesh, 0)

    def ffn_out(self, shape, mesh) -> Layout:     # (F, D) row-parallel
        if self.ffn_replicated:
            return self._maybe_fsdp(Layout((None, None)), shape, mesh, 1)
        return self._maybe_fsdp(Layout((self.tp_axis, None)), shape, mesh, 1)

    def experts(self, shape, mesh) -> Layout:     # (E, D, F) expert-parallel
        return self._maybe_fsdp(
            Layout((self.tp_axis, None, None)), shape, mesh, 1)

    def router(self, shape, mesh) -> Layout:      # (D, E) replicated
        return Layout((None, None))

    def vector(self, shape, mesh) -> Layout:      # norms, biases: replicated
        return Layout.replicated(len(shape))

    def head_vector(self, shape, mesh) -> Layout:
        # per-head scalars (SSD A, dt_bias, D-skip): (H,) over model
        n = mesh.shape.get(self.tp_axis, 1)
        if shape[0] % n == 0:
            return Layout((self.tp_axis,))
        return Layout((None,))

    def conv1d(self, shape, mesh) -> Layout:      # (width, channels)
        n = mesh.shape.get(self.tp_axis, 1)
        if shape[-1] % n == 0:
            return Layout((None,) * (len(shape) - 1) + (self.tp_axis,))
        return Layout.replicated(len(shape))

    # ---- activation layouts -------------------------------------------------
    def hidden(self, seq_sharded: Optional[bool] = None) -> Layout:
        # (B, S, D) residual stream
        seq = self.seq_parallel_residual if seq_sharded is None else seq_sharded
        return Layout((self.batch_axes, self.tp_axis if seq else None, None))

    def heads_act(self) -> Layout:
        # (B, S, H, hd) attention activations under head-TP
        return Layout((self.batch_axes, None, self.tp_axis, None))

    def seq_act(self) -> Layout:
        # (B, S, ...) under SP: sequence over model axis
        return Layout((self.batch_axes, self.tp_axis, None, None))

    def logits(self) -> Layout:
        return Layout((self.batch_axes, None, self.tp_axis))

    def tokens(self) -> Layout:
        return Layout((self.batch_axes, None))

    def kv_cache(self, batch: int, mesh) -> Layout:
        """(L|sites, B, S, Hkv, hd): flash-decoding layout, seq over model;
        a batch the data axes cannot split gives them to the sequence."""
        nb = math.prod(mesh.shape[a] for a in self.batch_axes)
        if batch % nb == 0 and batch >= nb:
            return Layout((None, self.batch_axes, self.tp_axis, None, None))
        seq_axes = tuple(self.batch_axes) + (self.tp_axis,)
        return Layout((None, None, seq_axes, None, None))

    def ssm_state(self, batch: int, mesh) -> Layout:
        """(L, B, H, hd, N) decode state: heads over model."""
        nb = math.prod(mesh.shape[a] for a in self.batch_axes)
        b_ax = self.batch_axes if batch % nb == 0 and batch >= nb else None
        return Layout((None, b_ax, self.tp_axis, None, None))


def approx_param_count(cfg) -> int:
    """Rough parameter count from the config (the reference's; it feeds
    the comms cost model, which needs it within ~2x)."""
    D = getattr(cfg, "d_model", 0) or 0
    V = getattr(cfg, "vocab_size", 0) or 0
    L = max(1, getattr(cfg, "n_layers", 1) or 1)
    H = getattr(cfg, "n_heads", 0) or 0
    Hkv = getattr(cfg, "n_kv_heads", 0) or H
    hd = getattr(cfg, "head_dim", 0) or 0
    F = getattr(cfg, "d_ff", 0) or 0
    E = getattr(cfg, "n_experts", 0) or 1
    attn = D * (H + 2 * Hkv) * hd + H * hd * D
    ffn = 3 * D * F * E
    return 2 * V * D + L * (attn + ffn)


def grad_sync_topology(mesh):
    """The two-level topology of the gradient-sync group (the batch axes):
    ``data`` is the fast level (chips inside a pod), ``pod`` the slow
    one, so a multi-pod mesh gets a hierarchical schedule."""
    from repro_torch.comms import topology as topo_mod

    batch_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    intra, inter = topo_mod.default_links()
    return topo_mod.Topology(
        intra_axes=tuple(a for a in batch_axes if a == "data"),
        inter_axes=tuple(a for a in batch_axes if a != "data"),
        axis_sizes={a: mesh.shape[a] for a in batch_axes},
        intra=intra, inter=inter)


def score_comms_schedules(nbytes: int, mesh, topo=None) -> dict:
    """Cost-model seconds per all-reduce schedule for one ``nbytes`` sync
    (paper §3.2: the shape of the data and the concurrency decide)."""
    topo = topo or grad_sync_topology(mesh)
    return topo.schedule_scores(nbytes)


def comms_plan_for(cfg, mesh, *, wire_dtype: Optional[str] = None,
                   bucket_bytes: Optional[int] = None, topo=None):
    """The gradient-sync :class:`~repro_torch.comms.plan.CommsPlan` of a
    cell: the cost model's argmin at the bucket's size (buckets are what
    cross the wire), scored over the batch axes only."""
    from repro_torch.comms import bucketer
    from repro_torch.comms.plan import CommsPlan

    topo = topo or grad_sync_topology(mesh)
    bucket_bytes = bucket_bytes or bucketer.DEFAULT_BUCKET_BYTES
    grad_bytes = 4 * approx_param_count(cfg)
    msg = min(grad_bytes, bucket_bytes) or bucket_bytes
    scores = score_comms_schedules(msg, mesh, topo)
    schedule = min(scores, key=scores.get)
    return CommsPlan(schedule=schedule, wire_dtype=wire_dtype,
                     bucket_bytes=bucket_bytes, intra_axis="data")


def pipeline_spec_for(cfg, mesh, *,
                      num_microbatches: Optional[int] = None,
                      schedule: str = "gpipe"):
    """The :class:`~repro_torch.pipeline.PipelineSpec` of a cell, or None:
    a spec exists iff the mesh has a ``pipe`` axis of size > 1.  The stage
    boundaries are the uniform split (what the executable path needs, and
    what the memory-balanced partitioner gives a homogeneous stack); the
    default microbatch count 2 * pp keeps the bubble under 1/3."""
    pp = mesh.shape.get("pipe", 1)
    if pp <= 1:
        return None
    from repro_torch.pipeline import PipelineSpec

    L = max(1, getattr(cfg, "n_layers", 1) or 1)
    if L % pp:
        raise ValueError(
            f"n_layers={L} not divisible by pipe axis size {pp}")
    return PipelineSpec(
        n_stages=pp, axis="pipe", schedule=schedule,
        num_microbatches=num_microbatches or 2 * pp,
        boundaries=tuple(range(0, L + 1, L // pp)))


def score_hybrid_candidates(cfg, n_devices: int, *, global_batch: int,
                            seq_len: int,
                            num_microbatches: Optional[int] = None,
                            intra=None, inter=None,
                            device_flops: Optional[float] = None,
                            step_overhead_s: Optional[float] = None,
                            schedule: str = "gpipe",
                            hbm_budget=None, check_memory: bool = True,
                            return_refused: bool = False):
    """Cost-model seconds per (dp, tp, pp) factorization of ``n_devices``
    (paper §4), the reference's formula:

    - compute: 6 * params * tokens FLOPs over all devices;
    - TP: 4 residual-stream all-reduces per layer on the intranode link;
    - PP: the bubble stretches compute by 1 / (1 - bubble) and the
      stage-boundary transfers pay their critical-path alpha-beta term
      on the internode link (``pipeline/costs.py``);
    - DP: one gradient all-reduce of the 1/(tp*pp) shard, the best
      schedule over the dp group.

    Infeasible cells (head or layer counts that do not divide, a batch
    smaller than dp) are left out; cells whose peak stage footprint
    (``core/memory.py``) passes ``hbm_budget.usable`` are **refused**,
    not scored (``return_refused=True`` also gives ``{(dp, tp, pp, M):
    reason}``).  Links, the FLOPs rate and the step overhead resolve
    through the active calibration table (the nominals without one);
    explicit arguments win."""
    from repro_torch.comms import topology as topo_mod
    from repro_torch.core import calibrate as cal_mod
    from repro_torch.core import memory as mem_mod
    from repro_torch.pipeline import costs as pipe_costs

    if intra is None or inter is None:
        d_intra, d_inter = topo_mod.default_links()
        intra = intra or d_intra
        inter = inter or d_inter
    flops = device_flops if device_flops is not None \
        else pipe_costs.device_flops()
    overhead = step_overhead_s if step_overhead_s is not None \
        else cal_mod.step_overhead_s()
    budget = mem_mod.as_budget(hbm_budget)
    n_params = approx_param_count(cfg)
    L = max(1, getattr(cfg, "n_layers", 1) or 1)
    heads = getattr(cfg, "n_heads", 0) or 0
    D = getattr(cfg, "d_model", 1) or 1
    scores: dict = {}
    refused: dict = {}
    for dp in range(1, n_devices + 1):
        if n_devices % dp or global_batch % dp:
            continue
        for tp in range(1, n_devices // dp + 1):
            if (n_devices // dp) % tp:
                continue
            pp = n_devices // (dp * tp)
            if L % pp:
                continue
            if tp > 1 and (heads == 0 or heads % tp):
                continue
            local_batch = global_batch // dp
            M = num_microbatches or max(1, min(4 * pp, local_batch))
            M = math.gcd(local_batch, M) or 1

            if check_memory:
                stages = mem_mod.estimate_stage_footprints(
                    cfg, local_batch=local_batch, seq_len=seq_len,
                    n_stages=pp, num_microbatches=M,
                    schedule=schedule if pp > 1 else None,
                    zero_shards=dp, tp_shards=tp)
                peak = mem_mod.peak_stage_footprint(stages)
                if not peak.fits(budget):
                    refused[(dp, tp, pp, M)] = (
                        f"peak stage {peak.total / mem_mod.GIB:.2f} GiB > "
                        f"usable {budget.usable / mem_mod.GIB:.2f} GiB "
                        f"({budget.platform})")
                    continue

            t_comp = (6.0 * n_params * global_batch * seq_len
                      / n_devices / flops)
            t_tp = 0.0
            if tp > 1:
                ar_bytes = 2 * local_batch * seq_len * D    # bf16 stream
                wire = 2.0 * ar_bytes * (tp - 1) / tp
                t_tp = 4 * (L // pp) * (
                    M * 2 * (tp - 1) * intra.latency_s
                    + wire / intra.bandwidth_Bps)
            act = pipe_costs.boundary_act_bytes(
                max(1, local_batch // M), seq_len, D)
            t_pipe = pipe_costs.pipeline_step_seconds(
                t_comp + t_tp, pp, M, act, inter)
            t_dp = 0.0
            if dp > 1:
                topo = topo_mod.Topology(
                    intra_axes=(), inter_axes=("data",),
                    axis_sizes={"data": dp}, intra=intra, inter=inter)
                grad_bytes = int(4 * n_params / (tp * pp))
                t_dp = min(topo.schedule_scores(grad_bytes).values())
            scores[(dp, tp, pp)] = t_pipe + t_dp + overhead
    if return_refused:
        return scores, refused
    return scores


def best_hybrid(cfg, n_devices: int, **kwargs):
    """argmin (dp, tp, pp) over :func:`score_hybrid_candidates`: the
    fastest plan that fits.  When every factorization is refused the
    error lists each (dp, tp, pp, M) with its reason.  With
    ``return_refused=True``, ``(best, refused)``."""
    want_refused = kwargs.pop("return_refused", False)
    scores, refused = score_hybrid_candidates(cfg, n_devices,
                                              return_refused=True, **kwargs)
    if not scores:
        detail = "; ".join(
            f"(dp={k[0]}, tp={k[1]}, pp={k[2]}, M={k[3]}): {v}"
            for k, v in sorted(refused.items()))
        raise ValueError(
            f"no feasible (dp, tp, pp) for {n_devices} devices"
            + (f" — all candidates refused by the memory model: {detail}"
               if refused else ""))
    best = min(scores, key=scores.get)
    return (best, refused) if want_refused else best


def plan_for(cfg, mesh, *, fsdp_tensor_bytes: float = 4 * GiB,
             seq_parallel_residual: Optional[bool] = None) -> ParallelPlan:
    """The plan for a model config on a mesh (anything with a ``shape``
    mapping of axis sizes)."""
    tp_axis = "model"
    tp = mesh.shape.get(tp_axis, 1)
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)

    # head-TP only if both head counts divide the axis; attention-free
    # (SSM) archs have no attention layout at all
    n_heads = getattr(cfg, "n_heads", 0) or 0
    n_kv = getattr(cfg, "n_kv_heads", 0) or 0
    if n_heads == 0:
        attn_mode = "none"
    elif n_heads % tp == 0 and n_kv % tp == 0:
        attn_mode = "head_tp"
    else:
        attn_mode = "sp"

    if seq_parallel_residual is None:
        # sequence-sharded residuals for every mode (Megatron-SP)
        seq_parallel_residual = True

    # SP keeps its weights replicated at use anyway; when the whole FFN
    # bank fits a device, the MLP stays replicated and fully local over
    # the sequence shards
    ffn_replicated = False
    if attn_mode == "sp" and getattr(cfg, "d_ff", 0):
        ffn_bytes = 2 * 3 * cfg.n_layers * cfg.d_model * cfg.d_ff
        ffn_replicated = ffn_bytes < 4 * GiB

    return ParallelPlan(
        batch_axes=batch_axes,
        tp_axis=tp_axis,
        attn_mode=attn_mode,
        fsdp=True,                  # gated per tensor (_maybe_fsdp)
        seq_parallel_residual=seq_parallel_residual,
        ffn_replicated=ffn_replicated,
        n_layers=max(1, getattr(cfg, "n_layers", 1)),
        fsdp_tensor_bytes=fsdp_tensor_bytes,
        comms=comms_plan_for(cfg, mesh),
        pipeline=pipeline_spec_for(cfg, mesh),
    )
