"""Memory accounting, budgets and the per-stage footprint model (paper
§2.1), ported from the reference's ``core/memory.py``.

The footprint model predicts per-device bytes for a (config, plan,
schedule) train cell before anything is allocated.  It prices each
pipeline stage separately (weights at 1/S of the layers, activations
times the schedule's in-flight microbatches, the stage-boundary stash,
the edge stages' logits), and it is what ``core/planner.py`` refuses OOM
(dp, tp, pp, M) candidates with and what ``Session.plan`` checks a cell
against.  One :class:`MemoryBudget` carries the raw bytes and the
usable-fraction headroom, so every consumer compares against the same
``budget.usable``.

Differences from the reference:

- :func:`budget_for` keys on a device: a CUDA device by its name
  (``torch.cuda.get_device_name``; a name holding "h100" is the
  ``h100`` entry), a CPU device as ``cpu``, as the reference's fake CPU
  devices are.
- The reference's measured side, ``compiled_peak_bytes`` (XLA's
  ``memory_analysis`` of the compiled step), becomes
  :func:`measured_peak_bytes`: ``torch.cuda.max_memory_allocated`` around
  the steps on the card.  On the CPU nothing is measured (None), and the
  drift report leaves the peak row out.
- ``donate_state`` has no counterpart: the port's step updates the state
  in place (``Session.step`` keeps the tensors it was given), which is
  what the reference's buffer donation gives it.
- :class:`Ledger` and :func:`tree_bytes` walk nested dicts, lists and
  tuples of tensors (the port's state trees).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .layout import Layout

GIB = 1024**3

#: the single headroom constant: the fraction of a device's memory the
#: footprint model may plan into (the rest covers the allocator's slack,
#: workspaces and buffers the model does not see)
DEFAULT_HEADROOM = 0.9


@dataclasses.dataclass(frozen=True)
class MemoryBudget:
    """Per-device memory budget, the single source of truth for
    headroom."""

    hbm_bytes: int
    headroom: float = DEFAULT_HEADROOM
    platform: str = "custom"

    @property
    def usable(self) -> int:
        return int(self.hbm_bytes * self.headroom)

    @property
    def gib(self) -> float:
        return self.hbm_bytes / GIB

    def describe(self) -> str:
        return (f"{self.platform} {self.gib:.1f} GiB "
                f"(usable {self.usable / GIB:.1f} GiB "
                f"@ headroom {self.headroom:.2f})")


#: per-device budgets by platform, the reference's table: ``h100`` is the
#: card's 80 GiB; ``cpu`` is the reference's debug stand-in, kept at v5e
#: parity so that a CPU plan answers "would this fit a v5e?"
HBM_BUDGETS: Dict[str, MemoryBudget] = {
    "v5e": MemoryBudget(16 * GIB, platform="v5e"),
    "v5p": MemoryBudget(95 * GIB, platform="v5p"),
    "h100": MemoryBudget(80 * GIB, platform="h100"),
    "cpu": MemoryBudget(16 * GIB, platform="cpu"),
}

DEFAULT_PLATFORM = "v5e"

# device name substring -> budget key, first match wins
_KIND_TABLE = (
    ("v5p", "v5p"),
    ("v5e", "v5e"),
    ("v5 lite", "v5e"),
    ("h100", "h100"),
    ("cpu", "cpu"),
)


def budget_for(mesh=None, *, hbm_gib: Optional[float] = None,
               platform: Optional[str] = None,
               headroom: Optional[float] = None,
               device: Union[str, torch.device, None] = None
               ) -> MemoryBudget:
    """The per-device budget.  Priority: an explicit ``hbm_gib`` (the
    ``--hbm-gib`` flag) > an explicit ``platform`` key > the ``device``'s
    kind > the v5e default (no device named: the reference's default).
    A CUDA card whose name no entry matches gets its own memory
    (``total_memory``) under its name, never another platform's.
    ``mesh`` is accepted for the reference's signature; the port's mesh
    names ranks, not devices, so the kind comes from ``device``."""
    del mesh
    if hbm_gib is not None:
        return MemoryBudget(int(hbm_gib * GIB),
                            headroom=(headroom if headroom is not None
                                      else DEFAULT_HEADROOM),
                            platform=platform or "override")
    key = platform
    if key is None and device is not None:
        device = torch.device(device)
        kind = (torch.cuda.get_device_name(device).lower()
                if device.type == "cuda" else device.type)
        for sub, k in _KIND_TABLE:
            if sub in kind:
                key = k
                break
        if key is None and device.type == "cuda":
            total = torch.cuda.get_device_properties(device).total_memory
            base = MemoryBudget(int(total), platform=kind)
            return (base if headroom is None
                    else dataclasses.replace(base, headroom=headroom))
    base = HBM_BUDGETS.get(key or DEFAULT_PLATFORM,
                           HBM_BUDGETS[DEFAULT_PLATFORM])
    if headroom is not None and headroom != base.headroom:
        return dataclasses.replace(base, headroom=headroom)
    return base


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


def nbytes(shape, dtype) -> int:
    return math.prod(shape) * _itemsize(dtype)


@dataclasses.dataclass
class Footprint:
    """Per-device byte budget, by category."""

    params: int = 0
    optimizer: int = 0
    gradients: int = 0
    activations: int = 0
    stash: int = 0          # stage-boundary microbatch stash (pipeline)
    logits: int = 0         # edge-stage fp32 logits + cotangent
    kv_cache: int = 0
    workspace: int = 0

    _FIELDS = ("params", "optimizer", "gradients", "activations",
               "stash", "logits", "kv_cache", "workspace")

    @property
    def total(self) -> int:
        return sum(getattr(self, f) for f in self._FIELDS)

    @property
    def calibrated_total(self) -> float:
        """``total`` times the active calibration table's measured /
        predicted peak ratio (1.0 without a table)."""
        from repro_torch.core import calibrate
        return self.total * calibrate.memory_scale()

    def fits(self, budget: Union[MemoryBudget, int, None] = None) -> bool:
        """Does this footprint (:attr:`calibrated_total`) fit
        ``budget.usable``?  A raw byte count takes the default
        headroom."""
        budget = as_budget(budget)
        return self.calibrated_total <= budget.usable

    def report(self) -> str:
        rows = [(k, getattr(self, k)) for k in self._FIELDS]
        rows.append(("TOTAL", self.total))
        return "\n".join(f"  {k:<12} {v / GIB:8.3f} GiB" for k, v in rows)


def as_budget(budget: Union[MemoryBudget, int, None]) -> MemoryBudget:
    if budget is None:
        return HBM_BUDGETS[DEFAULT_PLATFORM]
    if isinstance(budget, MemoryBudget):
        return budget
    return MemoryBudget(int(budget))


# --------------------------------------------------------------------------
# per-stage footprint model
# --------------------------------------------------------------------------

#: the fp32 logits block is live twice around the loss: the forward value
#: and its same-shaped cotangent
LOGITS_LIVE_FACTOR = 2

#: coarse transient working set of one layer body, in residual blocks
WORKSPACE_BLOCKS = 4


def _edge_param_count(cfg) -> int:
    """Embed + unembed + final norm parameters (padded vocab)."""
    V = getattr(cfg, "padded_vocab", None) or getattr(cfg, "vocab_size", 0)
    D = getattr(cfg, "d_model", 0)
    return 2 * V * D + D


def _layer_param_count(cfg) -> int:
    total = cfg.param_count() if hasattr(cfg, "param_count") else 0
    return max(0, total - _edge_param_count(cfg))


def stage_footprint(cfg, *, local_batch: int, seq_len: int,
                    stage: int = 0, n_stages: int = 1,
                    num_microbatches: int = 1,
                    schedule: Optional[str] = None,
                    zero_shards: int = 1, tp_shards: int = 1,
                    fsdp_shards: int = 1,
                    param_itemsize: int = 2, moment_itemsize: int = 4,
                    edge_gated: bool = True,
                    stash_slots: Optional[int] = None) -> Footprint:
    """Predicted per-device bytes for ONE pipeline stage of a train cell,
    the reference's model term for term:

    - **params**: the stage's 1/S of the layer stack plus the edge params,
      over the TP and FSDP shard counts;
    - **optimizer**: fp32 master + two moments, ZeRO-sharded over the data
      axis (``zero_shards``);
    - **gradients**: the fp32 accumulator, reduce-scattered onto the ZeRO
      shards off the pipeline, full stage size on it;
    - **activations**: per-layer residual blocks times the schedule's
      in-flight microbatches (M for GPipe, one for 1F1B and off the
      pipeline);
    - **stash**: the stage-boundary inputs a schedule keeps live;
    - **logits**: the fp32 (B_mb, S, V / tp) block and its cotangent, on
      every stage under GPipe (per tick), on the last stage otherwise;
    - **workspace**: a coarse transient term for the layer body."""
    S = max(1, n_stages)
    M = max(1, num_microbatches)
    L = max(1, getattr(cfg, "n_layers", 1) or 1)
    D = getattr(cfg, "d_model", 0) or 0
    V = getattr(cfg, "padded_vocab", None) or getattr(cfg, "vocab_size", 0)
    pipelined = schedule in ("gpipe", "1f1b") and S > 1

    layers_stage = L / S
    layer_count = _layer_param_count(cfg) * layers_stage / L
    edge_count = _edge_param_count(cfg)
    stage_count = (layer_count + edge_count) / tp_shards

    params = int(param_itemsize * stage_count / fsdp_shards)
    optimizer = int((4 + 2 * moment_itemsize) * stage_count / zero_shards)
    grad_shards = 1 if pipelined else zero_shards
    gradients = int(4 * stage_count / grad_shards)

    b_mb = max(1, local_batch // M)
    act_block = b_mb * seq_len * D * 2          # one bf16 residual block
    if pipelined:
        from repro_torch.pipeline import costs as pipe_costs
        in_flight = pipe_costs.in_flight_microbatches(schedule, S, M)
        if schedule == "gpipe":
            activations = int(in_flight * layers_stage * act_block)
            stash = (M + S - 1) * act_block
        else:                                    # 1f1b: recompute one mb
            activations = int(layers_stage * act_block)
            slots = stash_slots or pipe_costs.min_stash_slots(S, M)
            stash = slots * act_block
    else:
        activations = int(layers_stage * act_block)
        stash = 0

    logits_block = b_mb * seq_len * max(1, V // max(1, tp_shards)) * 4
    if pipelined and schedule == "gpipe":
        logits = (M + S - 1) * LOGITS_LIVE_FACTOR * logits_block
    elif (not pipelined) or (not edge_gated) or stage == S - 1:
        logits = LOGITS_LIVE_FACTOR * logits_block
    else:
        logits = 0

    f_eff = max(D,
                getattr(cfg, "d_ff", 0) or 0,
                getattr(cfg, "d_inner", 0) or 0)
    workspace = WORKSPACE_BLOCKS * b_mb * seq_len * max(D, f_eff
                                                        // max(1, tp_shards)) * 2

    return Footprint(params=params, optimizer=optimizer,
                     gradients=gradients, activations=activations,
                     stash=int(stash), logits=int(logits),
                     workspace=int(workspace))


def estimate_stage_footprints(cfg, *, local_batch: int, seq_len: int,
                              n_stages: int = 1, num_microbatches: int = 1,
                              schedule: Optional[str] = None,
                              **kw) -> List[Footprint]:
    """One :class:`Footprint` per pipeline stage (one entry when the cell
    is not pipelined)."""
    S = max(1, n_stages)
    sched = schedule if S > 1 else None
    return [stage_footprint(cfg, local_batch=local_batch, seq_len=seq_len,
                            stage=s, n_stages=S,
                            num_microbatches=num_microbatches,
                            schedule=sched, **kw)
            for s in range(S)]


def footprints_for_mesh(cfg, mesh, *, global_batch: int, seq_len: int,
                        num_microbatches: int = 1,
                        schedule: str = "gpipe",
                        moment_itemsize: int = 4) -> List[Footprint]:
    """Per-stage footprints of a train cell on a mesh (anything with a
    ``shape`` mapping): DP shards from the batch axes, stages from
    ``pipe``, TP shards from ``model``."""
    nb = math.prod(mesh.shape.get(a, 1) for a in ("pod", "data")) or 1
    pp = mesh.shape.get("pipe", 1)
    return estimate_stage_footprints(
        cfg, local_batch=max(1, global_batch // nb), seq_len=seq_len,
        n_stages=pp, num_microbatches=max(1, num_microbatches),
        schedule=schedule if pp > 1 else None,
        zero_shards=nb, tp_shards=mesh.shape.get("model", 1),
        moment_itemsize=moment_itemsize)


def kv_cache_bytes(cfg, *, batch: int, seq_len: int, mesh=None,
                   plan=None) -> int:
    """A dense KV cache's bytes on one rank: (L, batch, seq_len, Hkv, hd)
    bf16 for k and for v, over the shards of ``plan.kv_cache`` on
    ``mesh`` (the slots over the data axes where they divide, the
    sequence over the model axis, or over every axis)."""
    whole = 2 * 2 * cfg.n_layers * batch * seq_len * cfg.n_kv_heads \
        * cfg.d_head
    if mesh is None or plan is None:
        return whole
    return whole // plan.kv_cache(batch, mesh).num_shards(mesh)


def param_bytes_per_rank(specs, mesh=None) -> int:
    """The bytes of one rank's blocks of the leaves ``specs`` (name ->
    ``ParamSpec``, their layouts on ``mesh``; whole without a mesh)."""
    total = 0
    for spec in specs.values():
        shape = (spec.shape if mesh is None or spec.layout is None
                 else spec.layout.local_shape(spec.shape, mesh))
        total += nbytes(shape, spec.dtype)
    return total


def serve_footprint(cfg, *, batch: int, seq_len: int, decode: bool,
                    mesh=None, plan=None, param_bytes: Optional[int] = None,
                    param_itemsize: int = 2) -> Footprint:
    """Predicted per-device bytes of a serve cell on a mesh: a prefill of
    ``batch`` prompts of ``seq_len`` (``decode=False``: the K/V it
    returns) or a decode step against a ``seq_len`` cache (``decode``):

    - **params**: ``param_bytes`` (this rank's blocks,
      :func:`param_bytes_per_rank`), else the whole model over the model
      axis, as the train cells' term;
    - **kv_cache**: :func:`kv_cache_bytes`, this rank's block;
    - **logits**: the last position's fp32 logits, whole on every rank;
    - **activations**: the residual of the rank's rows and one layer's
      K/V over every head (gathered before a rank keeps its shard);
    - **workspace**: the layer body's transient term."""
    tp = mesh.shape.get("model", 1) if mesh is not None else 1
    D = cfg.d_model
    V = getattr(cfg, "padded_vocab", None) or cfg.vocab_size
    S = 1 if decode else seq_len
    params = (param_bytes if param_bytes is not None
              else int(param_itemsize * (_layer_param_count(cfg)
                                         + _edge_param_count(cfg)) / tp))
    kv = kv_cache_bytes(cfg, batch=batch, seq_len=seq_len, mesh=mesh,
                        plan=plan)
    rows = batch * S
    activations = rows * D * 2 + 2 * rows * cfg.n_kv_heads * cfg.d_head * 2
    f_eff = max(D, getattr(cfg, "d_ff", 0) or 0)
    workspace = WORKSPACE_BLOCKS * rows * max(D, f_eff // tp) * 2
    return Footprint(params=params, kv_cache=int(kv),
                     logits=batch * V * 4, activations=int(activations),
                     workspace=int(workspace))


def peak_stage_footprint(footprints: Sequence[Footprint]) -> Footprint:
    """The stage with the largest total: the per-device peak."""
    return max(footprints, key=lambda f: f.total)


def measured_peak_bytes(device: Union[str, torch.device]) -> Optional[int]:
    """The measured side of every predicted-vs-measured memory comparison:
    ``torch.cuda.max_memory_allocated`` on a CUDA device (reset its peak
    before the steps it should cover), None on the CPU, where nothing is
    measured."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return int(torch.cuda.max_memory_allocated(device))


def footprint_table(footprints: Sequence[Footprint],
                    budget: Union[MemoryBudget, int, None] = None) -> str:
    """Per-stage table with a fits/OOM verdict column."""
    budget = as_budget(budget)
    cols = Footprint._FIELDS
    head = ("stage " + "".join(f"{c[:6]:>9}" for c in cols)
            + f"{'total':>9}  verdict")
    lines = [head]
    for s, f in enumerate(footprints):
        cells = "".join(f"{getattr(f, c) / GIB:9.3f}" for c in cols)
        verdict = "fits" if f.fits(budget) else "OOM"
        lines.append(f"{s:>5} {cells}{f.total / GIB:9.3f}  {verdict}")
    ok = all(f.fits(budget) for f in footprints)
    lines.append(f"budget {budget.describe()} -> "
                 + ("FITS" if ok else "OOM"))
    return "\n".join(lines)


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


class Ledger:
    """Running account of device-resident tensors, name -> bytes per
    device (a layout on the ledger's mesh gives a block's bytes)."""

    def __init__(self, mesh=None):
        self.mesh = mesh
        self.entries: Dict[str, int] = {}

    def add(self, name: str, shape, dtype,
            layout: Optional[Layout] = None) -> int:
        if layout is not None and self.mesh is not None:
            b = layout.bytes_per_device(shape, dtype, self.mesh)
        else:
            b = nbytes(shape, dtype)
        self.entries[name] = self.entries.get(name, 0) + b
        return b

    def add_tree(self, name: str, tree, layouts=None) -> int:
        leaves = list(_leaves(tree))
        lls = (list(_leaves(layouts)) if layouts is not None
               else [None] * len(leaves))
        total = 0
        for i, (leaf, ll) in enumerate(zip(leaves, lls)):
            total += self.add(f"{name}/{i}", leaf.shape, leaf.dtype, ll)
        return total

    @property
    def total(self) -> int:
        return sum(self.entries.values())


def tree_bytes(tree: Any) -> int:
    return sum(nbytes(x.shape, x.dtype) for x in _leaves(tree)
               if hasattr(x, "shape"))
