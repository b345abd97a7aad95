"""PipelineSpec: the declarative pipeline-parallel policy on a
ParallelPlan, ported from the reference's ``pipeline/spec.py``.

One frozen object names the stage count, the mesh axis, the microbatch
schedule and the stage boundaries; ``train/step.py`` executes it,
``core/planner.py`` attaches it, and the param-spec rewrites here put dim
0 of every stacked ``layers.*`` leaf on the ``pipe`` axis, so that a rank
holds its stage's ``L/S`` layers and, on their ZeRO-1 blocks over the
batch axes (:class:`repro_torch.train.optimizer.ZeroLayouts`), their
optimizer state.  The edge leaves (``embed``, ``unembed``,
``final_norm``) stay replicated across ``pipe``, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.layout import Layout
from repro_torch.models.params import ParamSpec, tree_init
from repro_torch.pipeline import costs

SCHEDULES = ("gpipe", "1f1b")


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    """Declarative inter-layer pipeline policy for one training cell."""

    n_stages: int
    axis: str = "pipe"
    schedule: str = "gpipe"              # gpipe | 1f1b
    num_microbatches: int = 4
    boundaries: Tuple[int, ...] = ()     # from partition.StagePartition
    # 1F1B stage-input ring size; None = the minimal min(M, 2S-1) ring
    # (costs.min_stash_slots), settable up to M
    stash_slots: Optional[int] = None

    def __post_init__(self):
        if self.schedule not in SCHEDULES:
            raise ValueError(f"unknown pipeline schedule {self.schedule!r}; "
                             f"expected one of {SCHEDULES}")
        if self.num_microbatches < 1:
            raise ValueError("num_microbatches must be >= 1")
        if self.stash_slots is not None:
            lo = costs.min_stash_slots(self.n_stages, self.num_microbatches)
            if not lo <= self.stash_slots <= max(lo, self.num_microbatches):
                raise ValueError(
                    f"stash_slots={self.stash_slots} outside "
                    f"[{lo}, {max(lo, self.num_microbatches)}] for "
                    f"S={self.n_stages}, M={self.num_microbatches}")

    def resolved_stash_slots(self) -> int:
        """Ring-buffer size the 1F1B schedule allocates."""
        return self.stash_slots or costs.min_stash_slots(
            self.n_stages, self.num_microbatches)

    def bubble_fraction(self) -> float:
        return costs.bubble_fraction(self.n_stages, self.num_microbatches)

    def boundary_wire_bytes(self, microbatch: int, seq_len: int,
                            d_model: int) -> int:
        act = costs.boundary_act_bytes(microbatch, seq_len, d_model)
        return costs.boundary_wire_bytes(act, self.n_stages,
                                         self.num_microbatches)


def pipeline_param_specs(model, spec: PipelineSpec) -> Dict[str, ParamSpec]:
    """The model's param specs with dim 0 of every stacked ``layers.*``
    leaf on ``spec.axis``; the edge leaves keep their layouts (replicated
    across ``pipe``: only the edge stages use them, and their gradients
    are combined over the axis)."""
    cfg = model.cfg
    if cfg.n_layers % spec.n_stages:
        raise ValueError(f"n_layers={cfg.n_layers} not divisible by "
                         f"pp={spec.n_stages}")
    out = {}
    for name, s in model.param_specs().items():
        lay = s.layout if s.layout is not None \
            else Layout.replicated(len(s.shape))
        if name.startswith("layers."):
            assert s.shape[0] == cfg.n_layers, (name, s.shape, cfg.n_layers)
            lay = lay.with_dim(0, spec.axis)
        out[name] = dataclasses.replace(s, layout=lay)
    return out


def pipeline_state_specs(model, mesh, spec: PipelineSpec, adamw=None
                         ) -> Dict[str, Any]:
    """``{"params", "opt"}`` as specs: the params on the pipeline layouts,
    mu, nu (the moment dtype) and the fp32 master on their ZeRO-1
    layouts, the step a scalar."""
    from repro_torch.train import optimizer as opt
    pspecs = pipeline_param_specs(model, spec)
    zero = opt.ZeroLayouts.of(pspecs, mesh)
    moment = (adamw or opt.AdamWConfig()).moment_dtype

    def slot(dtype):
        return {k: dataclasses.replace(s, dtype=dtype, init="zeros",
                                       layout=zero.zero[k])
                for k, s in pspecs.items()}
    return {"params": pspecs,
            "opt": {"step": ParamSpec((), torch.int32, init="zeros",
                                      layout=Layout(())),
                    "mu": slot(moment), "nu": slot(moment),
                    "master": slot(torch.float32)}}


def _map_specs(fn, tree):
    if isinstance(tree, ParamSpec):
        return fn(tree)
    return {k: _map_specs(fn, v) for k, v in tree.items()}


def pipeline_state_shardings(model, mesh, spec: PipelineSpec, adamw=None):
    """The layout of every leaf of the state (the port's shardings)."""
    return _map_specs(lambda s: s.layout,
                      pipeline_state_specs(model, mesh, spec, adamw))


def pipeline_state_sds(model, mesh, spec: PipelineSpec, adamw=None):
    """Shape stand-ins (``meta`` tensors of the global shapes) of the
    state."""
    return _map_specs(
        lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"),
        pipeline_state_specs(model, mesh, spec, adamw))


def pipeline_init_state(model, mesh, spec: PipelineSpec, seed: int = 0,
                        adamw=None, params=None) -> Dict[str, Any]:
    """This rank's ``{params, opt}``: the params drawn from ``seed`` as on
    one rank (or the given global ``params``), this rank's blocks of the
    pipeline layouts kept (its stage's layers, the edge leaves whole),
    and AdamW's state on their ZeRO-1 blocks; the params take
    gradients."""
    from repro_torch.models.params import shard_tree
    from repro_torch.train import optimizer as opt
    pspecs = pipeline_param_specs(model, spec)
    if params is None:
        params = tree_init(seed, pspecs, model.device, mesh)
    else:
        params = shard_tree({k: v.to(model.device) for k, v in params.items()},
                            {k: s.layout for k, s in pspecs.items()}, mesh)
    state = {"params": params,
             "opt": opt.init_state(params, adamw or opt.AdamWConfig(),
                                   zero=opt.ZeroLayouts.of(pspecs, mesh))}
    for p in params.values():
        p.requires_grad_(True)
    return state
