"""Architecture registry + input specs.

``input_specs(cfg, shape, mesh, plan)`` returns stand-ins for every model
input of a cell, as the reference's: ``meta`` tensors (shape and dtype,
no storage) where the reference has ``ShapeDtypeStruct``, and the port's
:class:`~repro_torch.core.layout.Layout` where it has a
``NamedSharding``.  The dry run traces against them.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from .base import (ARCH_IDS, SHAPES, ModelConfig, ShapeConfig, all_archs,
                   cells, get_config, register, scale_config)

__all__ = ["ARCH_IDS", "SHAPES", "ModelConfig", "ShapeConfig", "all_archs",
           "cells", "get_config", "ported_archs", "register", "scale_config",
           "input_specs", "default_microbatches"]


def ported_archs() -> Tuple[str, ...]:
    """The architectures the port has a config module for, in
    :data:`ARCH_IDS`' order (those :func:`cells` lists)."""
    return tuple(dict.fromkeys(a for a, _ in cells()))


def _batch_axes(plan, mesh, B: int):
    nb = math.prod(mesh.shape[a] for a in plan.batch_axes)
    return plan.batch_axes if (B % nb == 0 and B >= nb) else None


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(
    cfg: ModelConfig, shape: ShapeConfig, mesh, plan,
    make_shardings: bool = True,
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Returns (spec_tree, layout_tree) for the step's *data* inputs.

    train/prefill: {tokens, labels[, vision_embeds]}
    decode:        {tokens (B,1), pos ()}   (cache/params specs come from
                                             the Model/optimizer)

    ``make_shardings=False`` gives the layouts' dims (the reference's bare
    ``PartitionSpec``) in place of the layouts."""
    from repro_torch.core.layout import Layout

    B, S = shape.global_batch, shape.seq_len
    ba = _batch_axes(plan, mesh, B)
    _ns = (lambda dims: Layout(dims)) if make_shardings \
        else (lambda dims: dims)
    tok_s = _ns((ba, None))
    sds: Dict[str, Any] = {}
    shd: Dict[str, Any] = {}

    if shape.is_decode:
        sds["tokens"] = _spec((B, 1), torch.int32)
        shd["tokens"] = tok_s
        sds["pos"] = _spec((), torch.int32)
        shd["pos"] = _ns(())
        return sds, shd

    if cfg.family == "vlm":
        s_text = S - cfg.n_vision_tokens
        sds["tokens"] = _spec((B, s_text), torch.int32)
        shd["tokens"] = tok_s
        sds["vision_embeds"] = _spec((B, cfg.n_vision_tokens, cfg.d_model),
                                     torch.bfloat16)
        shd["vision_embeds"] = _ns((ba, None, None))
    else:
        sds["tokens"] = _spec((B, S), torch.int32)
        shd["tokens"] = tok_s

    if shape.kind == "train":
        sds["labels"] = _spec((B, S), torch.int32)
        shd["labels"] = tok_s
    return sds, shd


def default_microbatches(cfg: ModelConfig, shape: ShapeConfig, mesh,
                         plan, budget_bytes: float = 3.0 * 2**30) -> int:
    """Smallest power-of-two microbatch count keeping the rematerialized
    residual stream under ``budget_bytes`` per device (gradient
    accumulation doubles as the ZeRO-2 reduce-scatter cadence)."""
    if shape.kind != "train":
        return 1
    nb = math.prod(mesh.shape[a] for a in plan.batch_axes)
    b_loc = max(1, shape.global_batch // nb)
    resid = cfg.n_layers * b_loc * shape.seq_len * cfg.d_model * 2
    nmb = 1
    while resid / nmb > budget_bytes and nmb < b_loc:
        nmb *= 2
    return nmb
