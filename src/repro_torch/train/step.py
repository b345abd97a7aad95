"""Train-step implementations, ported from the reference's
``train/step.py``: microbatched gradient accumulation and AdamW, on one
rank (the ``gspmd`` path) or with the gradients synchronized through
:mod:`repro_torch.comms` over a process group (the ``comms`` path).

A step is ``train_step(state, batch) -> (state, metrics)`` with
``state = {"params", "opt"}`` and ``batch = {"tokens", "labels"}`` the
global batch.  On the comms path each rank takes its contiguous share of
the batch's rows, as the reference's ``shard_map`` splits the batch over
its ``data`` axis, and every rank ends the step with the same params.
The update is in place (the reference donates the state).  The
reference's pipeline path waits for ROADMAP queue 1, item 10.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.comms import plan as comms_plan_mod
from repro_torch.comms import schedules
from repro_torch.core import precision
from repro_torch.train import optimizer as opt

Tensors = Dict[str, torch.Tensor]


def split_microbatches(batch: Tensors, n: int) -> List[Tensors]:
    """``n`` microbatches of consecutive rows of every batch leaf."""
    return [dict(zip(batch, parts))
            for parts in zip(*(v.chunk(n) for v in batch.values()))]


def local_grads(model, params: Tensors, batch: Tensors,
                num_microbatches: int = 1) -> Tuple[Tensors, Tensors]:
    """Forward and backward on one rank's batch: (gradients, metrics).

    One microbatch gives the gradients in the params' dtypes; more are
    accumulated in fp32 buffers and divided by their count, as the
    reference's scan does, and the metrics are their means (each sum in
    microbatch order, then the count's fl32 reciprocal, as XLA compiles
    the reference's ``g / num_microbatches`` and ``jnp.mean``)."""
    names = list(params)
    leaves = [params[n] for n in names]
    if num_microbatches == 1:
        loss, metrics = model.loss_fn(params, batch)
        grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
        return grads, {k: v.detach() for k, v in metrics.items()}
    acc = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for n, p in params.items()}
    ms: List[Tensors] = []
    for mb in split_microbatches(batch, num_microbatches):
        loss, metrics = model.loss_fn(params, mb)
        for n, g in zip(names, torch.autograd.grad(loss, leaves)):
            acc[n] += g.float()
        ms.append({k: v.detach() for k, v in metrics.items()})
    grads = {n: precision.div_count(a, num_microbatches)
             for n, a in acc.items()}
    return grads, {k: precision.div_count(
        functools.reduce(torch.add, [m[k].float() for m in ms]),
        num_microbatches) for k in ms[0]}


def _apply(adamw, state, grads, metrics):
    params, new_opt, stats = opt.apply(adamw, state["opt"], grads,
                                       state["params"])
    return {"params": params, "opt": new_opt}, dict(metrics, **stats)


def gspmd_train_step(model, adamw: Optional[opt.AdamWConfig] = None,
                     num_microbatches: int = 1) -> Callable:
    """The one-rank path: ``train_step(state, batch)`` differentiates the
    whole batch and applies AdamW."""
    adamw = adamw or opt.AdamWConfig()

    def train_step(state, batch):
        grads, metrics = local_grads(model, state["params"], batch,
                                     num_microbatches)
        return _apply(adamw, state, grads, metrics)

    return train_step


def comms_train_step(model, adamw: Optional[opt.AdamWConfig] = None,
                     num_microbatches: int = 1, comms=None,
                     group: Optional[dist.ProcessGroup] = None) -> Callable:
    """The data-parallel path: each rank differentiates its share of the
    batch, then ONE bucketed (optionally bf16/int8-compressed) sync per
    step runs over the group (``comms.plan.sync_tree``, after the
    microbatch loop), the metrics are averaged over the group as the
    reference's ``pmean`` does, and every rank applies AdamW to the same
    gradients."""
    adamw = adamw or opt.AdamWConfig()
    comms = comms or comms_plan_mod.CommsPlan()
    n = dist.get_world_size(group)
    rank = dist.get_rank(group)

    def train_step(state, batch):
        rows = next(iter(batch.values())).shape[0]
        if rows % n:
            raise ValueError(f"a batch of {rows} rows does not split over "
                             f"{n} ranks")
        local = {k: v.chunk(n)[rank] for k, v in batch.items()}
        grads, metrics = local_grads(model, state["params"], local,
                                     num_microbatches)
        grads = comms_plan_mod.sync_tree(grads, comms, group)
        keys = sorted(metrics)
        vec = torch.stack([metrics[k].float() for k in keys])
        vec = schedules.pmean(vec, group)
        return _apply(adamw, state, grads, dict(zip(keys, vec.unbind())))

    return train_step


def dispatch_train_step(model, *, adamw=None, num_microbatches: int = 1,
                        comms=None, group=None, path: str = "gspmd"
                        ) -> Callable:
    """The train-step dispatcher: ``gspmd`` or ``comms``."""
    if path == "comms":
        return comms_train_step(model, adamw, num_microbatches, comms, group)
    if path == "gspmd":
        return gspmd_train_step(model, adamw, num_microbatches)
    if path == "pipeline":
        raise NotImplementedError("the pipeline train path is not ported "
                                  "yet (ROADMAP queue 1, item 10)")
    raise ValueError(f"unknown train-step path {path!r}; expected gspmd | "
                     "comms")
