"""Train-step implementations, ported from the reference's
``train/step.py``: microbatched gradient accumulation and AdamW, on one
rank or on a ``(data, model)`` mesh (the ``gspmd`` path), or with the
gradients synchronized through :mod:`repro_torch.comms` over a
data-parallel group (the ``comms`` path).

A step is ``train_step(state, batch) -> (state, metrics)`` with
``state = {"params", "opt"}`` and ``batch = {"tokens", "labels"}`` the
global batch.  Both multi-rank paths give a rank the rows of its data
coordinate (:func:`repro_torch.core.layout.batch_block`), as the
reference's ``shard_map`` and GSPMD split the batch over its ``data``
axis.  On a mesh the gradient sync is the reference's implicit one: each
rank differentiates its blocks, and each leaf's gradient is summed over
the axes whose work was split and that the leaf's storage layout does not
use (:meth:`Model.grad_split_axes`), by a reduce-scatter onto the leaf's
ZeRO block wherever the ZeRO layout shards that axis, else by a sum.  The
update is in place (the reference donates the state).  The ``pipeline``
path (:func:`pipeline_train_step`) runs the layer stack in stages over
the mesh's ``pipe`` axis (:mod:`repro_torch.pipeline`) on a DP x PP mesh.
:func:`repro_torch.api.session.dispatch_train_step` selects among the
three.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.comms import plan as comms_plan_mod
from repro_torch.comms import schedules
from repro_torch.core import distributed as dist_mod
from repro_torch.core import precision
from repro_torch.core.layout import Layout, axis_names, batch_block
from repro_torch.train import optimizer as opt

Tensors = Dict[str, torch.Tensor]


def split_microbatches(batch: Tensors, n: int) -> List[Tensors]:
    """``n`` microbatches of consecutive rows of every batch leaf."""
    return [dict(zip(batch, parts))
            for parts in zip(*(v.chunk(n) for v in batch.values()))]


def local_grads(model, params: Tensors, batch: Tensors,
                num_microbatches: int = 1,
                sync: Optional[Callable] = None) -> Tuple[Tensors, Tensors]:
    """Forward and backward on a batch: (gradients, metrics).

    Given ``sync(name, g, rows)``, each microbatch's gradient of leaf
    ``name`` goes through it first (``rows`` being the microbatch's row
    count): the mesh path's sync onto the leaf's ZeRO block.  One
    microbatch gives the gradients in the params' dtypes; more are
    accumulated in fp32 buffers (allocated from the first synced
    gradients) and divided by their count, as the reference's scan does,
    and the metrics are their means (each sum in microbatch order, then
    the count's fl32 reciprocal, as XLA compiles the reference's
    ``g / num_microbatches`` and ``jnp.mean``)."""
    names = list(params)
    leaves = [params[n] for n in names]
    acc: Optional[Tensors] = None
    ms: List[Tensors] = []
    mbs = ([batch] if num_microbatches == 1
           else split_microbatches(batch, num_microbatches))
    for mb in mbs:
        loss, metrics = model.loss_fn(params, mb)
        grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
        if sync is not None:
            rows = next(iter(mb.values())).shape[0]
            grads = {n: sync(n, g, rows) for n, g in grads.items()}
        ms.append({k: v.detach() for k, v in metrics.items()})
        if num_microbatches == 1:
            return grads, ms[0]
        if acc is None:
            acc = {n: torch.zeros(g.shape, dtype=torch.float32,
                                  device=g.device) for n, g in grads.items()}
        for n, g in grads.items():
            acc[n] += g.float()
    grads = {n: precision.div_count(a, num_microbatches)
             for n, a in acc.items()}
    return grads, {k: precision.div_count(
        functools.reduce(torch.add, [m[k].float() for m in ms]),
        num_microbatches) for k in ms[0]}


def _finish(state, update, metrics):
    """The new state and metrics from ``opt.apply``'s result."""
    params, new_opt, stats = update
    return {"params": params, "opt": new_opt}, dict(metrics, **stats)


def batch_axes_of(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def rows_of(batch: Tensors, mesh) -> Tensors:
    """This rank's rows of every leaf of a global batch: the rows of its
    data coordinate (``np.unravel_index(rank, shape)``'s, over the pod and
    data axes), not of its raw rank."""
    return {k: batch_block(v, mesh, batch_axes_of(mesh))
            for k, v in batch.items()}


def sync_to_zero(g: torch.Tensor, storage: Layout, zero: Layout,
                 split: Tuple[str, ...], mesh) -> torch.Tensor:
    """This rank's share of a leaf's gradient (its storage block) -> the
    ZeRO block of the gradient summed over ``split``: over each split axis
    the ZeRO layout shards, a reduce-scatter onto its dim; over each other
    split axis, a sum; over an axis the ZeRO layout shards but the work
    did not split, this rank's slice.  The wire carries ``g``'s dtype."""
    for a in mesh.axis_names:
        if mesh.shape[a] == 1 or a in storage.mesh_axes_used():
            continue
        dims = [d for d in range(zero.ndim) if a in axis_names(zero.dims[d])]
        if a in split:
            g = (dist_mod.psum_scatter(g, mesh, a, dims[0]) if dims
                 else dist_mod.psum(g, mesh, a))
        elif dims:
            n, i = mesh.shape[a], mesh.coords[a]
            g = g.narrow(dims[0], i * (g.shape[dims[0]] // n),
                         g.shape[dims[0]] // n).contiguous()
    return g


def gspmd_train_step(model, adamw: Optional[opt.AdamWConfig] = None,
                     num_microbatches: int = 1) -> Callable:
    """The gspmd path: ``train_step(state, batch)`` differentiates the
    global batch and applies AdamW.  On one rank (a model without a mesh)
    that is all.  On the model's mesh each microbatch (consecutive rows of
    the global batch) splits over the batch axes, each leaf's gradient is
    synced onto its ZeRO block in the param dtype (:func:`sync_to_zero`),
    microbatches accumulate there in fp32, and AdamW runs ZeRO-1."""
    adamw = adamw or opt.AdamWConfig()
    mesh = getattr(model, "mesh", None)
    if mesh is None:
        def train_step(state, batch):
            grads, metrics = local_grads(model, state["params"], batch,
                                         num_microbatches)
            return _finish(state, opt.apply(adamw, state["opt"], grads,
                                            state["params"]), metrics)
        return train_step
    zero = opt.ZeroLayouts.of(model.param_specs(), mesh)

    def sync(name, g, rows):
        return sync_to_zero(g, zero.storage[name], zero.zero[name],
                            model.grad_split_axes(name, rows), mesh)

    def train_step(state, batch):
        grads, metrics = local_grads(model, state["params"], batch,
                                     num_microbatches, sync)
        return _finish(state, opt.apply(adamw, state["opt"], grads,
                                        state["params"], zero=zero), metrics)

    return train_step


def comms_train_step(model, adamw: Optional[opt.AdamWConfig] = None,
                     num_microbatches: int = 1, comms=None,
                     group: Optional[dist.ProcessGroup] = None,
                     mesh=None) -> Callable:
    """The data-parallel path: each rank differentiates its share of the
    batch, then ONE bucketed (optionally bf16/int8-compressed) sync per
    step runs over the mesh's batch axes (``comms.plan.sync_tree``, after
    the microbatch loop, its schedule resolved by the topology cost model
    when the plan says ``auto``), the metrics are averaged over the group
    as the reference's ``pmean`` does, and every rank applies AdamW to
    the same gradients."""
    from repro_torch.launch.mesh import make_host_mesh
    adamw = adamw or opt.AdamWConfig()
    comms = comms or comms_plan_mod.CommsPlan()
    n = dist.get_world_size(group)
    mesh = mesh if mesh is not None else make_host_mesh(group=group)

    def train_step(state, batch):
        rows = next(iter(batch.values())).shape[0]
        if rows % n:
            raise ValueError(f"a batch of {rows} rows does not split over "
                             f"{n} ranks")
        local = rows_of(batch, mesh)
        grads, metrics = local_grads(model, state["params"], local,
                                     num_microbatches)
        grads = comms_plan_mod.sync_tree(grads, comms, mesh,
                                         batch_axes_of(mesh))
        keys = sorted(metrics)
        vec = torch.stack([metrics[k].float() for k in keys])
        vec = schedules.pmean(vec, group)
        return _finish(state, opt.apply(adamw, state["opt"], grads,
                                        state["params"]),
                       dict(zip(keys, vec.unbind())))

    return train_step


def pipeline_train_step(model, mesh, adamw: Optional[opt.AdamWConfig] = None,
                        num_microbatches: Optional[int] = None,
                        pipeline=None, comms=None) -> Callable:
    """The pipeline path, the reference's ``_pipeline_train_step``:
    ``train_step(state, batch)`` on a DP x PP mesh.  Each rank holds its
    stage's slice of every stacked layer leaf (dim 0 over ``pipe``) and
    the edge leaves whole (``pipeline_param_specs``), runs its rows (its
    data coordinate's) through the schedule the
    :class:`~repro_torch.pipeline.PipelineSpec` names (``gpipe`` |
    ``1f1b``), and gets every leaf's fp32 gradient of its stage.  The
    gradients are averaged over the batch axes, the reference's ``pmean``
    reduced onto each leaf's ZeRO-1 block (:func:`sync_to_zero`'s
    reduce-scatter, the same rank-ordered sum, then the count's fl32
    reciprocal), or through the CommsPlan's schedules when ``comms`` is
    given (their block taken locally); the metrics are ``pmean``-ed;
    AdamW runs ZeRO-1 on the stage.  ``model`` is a model without a mesh
    (each stage runs its layers locally); every mesh axis but the batch
    axes and ``pipe`` must have size 1."""
    import dataclasses

    from repro_torch import pipeline as pipe_mod
    from repro_torch.core.planner import pipeline_spec_for
    adamw = adamw or opt.AdamWConfig()
    spec = pipeline or pipeline_spec_for(model.cfg, mesh,
                                         num_microbatches=num_microbatches)
    if spec is None:
        raise ValueError("the pipeline train step needs a 'pipe' mesh axis "
                         "or an explicit PipelineSpec")
    if num_microbatches is not None \
            and num_microbatches != spec.num_microbatches:
        spec = dataclasses.replace(spec, num_microbatches=num_microbatches)
    if mesh.shape.get(spec.axis, 1) != spec.n_stages:
        raise ValueError(
            f"PipelineSpec wants {spec.n_stages} stages but mesh axis "
            f"{spec.axis!r} has size {mesh.shape.get(spec.axis, 1)}")
    batch_axes = batch_axes_of(mesh)
    bad = {a: n for a, n in mesh.shape.items()
           if a not in batch_axes + (spec.axis,) and n > 1}
    if bad:
        raise ValueError(
            "pipeline train step is DP x PP: non-batch, non-pipe mesh "
            f"axes must have size 1, got {bad}")
    zero = opt.ZeroLayouts.of(pipe_mod.pipeline_param_specs(model, spec),
                              mesh)
    sched_fn = pipe_mod.SCHEDULE_FNS[spec.schedule]
    n_rows = math.prod(mesh.shape[a] for a in batch_axes)

    def train_step(state, batch):
        grads, metrics = sched_fn(model, spec, state["params"],
                                  rows_of(batch, mesh), mesh)
        if comms is not None:
            grads = comms_plan_mod.sync_tree(grads, comms, mesh, batch_axes)
            grads = {n: zero.to_zero(n, g) for n, g in grads.items()}
        else:
            grads = {n: sync_to_zero(g, zero.storage[n], zero.zero[n],
                                     batch_axes, mesh)
                     for n, g in grads.items()}
            if n_rows > 1:
                grads = {n: precision.div_count(g, n_rows)
                         for n, g in grads.items()}
        if n_rows > 1:
            keys = sorted(metrics)
            vec = precision.div_count(dist_mod.psum(
                torch.stack([metrics[k] for k in keys]), mesh, batch_axes),
                n_rows)
            metrics = dict(zip(keys, vec.unbind()))
        return _finish(state, opt.apply(adamw, state["opt"], grads,
                                        state["params"], zero=zero), metrics)

    return train_step
