"""The Session: the entry point that plans a cell, keeps its state on
the device and steps, serves and dry-runs it, ported from the
reference's ``api/session.py``.

``Session(device=..., group=..., obs=..., mesh=..., pp=..., hbm_gib=...,
opcache=..., state=..., tensors=...)`` holds the device, the process
group (None: one rank, or the default group when one is initialized),
the telemetry (:mod:`repro_torch.obs`, the disabled ``NULL`` by
default), the mesh over the group (``make_host_mesh(pp)``'s (data=n,
model=1), or (data=n/pp, pipe=pp, model=1), by default), the
gradient-sync :attr:`topology`, the
per-device memory :attr:`budget` (the card's entry of
``core.memory.HBM_BUDGETS`` by its name, ``cpu`` on the CPU, or
``hbm_gib``), the compiled-artifact cache :attr:`opcache` (an
:class:`~repro_torch.core.opcache.OpCache`: the port runs eagerly, so an
entry is a step built once, and its "compile" is that build), the
persistent :attr:`state` registry held to that budget and the layout
table of its linalg surface (``tensors``; :meth:`Session.tensor` makes a
``DistTensor`` there).

:meth:`Session.plan` plans one (config, shape) cell: ``shape=`` (a
``SHAPES`` name or a ``ShapeConfig``) or ``batch=``/``seq=`` with
``kind=`` (``train``, ``prefill``, ``decode``, ``long_decode``).  A train
cell resolves the layout plan (``plan_for`` on the mesh), the microbatch
count, the pipeline spec on a mesh with a ``pipe`` axis, the CommsPlan
and the dispatch path (:func:`dispatch_train_step`), and is priced with the
memory model before anything is allocated: one that does not fit raises
:class:`~repro_torch.api.errors.PlanMemoryError`.  A serve cell's path
is its kind, and it gets no footprint verdict.  :meth:`Session.init_state`
makes the params and the AdamW state resident (each rank's blocks on a
mesh), :meth:`Session.step` runs the step, built through the op cache,
on them in place; :meth:`Session.serve` builds an engine on params kept
under ``{name}/params`` (a second engine of that name reuses the same
tensors: no re-init, no host-to-device copy) with its cache in the
registry; :meth:`Session.dryrun` traces the cell's step for this rank on
fake tensors (:mod:`repro_torch.core.dry`) without running it;
:meth:`Session.describe` reports the session, the registry and the
cache.  The reference's telemetry sites are here: the ``plan``,
``build_step``, ``lower`` and ``step`` / ``step_warmup`` spans (a step
span closes after the card's work) and :meth:`Session.publish_metrics`.
:meth:`Session.snapshot_state` and :meth:`Session.restore_state` keep
and put back a host copy of a persistent tree (the resilient loop's
rollback point; a restore re-blocks global arrays onto the session's
mesh), and :attr:`Session.last_step_compiled` says whether the last step
built its op-cache entry.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs as obs_mod
from repro_torch.checkpoint.manager import blocks_of
from repro_torch.configs import (SHAPES, ShapeConfig, default_microbatches,
                                 get_config, scale_config)
from repro_torch.core import memory as mem_mod
from repro_torch.core.device import host_copy, resolve_device
from repro_torch.core.dtensor import DistTensor, TensorRegistry
from repro_torch.core.layout import Layout
from repro_torch.core.opcache import OpCache
from repro_torch.core.planner import (comms_plan_for, grad_sync_topology,
                                      plan_for, score_hybrid_candidates)
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import Model
from repro_torch.train import optimizer as opt
from repro_torch.train import step as step_mod

from .errors import PlanMemoryError
from .plan import ExecutablePlan, select_path
from .state import StateRegistry


def dispatch_train_step(model, mesh, *, adamw=None,
                        num_microbatches: Optional[int] = None,
                        comms=None, pipeline=None,
                        path: Optional[str] = None, group=None) -> Callable:
    """The train-step dispatcher, the reference's: one signature, three
    paths.  Selects (or is told) the path by the capability matrix
    (:func:`select_path`) and returns ``train_step(state, batch) ->
    (state, metrics)``: ``gspmd`` on the model (one rank, or the model's
    mesh), ``comms`` over ``mesh``'s batch axes (``group``: its process
    group), ``pipeline`` on ``mesh``'s ``pipe`` axis.
    :meth:`Session.train_step` builds it through the session's op
    cache."""
    if path is None:
        path = select_path(mesh, comms=comms, pipeline=pipeline)
    if path == "pipeline":
        return step_mod.pipeline_train_step(
            model, mesh, adamw, num_microbatches=num_microbatches,
            pipeline=pipeline, comms=comms)
    if path == "comms":
        return step_mod.comms_train_step(model, adamw, num_microbatches or 1,
                                         comms, group, mesh)
    if path == "gspmd":
        return step_mod.gspmd_train_step(model, adamw, num_microbatches or 1)
    raise ValueError(f"unknown train-step path {path!r}; expected one of "
                     "gspmd | comms | pipeline")


class Session:
    """One device, one process group, one persistent state registry.

    Lifecycle::

        sess = Session()                                  # the card
        plan = sess.plan("qwen2-0.5b", batch=4, seq=512)
        sess.init_state(plan, seed=0)             # params+opt on device
        for batch in data:
            metrics = sess.step(plan, batch)      # state stays resident

        serve = sess.plan("qwen2-0.5b", batch=8, seq=1024, kind="decode")
        engine = sess.serve(serve, batch_slots=8, max_seq=1024)
    """

    def __init__(self, device: Union[str, torch.device] = "cuda",
                 group: Optional[dist.ProcessGroup] = None,
                 obs: Optional["obs_mod.Obs"] = None, mesh=None,
                 tensors: Optional[TensorRegistry] = None, *,
                 pp: int = 1, hbm_gib: Optional[float] = None,
                 opcache: Optional[OpCache] = None,
                 state: Optional[StateRegistry] = None):
        self.device = resolve_device(device)
        if group is None and dist.is_initialized():
            group = dist.group.WORLD
        self.group = group
        self.n_ranks = dist.get_world_size(group) if group is not None else 1
        self.mesh = (mesh if mesh is not None
                     else mesh_mod.make_host_mesh(pp, group=group))
        self.budget = mem_mod.budget_for(hbm_gib=hbm_gib, device=self.device)
        self.topology = grad_sync_topology(self.mesh)
        self.opcache = opcache if opcache is not None else OpCache("session")
        self.tensors = tensors if tensors is not None else TensorRegistry()
        # each rank's registry holds its own tensors: one device's budget
        self.state = state if state is not None else StateRegistry(
            budget=self.budget, n_devices=1)
        # spans and gauges flow through here; the NULL default keeps every
        # site a no-op (no timing, no synchronize) with telemetry off
        self.obs = obs if obs is not None else obs_mod.NULL
        # whether the last step built its op-cache entry (the reference's
        # compile-bearing step): the resilient loop's watchdog skips it
        self.last_step_compiled = False

    def plan(self, arch, **kwargs) -> ExecutablePlan:
        """Plan one cell under the ``plan`` span; see :meth:`_plan` for
        the keywords."""
        name = arch if isinstance(arch, str) else getattr(
            arch, "name", type(arch).__name__)
        with self.obs.span("plan", arch=name,
                           plan_kind=kwargs.get("kind", "train")):
            plan = self._plan(arch, **kwargs)
        if self.obs.enabled:
            self.obs.event(
                "plan_resolved", arch=plan.cfg.name, shape=plan.shape.name,
                path=plan.path, microbatches=plan.num_microbatches,
                schedule=plan.schedule,
                comms=(plan.comms.schedule if plan.comms is not None
                       else None),
                pp=(plan.pipeline.n_stages if plan.pipeline is not None
                    else 1), ranks=plan.n_ranks)
        return plan

    def _plan(self, arch, *, shape: Union[str, ShapeConfig, None] = None,
              batch: Optional[int] = None, seq: Optional[int] = None,
              kind: str = "train", comms="auto",
              adamw: Optional[opt.AdamWConfig] = None,
              microbatches: Optional[int] = None, pp_schedule: str = "gpipe",
              scale_down: int = 1,
              model_kwargs=None, plan_kwargs=None,
              check_memory: bool = True, sweep: bool = False
              ) -> ExecutablePlan:
        """Plan one cell: ``shape`` (a ``SHAPES`` name or a
        ``ShapeConfig``), or ``batch`` (the global batch) and ``seq`` with
        ``kind``.

        The layout plan is :func:`~repro_torch.core.planner.plan_for` on
        the session's mesh (``plan_kwargs`` go to it).  For a train cell,
        ``comms``: ``"auto"`` attaches the cost model's :class:`CommsPlan`
        over the session's :attr:`topology` (``comms_plan_for``, which
        ``plan_for(...).comms`` equals) on a pure-DP mesh of a process
        group (every non-batch axis of size 1, as the reference's
        ``dp_only``), and otherwise selects the ``gspmd`` path, on one
        rank or on the mesh with the implicit gradient sync;
        ``"off"``/``None`` selects the ``gspmd`` path, and a ``CommsPlan``
        is used as given (on a DP x PP mesh too, as the reference's).  The
        microbatch count defaults to the reference's rule, clamped to the
        rows of a data coordinate.  On a mesh with a ``pipe`` axis the
        plan's :class:`~repro_torch.pipeline.PipelineSpec` takes
        ``pp_schedule`` (``gpipe`` | ``1f1b``) and that count, lowered
        until it divides a data coordinate's rows, as the reference does,
        and the ``pipeline`` path runs every stage's layers on a model
        without a mesh.  A serve cell's path is its kind.

        The memory verdict (train cells) is the reference's: the cell's
        per-stage footprints (``core.memory.footprints_for_mesh``, every
        pipeline stage priced under its schedule) against :attr:`budget`.
        ``check_memory`` (default) raises
        :class:`PlanMemoryError` for a cell that does not fit, with the
        sweep's per-candidate refusals when no factorization fits either;
        ``sweep=True`` always runs the sweep (``plan.scores``,
        ``plan.refused``) and raises when it refuses every candidate.
        The verdict runs before the model is built and before anything
        is allocated on the card."""
        cfg = get_config(arch) if isinstance(arch, str) else arch
        if scale_down > 1:
            cfg = scale_config(cfg, scale_down)
        if isinstance(shape, str):
            shape = SHAPES[shape]
        if shape is None:
            if batch is None or seq is None:
                raise ValueError("Session.plan needs shape= or both batch= "
                                 "and seq=")
            shape = ShapeConfig(f"custom_{kind}", seq, batch, kind)
        mesh = self.mesh
        parallel = plan_for(cfg, mesh, **(plan_kwargs or {}))
        train = shape.kind == "train"
        nmb, comms_plan, spec = 1, None, None
        footprints: tuple = ()
        refused: dict = {}
        scores = None
        if train:
            batch = shape.global_batch
            nb = math.prod(mesh.shape[a] for a in parallel.batch_axes) or 1
            if batch % nb:
                raise ValueError(f"a global batch of {batch} does not split "
                                 f"over {nb} data ranks")
            nmb = (microbatches if microbatches is not None
                   else default_microbatches(cfg, shape, mesh, parallel))
            nmb = max(1, min(nmb, batch // nb))
            spec = parallel.pipeline
            if spec is not None:
                # microbatches split a data coordinate's rows on the pipe
                while (batch // nb) % nmb:
                    nmb -= 1
                spec = dataclasses.replace(spec, schedule=pp_schedule,
                                           num_microbatches=nmb)
                parallel = dataclasses.replace(parallel, pipeline=spec)
            if (batch // nb) % nmb:
                raise ValueError(f"{nmb} microbatches do not split a rank's "
                                 f"{batch // nb} rows")
            if comms == "auto":
                dp_only = all(n == 1 for a, n in mesh.shape.items()
                              if a not in parallel.batch_axes + ("pipe",))
                if self.group is not None and dp_only:
                    comms_plan = comms_plan_for(cfg, mesh, topo=self.topology)
            elif comms not in (None, "off"):
                comms_plan = comms
            footprints, refused, scores = self._verdict(
                cfg, shape, nmb, adamw, check_memory, sweep, pp_schedule)
        path = (select_path(mesh, comms=comms_plan, pipeline=spec) if train
                else shape.kind)

        # the gspmd path and a serve cell run the model on the mesh of
        # several ranks; the comms and pipeline paths run it on each
        # rank's own rows
        on_mesh = mesh.size > 1 and path not in ("comms", "pipeline")
        model = Model(cfg, device=self.device,
                      mesh=mesh if on_mesh else None,
                      plan=parallel if on_mesh else None,
                      **(model_kwargs or {}))
        return ExecutablePlan(cfg=cfg, model=model, path=path, shape=shape,
                              num_microbatches=nmb, adamw=adamw,
                              comms=comms_plan, n_ranks=self.n_ranks,
                              mesh=mesh, parallel=parallel,
                              schedule=pp_schedule, pipeline=spec,
                              budget=self.budget, footprints=footprints,
                              refused=refused, scores=scores)

    def _verdict(self, cfg, shape, nmb, adamw, check_memory, sweep,
                 schedule="gpipe"):
        """A train cell's memory verdict: (footprints, refused, scores),
        raising :class:`PlanMemoryError` as :meth:`_plan` says."""
        mesh = self.mesh
        moment_itemsize = (adamw.moment_dtype.itemsize
                           if adamw is not None else 4)
        footprints = tuple(mem_mod.footprints_for_mesh(
            cfg, mesh, global_batch=shape.global_batch,
            seq_len=shape.seq_len, num_microbatches=nmb, schedule=schedule,
            moment_itemsize=moment_itemsize))
        fits = all(f.fits(self.budget) for f in footprints)
        refused: dict = {}
        scores = None
        if sweep or (check_memory and not fits):
            scores, refused = score_hybrid_candidates(
                cfg, mesh.size, global_batch=shape.global_batch,
                seq_len=shape.seq_len, schedule=schedule,
                hbm_budget=self.budget, return_refused=True)
            if sweep and not scores:
                raise PlanMemoryError.all_refused(refused, self.budget,
                                                  mesh.size)
        if check_memory and not fits:
            raise PlanMemoryError.for_cell(
                footprints, self.budget,
                refused=refused if not scores else None)
        return footprints, refused, scores

    # ------------------------------------------------------------------
    # the train-step dispatcher, through the compiled-artifact cache
    # ------------------------------------------------------------------
    def _step_key(self, plan: ExecutablePlan, **extra):
        return self.opcache.key_for(
            "train_step", (),
            mesh_shape=tuple(self.mesh.shape.items()),
            model=id(plan.model), path=plan.path,
            nmb=plan.num_microbatches, schedule=plan.schedule,
            adamw=id(plan.adamw), comms=repr(plan.comms), **extra)

    def train_step(self, plan: ExecutablePlan, **extra) -> Callable:
        """The ``train_step(state, batch)`` of a train plan, built once
        under the reference's key in :attr:`opcache` (repeated calls are
        cache hits; the entry keeps the model alive, so its id is not
        reused)."""
        if plan.kind != "train":
            raise ValueError(
                f"train_step needs a train plan, got kind={plan.kind!r}")

        def build():
            with self.obs.span("build_step", path=plan.path,
                               arch=plan.cfg.name):
                return dispatch_train_step(
                    plan.model, self.mesh, adamw=plan.adamw,
                    num_microbatches=plan.num_microbatches,
                    comms=plan.comms, pipeline=plan.pipeline,
                    path=plan.path, group=self.group)

        return self.opcache.get_or_build(self._step_key(plan, **extra),
                                         "train_step", build)

    def init_state(self, plan: ExecutablePlan, *, seed: int = 0,
                   name: str = "train_state",
                   params: Optional[Dict[str, torch.Tensor]] = None):
        """Initialize the plan's params (from ``seed``, the same on every
        rank, or the given global ``params`` copied to the device) and
        their AdamW state, and keep them resident under ``name``.  On a
        mesh each rank keeps its blocks: of the params in their storage
        layouts, of the state on their ZeRO blocks."""
        return self.put(name, self._new_state(plan, seed, params),
                        kind="train_state")

    def _new_state(self, plan: ExecutablePlan, seed: int, params=None):
        model = plan.model
        if plan.path == "pipeline":
            from repro_torch.pipeline import pipeline_init_state
            return pipeline_init_state(
                model, self.mesh, plan.pipeline, seed,
                adamw=plan.adamw, params=None if params is None else {
                    k: v.to(self.device, copy=True)
                    for k, v in params.items()})
        if params is None:
            params = model.init(seed)
        else:
            params = model.shard({k: v.to(self.device, copy=True)
                                  for k, v in params.items()})
        adamw = plan.adamw or opt.AdamWConfig()
        state = {"params": params, "opt": opt.init_state(
            params, adamw, zero=self.zero_layouts(plan))}
        for p in state["params"].values():
            p.requires_grad_(True)
        return state

    def zero_layouts(self, plan: ExecutablePlan
                     ) -> Optional[opt.ZeroLayouts]:
        """The plan's ZeRO-1 layouts (None for a model without a mesh off
        the pipeline path)."""
        model = plan.model
        if plan.path == "pipeline":
            from repro_torch.pipeline import pipeline_param_specs
            return opt.ZeroLayouts.of(
                pipeline_param_specs(model, plan.pipeline), self.mesh)
        return (None if model.mesh is None
                else opt.ZeroLayouts.of(model.param_specs(), model.mesh))

    def state_layouts(self, plan: ExecutablePlan) -> Dict[str, Any]:
        """The layout of every leaf of the plan's train state on the mesh
        (params in storage, the optimizer state on ZeRO blocks), for
        :meth:`CheckpointManager.save` and ``restore``; None without a
        mesh."""
        zero = self.zero_layouts(plan)
        if zero is None:
            return None
        return {"params": dict(zero.storage),
                "opt": {"step": Layout(()), "mu": dict(zero.zero),
                        "nu": dict(zero.zero), "master": dict(zero.zero)}}

    def step(self, plan: ExecutablePlan, batch, *,
             name: str = "train_state") -> Dict[str, torch.Tensor]:
        """One train step on the resident state with the global ``batch``
        (numpy arrays or tensors ``{"tokens", "labels"}``).  Returns the
        metrics as 0-d tensors on the device.  A vlm batch's
        ``vision_embeds`` (B, n_vision, D) go to the device in their own
        floating dtype; the model casts them to bf16."""
        batch = {k: _batch_leaf(v, self.device) for k, v in batch.items()}
        rows = next(iter(batch.values())).shape[0]
        if rows != plan.global_batch:
            raise ValueError(f"batch of {rows} rows for a plan of "
                             f"{plan.global_batch}")
        warm = self._step_key(plan) in self.opcache
        fn = self.train_step(plan)
        with self.obs.span("step" if warm else "step_warmup",
                           path=plan.path) as sp:
            state, metrics = fn(self.state.get(name), batch)
            sp.block(metrics)
        self.last_step_compiled = not warm
        self.state.update(name, state)
        if self.obs.enabled:
            self._publish_state()
        return metrics

    def publish_metrics(self) -> None:
        """Mirror session-owned stats into the obs registry: per-op
        compiled-artifact cache hit/miss/compile counts and the persistent
        state registry's resident bytes and entries."""
        for op, st in self.opcache.stats().items():
            self.obs.gauge(f"opcache.{op}.hits").set(st.hits)
            self.obs.gauge(f"opcache.{op}.misses").set(st.misses)
            self.obs.gauge(f"opcache.{op}.compiles").set(st.compiles)
        self._publish_state()

    def _publish_state(self) -> None:
        """The registry's gauges, which :meth:`step` refreshes after every
        step (the reference's step publishes the cache's too; here
        :meth:`publish_metrics` does, when the caller asks)."""
        self.obs.gauge("state.resident_bytes").set(self.state.total_bytes())
        self.obs.gauge("state.entries").set(len(self.state))

    def put(self, name: str, value, kind: str = "state"):
        """Make a tree of tensors persistent under ``name``, accounted
        against the session's budget (a put past it raises
        :class:`PlanMemoryError`).  A ``"train_state"`` (``{"params",
        "opt"}``, e.g. restored from a checkpoint) has its params moved
        to the session's device and marked to take gradients, as
        :meth:`init_state` leaves them."""
        if kind == "train_state":
            value = _to_device(value, self.device)
            for p in value["params"].values():
                p.requires_grad_(True)
        self.state.put(name, value, kind=kind)
        return value

    def get(self, name: str):
        return self.state.get(name)

    def tensor(self, data, layout: Optional[Layout] = None, *,
               name: Optional[str] = None, **kw) -> DistTensor:
        """A :class:`DistTensor` on the session's mesh: this rank's block
        of the global ``data`` (a tensor or array, moved to the session's
        device), registered in ``self.tensors`` so that the tensors
        derived from it (relayouts, products) land there too."""
        data = torch.as_tensor(data, device=self.device)
        if layout is None:
            layout = Layout.replicated(data.dim())
        return DistTensor.shard(data, layout, self.mesh, name=name,
                                registry=self.tensors, **kw)

    def evict(self, name: str):
        return self.state.evict(name)

    # ------------------------------------------------------------------
    # resilience: host snapshots and rollback
    # ------------------------------------------------------------------
    def snapshot_state(self, name: str = "train_state"):
        """A host copy of a persistent tree (CPU tensors; on a mesh, this
        rank's blocks), the rollback point
        :class:`repro_torch.train.resilience.ResilientStepLoop` keeps
        between checkpoints.  Every leaf is cloned, on the CPU too: the
        step updates the state in place, so a snapshot that shared its
        storage would follow the state and make a rollback a no-op.  On
        the card the copy is pinned (:func:`host_copy`)."""
        snap = _map_tensors(host_copy, self.state.get(name))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return snap

    def restore_state(self, snapshot, *, mesh=None, layouts=None,
                      name: str = "train_state"):
        """Put a host snapshot back on the session's device (copied, so
        the snapshot stays a rollback point) and refresh the registry
        entry.  Given a ``mesh`` and ``layouts`` (a tree of the snapshot's
        structure, a :class:`Layout` per leaf), the snapshot holds global
        arrays and each rank keeps its block: the re-shard onto another
        mesh that ``CheckpointManager.restore(mesh=, layouts=)`` takes.
        The params are marked to take gradients, as :meth:`init_state`
        leaves them."""
        if mesh is not None:
            snapshot = blocks_of(snapshot, mesh, layouts)
        value = _map_tensors(
            lambda x: x.detach().to(self.device, copy=True), snapshot)
        if isinstance(value, dict) and "params" in value:
            for p in value["params"].values():
                p.requires_grad_(True)
        if name in self.state:
            self.state.update(name, value)
        else:
            self.state.put(name, value, kind="train_state")
        return value

    # ------------------------------------------------------------------
    # dryrun: trace the dispatched step on fake tensors
    # ------------------------------------------------------------------
    def dryrun(self, plan: ExecutablePlan, *, seed: int = 0):
        """Trace (not run) the cell's step for this rank ->
        ``(trace, meta)``, a :class:`repro_torch.core.dry.Trace`: the
        step's peak of live bytes, FLOPs, bytes accessed and collectives.

        Train cells trace the SAME dispatched train step
        :meth:`train_step` builds, through the same op cache, on fake
        params, optimizer state and batch (``FakeTensorMode``: nothing is
        allocated).  Serve cells of the dense family trace the reference's
        ``prefill_step`` (``Model.prefill`` over the cell's prompts) or
        ``serve_step`` (one ``Model.decode_step`` against a cache of the
        cell's length) on fake params and cache; the other families'
        raise, naming what ROADMAP queue 1, item 13 still waits for.  On a
        mesh the session's group should be torch's ``fake`` backend
        (``launch/dryrun.py``), so that the collectives return at once;
        their bytes are counted all the same."""
        from repro_torch.core import dry

        cfg, shape = plan.cfg, plan.shape
        if shape.kind != "train":
            return self._dryrun_serve(plan, seed)
        specs, _ = plan.batch_specs()
        with dry.fake_mode():
            batch = {k: torch.zeros(v.shape, dtype=(
                         v.dtype if v.dtype.is_floating_point
                         else torch.long), device=self.device)
                     for k, v in specs.items()}
            args = (self._new_state(plan, seed), batch)
            fn = self.train_step(plan, sharded=True)
            meta = {"step": "train_step", "path": plan.path,
                    "microbatches": plan.num_microbatches,
                    "pp": self.mesh.shape.get("pipe", 1),
                    "moment_itemsize": (plan.adamw.moment_dtype.itemsize
                                        if plan.adamw else 4)}
            with self.obs.span("lower", step=meta["step"], arch=cfg.name,
                               shape=shape.name):
                with dry.traced(args) as trace:
                    fn(*args)
        meta.update(arch=cfg.name, shape=shape.name, plan={
            "attn_mode": plan.parallel.attn_mode,
            "fsdp": plan.parallel.fsdp,
            "seq_parallel_residual": plan.parallel.seq_parallel_residual,
            "batch_axes": list(plan.parallel.batch_axes)})
        return trace, meta

    def _dryrun_serve(self, plan: ExecutablePlan, seed: int):
        """:meth:`dryrun` of a serve cell: the prefill over the cell's
        prompts, or one decode step of its batch at the cache's last
        position; the step's state (params, and the cache for a decode)
        counts as live from the start."""
        from repro_torch.core import dry

        from repro_torch.models.transformer import MESH_SERVING_WAITS

        cfg, shape, model = plan.cfg, plan.shape, plan.model
        if cfg.family != "dense" or model._windowed():
            raise NotImplementedError(
                f"dryrun of a {shape.kind!r} cell of {cfg.name}: the port "
                "traces the dense family's serve cells; the rest waits for "
                f"ROADMAP queue 1, item 13: {MESH_SERVING_WAITS}")
        B, S = shape.global_batch, shape.seq_len
        decode = shape.is_decode
        with dry.fake_mode(), torch.no_grad():
            params = model.init(seed)
            if decode:
                cache = model.init_cache(B, S)
                tokens = torch.zeros((B, 1), dtype=torch.long,
                                     device=self.device)
                pos = torch.full((B,), S - 1, dtype=torch.long,
                                 device=self.device)
                args = (params, cache)
                meta = {"step": "serve_step", "path": "serve"}
            else:
                tokens = torch.zeros((B, S), dtype=torch.long,
                                     device=self.device)
                args = (params,)
                meta = {"step": "prefill_step", "path": "serve"}
            with self.obs.span("lower", step=meta["step"], arch=cfg.name,
                               shape=shape.name):
                with dry.traced(args) as trace:
                    if decode:
                        model.decode_step(params, cache, tokens, pos)
                    else:
                        _, cache = model.prefill(params, tokens)
            # this rank's K/V: the cache the step reads, or the prefill's
            meta["kv_cache_bytes"] = sum(t.numel() * t.element_size()
                                         for t in cache.values())
        meta.update(arch=cfg.name, shape=shape.name, plan={
            "attn_mode": plan.parallel.attn_mode,
            "fsdp": plan.parallel.fsdp,
            "seq_parallel_residual": plan.parallel.seq_parallel_residual,
            "batch_axes": list(plan.parallel.batch_axes)})
        return trace, meta

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------
    def serve(self, plan: ExecutablePlan, *, batch_slots: int,
              max_seq: int, temperature: float = 0.0, seed: int = 0,
              name: str = "serve", paged: bool = False,
              page_size: int = 64, scheduler: str = "static",
              num_pages: Optional[int] = None, prefill_chunk: int = 32,
              policy: str = "fifo"):
        """Build a serving engine on the session's persistent state.

        Params live in the state registry under ``{name}/params`` (reused
        across engines: restarting a server never re-initializes or
        re-uploads weights); the engine's prefill/decode steps come from
        the session's compiled-artifact cache.

        On a mesh the engine serves on it: each rank holds its blocks of
        the params and its shard of the KV cache or page pool, and every
        rank runs the same ticks (the dense family; the others raise,
        naming ROADMAP queue 1, item 13).

        ``scheduler="static"`` (default) builds the fixed-slot
        :class:`~repro_torch.serve.Engine` with its KV cache registered
        under ``{name}/kv_cache``; ``paged=True`` allocates that cache as
        a pool of ``page_size`` pages behind an indices table and decodes
        through the paged attention kernel (plain-attention families
        only).

        ``scheduler="continuous"`` builds the continuous-batching
        :class:`~repro_torch.serve.ContinuousEngine`: a block-paged KV pool
        registered under ``{name}/kv_pool`` (footprint-accounted: an
        over-budget pool is refused with a :class:`PlanMemoryError` before
        it is allocated), per-tick admission governed by the block
        manager, ``prefill_chunk``-token prefill chunks interleaved with
        decode, and preempt-and-requeue on pool exhaustion.
        ``num_pages`` overrides the pool size (default: full static
        capacity clamped to the budget); ``policy`` is the queue order
        (``fifo`` | ``priority``).
        """
        from repro_torch.serve import ContinuousEngine, Engine

        model = plan.model
        pname = f"{name}/params"
        if pname in self.state:
            params = self.state.get(pname)
            # the registry key is caller-chosen: refuse to hand one
            # model's weights to a different architecture/scale
            want = {k: (spec.shape if model.mesh is None
                        else spec.layout.local_shape(spec.shape, model.mesh))
                    for k, spec in model.param_specs().items()}
            same = (set(params) == set(want)
                    and all(tuple(params[k].shape) == tuple(want[k])
                            for k in want))
            if not same:
                raise ValueError(
                    f"persistent params {pname!r} were initialized for a "
                    f"different model than {plan.cfg.name!r} (pytree or "
                    f"shapes differ); evict them or serve under another "
                    f"name=")
        else:
            params = model.init(seed)
            self.state.put(pname, params, kind="params")
        if scheduler == "continuous":
            return ContinuousEngine(
                model, params, batch_slots, max_seq,
                temperature=temperature, seed=seed, opcache=self.opcache,
                registry=self.state, cache_key=f"{name}/kv_pool",
                obs=self.obs, page_size=page_size, num_pages=num_pages,
                prefill_chunk=prefill_chunk, policy=policy)
        if scheduler != "static":
            raise ValueError(f"scheduler={scheduler!r}; expected "
                             "static | continuous")
        return Engine(model, params, batch_slots, max_seq,
                      temperature=temperature, seed=seed,
                      opcache=self.opcache, registry=self.state,
                      cache_key=f"{name}/kv_cache", obs=self.obs,
                      paged=paged, page_size=page_size,
                      prefill_chunk=prefill_chunk)

    # ------------------------------------------------------------------
    def describe(self) -> str:
        lines = [f"Session(mesh={dict(self.mesh.shape)}, "
                 f"budget={self.budget.describe()})",
                 self.state.report()]
        stats = self.opcache.stats()
        if stats:
            lines.append("compiled-artifact cache: " + ", ".join(
                f"{op}: {st.compiles} compiles / {st.hits} hits"
                for op, st in sorted(stats.items())))
        return "\n".join(lines)


def _batch_leaf(v, device: torch.device) -> torch.Tensor:
    """One leaf of a train batch on ``device``: token ids and labels as
    int64, a floating leaf (a vlm's ``vision_embeds``) in its dtype."""
    t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
    return t.to(device) if t.is_floating_point() else t.to(device, torch.long)


def _map_tensors(fn, value):
    """``value`` with ``fn`` applied to every tensor of its nested dicts,
    lists and tuples."""
    if isinstance(value, torch.Tensor):
        return fn(value)
    if isinstance(value, dict):
        return {k: _map_tensors(fn, v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_map_tensors(fn, v) for v in value)
    return value


def _to_device(value, device: torch.device):
    """``value`` with every tensor on ``device`` (tensors already there are
    kept, not copied)."""
    return _map_tensors(lambda x: x.detach().to(device), value)
