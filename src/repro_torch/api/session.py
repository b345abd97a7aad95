"""The Session: the entry point that plans a train cell, initializes its
state on the device and steps it, ported from the reference's
``api/session.py``.

``Session(device=..., group=..., obs=..., mesh=..., hbm_gib=...)`` holds
the device, the process group (None: one rank, or the default group when
one is initialized), the telemetry (:mod:`repro_torch.obs`, the disabled
``NULL`` by default), the mesh over the group (``make_host_mesh``'s
(data=n, model=1) by default), the gradient-sync :attr:`topology`, the
per-device memory :attr:`budget` (the card's entry of
``core.memory.HBM_BUDGETS`` by its name, ``cpu`` on the CPU, or
``hbm_gib``), the persistent :attr:`state` registry held to that budget
and the layout table of its linalg surface (``tensors``;
:meth:`Session.tensor` makes a ``DistTensor`` there).
:meth:`Session.plan` resolves the config, the layout plan (``plan_for``
on the mesh), the microbatch count, the CommsPlan and the dispatch path,
and prices the cell with the memory model before anything is allocated:
a cell that does not fit raises :class:`~repro_torch.api.errors.
PlanMemoryError`.  :meth:`Session.init_state` makes the params and the
AdamW state resident on the device, each rank's blocks on a mesh with a
model axis or a gspmd path over several ranks (or :meth:`Session.put` a
restored one), and :meth:`Session.step` runs one train step on them in
place, the state never leaving the device.  The reference's telemetry
sites are here: the ``plan``, ``build_step`` and ``step`` /
``step_warmup`` spans (a step span closes after the card's work) and
:meth:`Session.publish_metrics`.

Not ported yet (ROADMAP queue 1, item 9): the compiled-artifact cache and
its gauges, ``dryrun``, ``serve`` and ``describe`` on the session.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs as obs_mod
from repro_torch.configs import get_config, scale_config
from repro_torch.core import memory as mem_mod
from repro_torch.core.device import resolve_device
from repro_torch.core.dtensor import DistTensor, TensorRegistry
from repro_torch.core.layout import Layout
from repro_torch.core.planner import (comms_plan_for, grad_sync_topology,
                                      plan_for, score_hybrid_candidates)
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import Model
from repro_torch.train import optimizer as opt
from repro_torch.train import step as step_mod

from .errors import PlanMemoryError
from .plan import ExecutablePlan, select_path
from .state import StateRegistry


def default_microbatches(cfg, global_batch: int, seq_len: int, n_ranks: int,
                         budget_bytes: float = 3.0 * 2**30) -> int:
    """Smallest power-of-two microbatch count keeping the rematerialized
    residual stream under ``budget_bytes`` per rank (the reference's
    ``configs.default_microbatches``)."""
    b_loc = max(1, global_batch // n_ranks)
    resid = cfg.n_layers * b_loc * seq_len * cfg.d_model * 2
    nmb = 1
    while resid / nmb > budget_bytes and nmb < b_loc:
        nmb *= 2
    return nmb


class Session:
    """One device, one process group, one persistent state registry.

    Lifecycle::

        sess = Session()                                  # the card
        plan = sess.plan("qwen2-0.5b", batch=4, seq=512)
        sess.init_state(plan, seed=0)             # params+opt on device
        for batch in data:
            metrics = sess.step(plan, batch)      # state stays resident
    """

    def __init__(self, device: Union[str, torch.device] = "cuda",
                 group: Optional[dist.ProcessGroup] = None,
                 obs: Optional["obs_mod.Obs"] = None, mesh=None,
                 tensors: Optional[TensorRegistry] = None, *,
                 hbm_gib: Optional[float] = None):
        self.device = resolve_device(device)
        if group is None and dist.is_initialized():
            group = dist.group.WORLD
        self.group = group
        self.n_ranks = dist.get_world_size(group) if group is not None else 1
        self.mesh = (mesh if mesh is not None
                     else mesh_mod.make_host_mesh(group=group))
        self.budget = mem_mod.budget_for(hbm_gib=hbm_gib, device=self.device)
        self.topology = grad_sync_topology(self.mesh)
        self.tensors = tensors if tensors is not None else TensorRegistry()
        # each rank's registry holds its own tensors: one device's budget
        self.state = StateRegistry(budget=self.budget, n_devices=1)
        self._steps: Dict[int, Any] = {}
        # spans and gauges flow through here; the NULL default keeps every
        # site a no-op (no timing, no synchronize) with telemetry off
        self.obs = obs if obs is not None else obs_mod.NULL

    def plan(self, arch, **kwargs) -> ExecutablePlan:
        """Plan one train cell under the ``plan`` span; see :meth:`_plan`
        for the keywords."""
        name = arch if isinstance(arch, str) else getattr(
            arch, "name", type(arch).__name__)
        with self.obs.span("plan", arch=name, plan_kind="train"):
            plan = self._plan(arch, **kwargs)
        if self.obs.enabled:
            self.obs.event(
                "plan_resolved", arch=plan.cfg.name, path=plan.path,
                microbatches=plan.num_microbatches,
                comms=(plan.comms.schedule if plan.comms is not None
                       else None), pp=1, ranks=plan.n_ranks)
        return plan

    def _plan(self, arch, *, batch: int, seq: int, comms="auto",
              adamw: Optional[opt.AdamWConfig] = None,
              microbatches: Optional[int] = None, scale_down: int = 1,
              model_kwargs=None, plan_kwargs=None,
              check_memory: bool = True, sweep: bool = False
              ) -> ExecutablePlan:
        """Plan one train cell (``batch`` is the global batch).

        The layout plan is :func:`~repro_torch.core.planner.plan_for` on
        the session's mesh (``plan_kwargs`` go to it).  ``comms``:
        ``"auto"`` attaches the cost model's :class:`CommsPlan` over the
        session's :attr:`topology` (``comms_plan_for``, which
        ``plan_for(...).comms`` equals) on a pure-DP mesh of a process group
        (every non-batch axis of size 1, as the reference's ``dp_only``),
        and otherwise selects the ``gspmd`` path, on one rank or on the
        mesh with the implicit gradient sync; ``"off"``/``None`` selects
        the ``gspmd`` path, and a ``CommsPlan`` is used as given.  The
        microbatch count defaults to the reference's rule, clamped to the
        rows of a data coordinate.

        The memory verdict is the reference's: the cell's per-stage
        footprints (``core.memory.footprints_for_mesh``) against
        :attr:`budget`.  ``check_memory`` (default) raises
        :class:`PlanMemoryError` for a cell that does not fit, with the
        sweep's per-candidate refusals when no factorization fits either;
        ``sweep=True`` always runs the sweep (``plan.scores``,
        ``plan.refused``) and raises when it refuses every candidate.
        The verdict runs before the model is built and before anything
        is allocated on the card."""
        cfg = get_config(arch) if isinstance(arch, str) else arch
        if scale_down > 1:
            cfg = scale_config(cfg, scale_down)
        mesh = self.mesh
        parallel = plan_for(cfg, mesh, **(plan_kwargs or {}))
        nb = math.prod(mesh.shape[a] for a in parallel.batch_axes) or 1
        if batch % nb:
            raise ValueError(f"a global batch of {batch} does not split "
                             f"over {nb} data ranks")
        nmb = (microbatches if microbatches is not None
               else default_microbatches(cfg, batch, seq, nb))
        nmb = max(1, min(nmb, batch // nb))
        if (batch // nb) % nmb:
            raise ValueError(f"{nmb} microbatches do not split a rank's "
                             f"{batch // nb} rows")
        comms_plan = None
        if comms == "auto":
            dp_only = all(n == 1 for a, n in mesh.shape.items()
                          if a not in parallel.batch_axes)
            if self.group is not None and dp_only:
                comms_plan = comms_plan_for(cfg, mesh, topo=self.topology)
        elif comms not in (None, "off"):
            comms_plan = comms
        path = select_path(mesh, comms=comms_plan)

        # the memory verdict, before anything is built or allocated
        moment_itemsize = (adamw.moment_dtype.itemsize
                           if adamw is not None else 4)
        footprints = tuple(mem_mod.footprints_for_mesh(
            cfg, mesh, global_batch=batch, seq_len=seq,
            num_microbatches=nmb, moment_itemsize=moment_itemsize))
        fits = all(f.fits(self.budget) for f in footprints)
        refused: dict = {}
        scores = None
        if sweep or (check_memory and not fits):
            scores, refused = score_hybrid_candidates(
                cfg, mesh.size, global_batch=batch, seq_len=seq,
                hbm_budget=self.budget, return_refused=True)
            if sweep and not scores:
                raise PlanMemoryError.all_refused(refused, self.budget,
                                                  mesh.size)
        if check_memory and not fits:
            raise PlanMemoryError.for_cell(
                footprints, self.budget,
                refused=refused if not scores else None)

        # the gspmd path runs the one-rank model on a mesh of one rank
        on_mesh = path == "gspmd" and mesh.size > 1
        model = Model(cfg, device=self.device,
                      mesh=mesh if on_mesh else None,
                      plan=parallel if on_mesh else None,
                      **(model_kwargs or {}))
        return ExecutablePlan(cfg=cfg, model=model, path=path,
                              global_batch=batch, seq_len=seq,
                              num_microbatches=nmb, adamw=adamw,
                              comms=comms_plan, n_ranks=self.n_ranks,
                              mesh=mesh, parallel=parallel,
                              budget=self.budget, footprints=footprints,
                              refused=refused, scores=scores)

    def train_step(self, plan: ExecutablePlan) -> Callable:
        """The ``train_step(state, batch)`` of a plan (built once; the
        plan is kept beside it, so its id is not reused)."""
        key = id(plan)
        if key not in self._steps:
            with self.obs.span("build_step", path=plan.path,
                               arch=plan.cfg.name):
                self._steps[key] = (plan, step_mod.dispatch_train_step(
                    plan.model, adamw=plan.adamw,
                    num_microbatches=plan.num_microbatches,
                    comms=plan.comms, group=self.group, path=plan.path,
                    mesh=self.mesh))
        return self._steps[key][1]

    def init_state(self, plan: ExecutablePlan, *, seed: int = 0,
                   name: str = "train_state",
                   params: Optional[Dict[str, torch.Tensor]] = None):
        """Initialize the plan's params (from ``seed``, the same on every
        rank, or the given global ``params`` copied to the device) and
        their AdamW state, and keep them resident under ``name``.  On a
        mesh each rank keeps its blocks: of the params in their storage
        layouts, of the state on their ZeRO blocks."""
        model = plan.model
        if params is None:
            params = model.init(seed)
        else:
            params = model.shard({k: v.to(self.device, copy=True)
                                  for k, v in params.items()})
        adamw = plan.adamw or opt.AdamWConfig()
        state = {"params": params, "opt": opt.init_state(
            params, adamw, zero=self.zero_layouts(plan))}
        return self.put(name, state, kind="train_state")

    def zero_layouts(self, plan: ExecutablePlan
                     ) -> Optional[opt.ZeroLayouts]:
        """The plan's ZeRO-1 layouts (None for a model without a mesh)."""
        model = plan.model
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
        metrics as 0-d tensors on the device."""
        batch = {k: (torch.from_numpy(np.asarray(v)) if not
                     isinstance(v, torch.Tensor) else v)
                 .to(self.device, torch.long) for k, v in batch.items()}
        rows = next(iter(batch.values())).shape[0]
        if rows != plan.global_batch:
            raise ValueError(f"batch of {rows} rows for a plan of "
                             f"{plan.global_batch}")
        warm = id(plan) in self._steps
        fn = self.train_step(plan)
        with self.obs.span("step" if warm else "step_warmup",
                           path=plan.path) as sp:
            state, metrics = fn(self.state.get(name), batch)
            sp.block(metrics)
        self.state.update(name, state)
        if self.obs.enabled:
            self.publish_metrics()
        return metrics

    def publish_metrics(self) -> None:
        """Mirror session-owned stats into the obs registry: the state
        registry's resident bytes and entries (the reference's opcache
        gauges wait for the compiled-artifact cache, ROADMAP queue 1,
        item 9)."""
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


def _to_device(value, device: torch.device):
    """``value`` with every tensor on ``device`` (tensors already there are
    kept, not copied)."""
    if isinstance(value, torch.Tensor):
        return value.detach().to(device)
    if isinstance(value, dict):
        return {k: _to_device(v, device) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_to_device(v, device) for v in value)
    return value
