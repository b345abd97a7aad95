"""Dry run of the production meshes: ``python -m repro_torch.launch.dryrun
--arch <id> --shape <cell> | --all [--both-meshes | --multi-pod]``.

The reference lowers and compiles every (architecture x input shape)
cell on 256 or 512 fake XLA devices and records the compiled program's
memory and cost analyses and the collectives parsed from its HLO.  The
port's counterpart, for rank 0 of the same mesh, without running it:

- one process joins torch's ``fake`` process-group backend at 256 ranks
  (16x16) or 512 (--multi-pod: 2x16x16), and ``make_production_mesh``
  runs over that group (its collectives return at once);
- ``Session.plan`` plans the cell as the reference's ``build_lowered``
  does (per-arch overrides, ``check_memory=False``: the dry run reports
  the verdict), and ``Session.dryrun`` traces the dispatched train step
  on fake params, optimizer state and batch (:mod:`repro_torch.core.dry`),
  or a serve cell's ``prefill_step`` / ``serve_step`` on fake params and
  KV cache (this rank's shard of the sequence);
- each cell's JSON has the reference's keys where the meaning is the
  same: ``memory.peak_bytes`` (the traced peak of live bytes),
  ``cost.flops`` and ``cost.bytes_accessed`` (the plain operators' and
  the kernels' counts), ``collectives`` (count and bytes received by
  collective, ``core.distributed.WIRE``), ``collective_wire_bytes``,
  ``n_collectives`` and ``memory_model`` (the memory model's predicted
  peak against the traced one, and ``fits``; a serve cell's with its
  per-rank ``kv_cache_bytes``); the reference's
  ``lower_s`` and ``compile_s`` are ``trace_s``.

The traced device is ``cuda`` where a card is present and ``cpu``
otherwise (autograd cannot take fake CUDA tensors without one); nothing
runs on either, and the kernel wrappers take fake tensors of either to
their shape functions, so the numbers are the same.

``--pp N`` traces the pipeline path on the production mesh carved as
the reference's (data = 256/N, pipe = N, model = 1; 2 pods: pod = 2
before them): the first stage's rank (rank 0) and the last stage's
(rank N - 1) are each traced on a fake group of their own, the result's
``memory.peak_bytes`` is the larger peak (both are under
``memory.stage_peak_bytes``), and ``pipeline`` holds each traced rank's
``send_recv`` bytes against its share of ``costs.boundary_wire_bytes``
(M activations received by the last stage, M cotangents by the first).
Result names end in ``_pp{N}``, as the reference's do.

Cells the port does not run on a mesh print ``SKIP`` with the reason,
never as passes: the prefill/decode/long_decode cells of every family
but the dense one without sliding windows (serving on a mesh for them is
the rest of ROADMAP queue 1, item 13, named in the reason), and
alexnet's (the conv family, which the reference's ``cells()`` lists in
no cell).
A vlm cell's fake batch carries its ``vision_embeds`` (bf16).
``--hlo-out`` (no HLO here) and ``--comms auto`` are refused: both
production meshes have model = 16, so ``auto`` plans the gspmd path, the
same as ``off``.
``--all`` runs every cell on both meshes (the reference's ``--all
--both-meshes``), or on the 2x16x16 alone with ``--multi-pod``.  Results
land in ``experiments/dryrun_torch/<cell>.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch import obs as obs_mod
from repro_torch.api import Session
from repro_torch.configs import SHAPES, cells, get_config
from repro_torch.core import memory as mem_mod
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.train.optimizer import AdamWConfig

# Per-arch baseline overrides, the reference's (memory-driven), entry for
# entry; ``adamw_kwargs`` names the moment dtype as the reference's does
# (a dtype name, turned into an AdamWConfig by ``adamw_from``).
OVERRIDES: Dict[str, Dict[str, Any]] = {
    # dbrx-132b: bf16 moments and sqrt-L remat bring train_4k under HBM;
    # 16 microbatches; the low per-tensor FSDP bound keeps every
    # multi-GiB stack sharded
    "dbrx-132b": {"model_kwargs": {"remat": "group:8"},
                  "adamw_kwargs": {"moment_dtype": "bfloat16"},
                  "plan_kwargs": {"fsdp_tensor_bytes": 0.4 * 2**30},
                  "train_microbatches": 16},
    # internvl2-26b: FSDP the 3.6 GiB q/o stacks, sqrt-L remat
    "internvl2-26b": {"model_kwargs": {"remat": "group:8"},
                      "plan_kwargs": {"fsdp_tensor_bytes": 2 * 2**30},
                      "train_microbatches": 8},
    # qwen3-14b: FSDP the 2.1 GiB q/o stacks; sqrt-L remat
    "qwen3-14b": {"model_kwargs": {"remat": "group:8"},
                  "plan_kwargs": {"fsdp_tensor_bytes": 1.5 * 2**30},
                  "train_microbatches": 8},
    # small archs fit at 1-2 microbatches
    "mamba2-780m": {"train_microbatches": 1},
    "musicgen-medium": {"train_microbatches": 2},
    "gemma-2b": {"train_microbatches": 2,
                 "plan_kwargs": {"fsdp_tensor_bytes": 1 * 2**30}},
    "zamba2-1.2b": {"train_microbatches": 1},
    "deepseek-moe-16b": {"train_microbatches": 2},
}


def adamw_from(over: Dict[str, Any]) -> Optional[AdamWConfig]:
    """The override's ``adamw_kwargs`` as an :class:`AdamWConfig` (the
    moment dtype by its name), or None (the Session's default), as the
    reference's ``_adamw_from``."""
    kw = dict(over.get("adamw_kwargs", {}))
    if "moment_dtype" in kw:
        kw["moment_dtype"] = getattr(torch, kw["moment_dtype"])
    return AdamWConfig(**kw) if kw else None


def default_device() -> str:
    """The traced device: ``cuda`` where a card is present, else ``cpu``
    (nothing runs on either: the tensors are fake)."""
    return "cuda" if torch.cuda.is_available() else "cpu"


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """This process as ``rank`` of a ``world_size``-rank group of torch's
    ``fake`` backend (collectives return at once), for the block."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def skip_reason(arch: str, shape_name: str) -> Optional[str]:
    """Why the port does not dry-run a cell on a mesh, or None."""
    if get_config(arch).family == "conv":
        return (f"{arch} (the conv family, models/convnet.py) is in no "
                "dry-run cell: the reference's cells() lists none")
    cfg = get_config(arch)
    windowed = bool(cfg.window and cfg.local_global_pattern)
    if SHAPES[shape_name].kind != "train" and (cfg.family != "dense"
                                               or windowed):
        from repro_torch.models.transformer import MESH_SERVING_WAITS
        return (f"serving on a mesh runs the dense family; {arch} waits for "
                f"the rest of ROADMAP queue 1, item 13: {MESH_SERVING_WAITS}")
    return None


def build_traced(arch: str, shape_name: str, session: Session, *,
                 microbatches: Optional[int] = None, model_kwargs=None,
                 plan_kwargs=None, scale_down: int = 1):
    """Plan + trace one cell through the Session -> ``(trace, meta,
    plan)``.  ``check_memory=False``: the dry run reports the verdict.
    ``comms`` is ``"off"``, the reference's default; ``scale_down`` cuts
    the config (``scale_config``) for a test."""
    over = OVERRIDES.get(arch, {})
    plan = session.plan(
        arch, shape=shape_name, scale_down=scale_down,
        microbatches=(microbatches if microbatches is not None
                      else over.get("train_microbatches")),
        adamw=adamw_from(over), comms="off",
        model_kwargs={**over.get("model_kwargs", {}), **(model_kwargs or {})},
        plan_kwargs={**over.get("plan_kwargs", {}), **(plan_kwargs or {})},
        check_memory=False)
    trace, meta = session.dryrun(plan)
    return trace, meta, plan


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             microbatches: Optional[int] = None, model_kwargs=None,
             plan_kwargs=None, hbm_gib: Optional[float] = None,
             obs: Optional["obs_mod.Obs"] = None,
             scale_down: int = 1, pp: int = 1) -> Dict[str, Any]:
    """One cell on the production mesh, on a fake group of its size (per
    traced rank: with ``pp`` > 1 the first stage's and the last's).
    ``hbm_gib`` defaults to the H100's entry of the memory model."""
    obs = obs if obs is not None else obs_mod.Obs(name="dryrun")
    n_chips = 512 if multi_pod else 256
    if hbm_gib is None:
        hbm_gib = mem_mod.HBM_BUDGETS["h100"].hbm_bytes / mem_mod.GIB
    traces = []
    for rank in ((0, pp - 1) if pp > 1 else (0,)):
        with fake_world(n_chips, rank):
            mesh = make_production_mesh(multi_pod=multi_pod, pp=pp)
            session = Session(device=default_device(), mesh=mesh,
                              hbm_gib=hbm_gib, obs=obs)
            trace, meta, plan = build_traced(
                arch, shape_name, session, microbatches=microbatches,
                model_kwargs=model_kwargs, plan_kwargs=plan_kwargs,
                scale_down=scale_down)
        traces.append(trace)
    trace = max(traces, key=lambda t: t.peak_bytes)
    by_op = {op: {"count": trace.collective_calls.get(op, 0),
                  "wire_bytes": b} for op, b in trace.collectives.items()}
    result = {
        **meta,
        "mesh": ("2x16x16" if multi_pod else "16x16")
                + (f"_pp{pp}" if pp > 1 else ""),
        "n_chips": n_chips,
        "device": str(session.device),
        "trace_s": round(trace.trace_s, 2),
        "memory": {"state_bytes": trace.state_bytes,
                   "peak_bytes": trace.peak_bytes},
        "cost": {"flops": trace.flops,
                 "bytes_accessed": trace.bytes_accessed,
                 "kernel_flops": trace.kernel_flops,
                 "kernel_calls": trace.kernel_calls},
        "collectives": by_op,
        "collective_wire_bytes": trace.wire_bytes,
        "n_collectives": sum(trace.collective_calls.values()),
    }
    if pp > 1:
        from repro_torch.pipeline import costs
        spec = plan.pipeline
        rows = plan.global_batch // math.prod(
            mesh.shape[a] for a in plan.parallel.batch_axes)
        act = costs.boundary_act_bytes(rows // spec.num_microbatches,
                                       plan.seq_len, plan.cfg.d_model)
        result["memory"]["stage_peak_bytes"] = {
            "first": traces[0].peak_bytes, "last": traces[1].peak_bytes}
        result["pipeline"] = {
            "stages": pp, "schedule": spec.schedule,
            "microbatches": spec.num_microbatches,
            "bubble": spec.bubble_fraction(),
            "boundary_wire_bytes": costs.boundary_wire_bytes(
                act, pp, spec.num_microbatches),
            "send_recv_bytes": {
                "first": traces[0].collectives.get("send_recv", 0),
                "last": traces[1].collectives.get("send_recv", 0)},
            "send_recv_expected": spec.num_microbatches * act,
            "wire_bytes": {"first": traces[0].wire_bytes,
                           "last": traces[1].wire_bytes}}
    if meta.get("step") != "train_step":
        fp = mem_mod.serve_footprint(
            plan.cfg, batch=plan.shape.global_batch,
            seq_len=plan.shape.seq_len, decode=plan.shape.is_decode,
            mesh=mesh, plan=plan.parallel,
            param_bytes=mem_mod.param_bytes_per_rank(
                plan.model.param_specs(), mesh))
        print(f"memory model ({arch} {shape_name}, per rank):")
        print(fp.report())
        result["memory_model"] = {
            "kv_cache_bytes": fp.kv_cache,
            "terms": {k: getattr(fp, k) for k in fp._FIELDS},
            "predicted_peak_bytes": fp.total,
            "measured_peak_bytes": trace.peak_bytes,
            "fits": fp.fits(session.budget)}
    if meta.get("step") == "train_step":
        budget = session.budget
        fps = plan.footprints
        peak = mem_mod.peak_stage_footprint(fps)
        print(f"memory model ({arch} {shape_name}):")
        print(mem_mod.footprint_table(fps, budget))
        result["memory_model"] = {
            "budget": {"platform": budget.platform,
                       "hbm_bytes": budget.hbm_bytes,
                       "headroom": budget.headroom,
                       "usable_bytes": budget.usable},
            "per_stage": [{k: getattr(f, k) for k in f._FIELDS}
                          for f in fps],
            "per_stage_total_bytes": [f.total for f in fps],
            "predicted_peak_bytes": peak.total,
            "measured_peak_bytes": trace.peak_bytes,
            "fits": all(f.fits(budget) for f in fps),
        }
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description="production-mesh dry run")
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--pp", type=int, default=1,
                    help="pipeline stages: carve a 'pipe' axis out of the "
                         "production mesh (data=256/pp, pipe=pp, model=1)")
    ap.add_argument("--hbm-gib", type=float, default=None,
                    help="per-device HBM budget in GiB for the footprint "
                         "verdict (default: the H100's entry)")
    ap.add_argument("--comms", choices=["auto", "off"], default="off",
                    help="refused unless off: on both production meshes "
                         "auto plans the same gspmd path")
    ap.add_argument("--out", type=str, default="experiments/dryrun_torch")
    ap.add_argument("--hlo-out", type=str, default=None,
                    help="refused: the port lowers no HLO")
    ap.add_argument("--metrics", type=str, default=None, metavar="PATH",
                    help="also stream the plan/lower spans as JSONL to PATH")
    args = ap.parse_args(argv)
    if args.pp < 1 or 256 % args.pp:
        ap.error(f"--pp {args.pp}: the pipe axis must divide the pod's 256 "
                 "chips")
    if args.hlo_out:
        ap.error("--hlo-out: the port traces eagerly and lowers no HLO")
    if args.comms != "off":
        ap.error(f"--comms {args.comms}: both production meshes have "
                 "model=16, where the planner takes the gspmd path; only "
                 "off is traced")

    if args.all:
        todo = list(cells())
    elif args.arch and args.shape:
        todo = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape (or --all)")
    obs = obs_mod.Obs(jsonl=args.metrics, name="dryrun")
    os.makedirs(args.out, exist_ok=True)
    # --all covers both meshes unless --multi-pod names one
    meshes = ([False, True] if args.both_meshes
              or (args.all and not args.multi_pod) else [args.multi_pod])
    failures = []
    for arch, shape in todo:
        for mp in meshes:
            tag = f"{arch}_{shape}_{'2x16x16' if mp else '16x16'}"
            if args.pp > 1:
                tag += f"_pp{args.pp}"
            why = skip_reason(arch, shape)
            if why is not None:
                print(f"SKIP {tag}: {why}")
                continue
            try:
                res = run_cell(arch, shape, multi_pod=mp,
                               microbatches=args.microbatches,
                               hbm_gib=args.hbm_gib, obs=obs, pp=args.pp)
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(res, f, indent=1)
                gib = res["memory"]["peak_bytes"] / 2**30
                mm = res.get("memory_model")
                pred = (f", pred {mm['predicted_peak_bytes'] / 2**30:.2f} "
                        f"GiB {'fits' if mm['fits'] else 'OOM'}"
                        if mm else "")
                print(f"OK   {tag}: peak {gib:.2f} GiB/dev{pred}, "
                      f"flops {res['cost']['flops']:.3e}, "
                      f"colls {res['n_collectives']} "
                      f"({res['collective_wire_bytes'] / 2**30:.2f} GiB "
                      f"wire), trace {res['trace_s']}s", flush=True)
            except Exception as e:  # noqa: BLE001 — report and continue
                failures.append((tag, str(e)[:200]))
                print(f"FAIL {tag}: {str(e)[:200]}", flush=True)
    obs.close()
    if failures:
        raise SystemExit(f"{len(failures)} dry-run failures: "
                         + "; ".join(t for t, _ in failures))
    print("ALL DRY-RUN CELLS PASSED")


if __name__ == "__main__":
    main()
