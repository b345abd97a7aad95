"""The port's pipeline (``repro_torch.pipeline``, the ``pipeline`` train
path) against the reference's on the CPU.

The reference's own pipeline step cannot run on this tree (JAX 0.9
rejects its nested ``shard_map``: ROADMAP queue 3), so the port is held
three ways:

- against the reference's pure functions, exactly: ``partition_layers``,
  ``partition_model``, ``PipelineSpec`` (validation, stash slots, bubble,
  wire bytes), ``pipeline_spec_for`` and ``plan_for(...).pipeline``;
- against the reference's gspmd step on the same params and batch, at
  the reference test's own pipeline tolerances
  (``tests/test_pipeline.py``): losses rtol = atol = 2e-2, the first grad
  norm rtol 5e-2;
- against the port's single-stage step (one rank, the same rows in each
  microbatch): every step-1 microbatch loss bitwise (the same rows
  through the same operators), the step-1 loss bitwise where one data
  row holds every microbatch and within 1e-6 relative where the batch
  splits over data (the pmean adds the rows' means in another order),
  the step-1 grad norm within 2^-9 (fp32 sums of the stages' and rows'
  gradients in another order); GPipe against 1F1B every loss within
  2e-3 (the reference test's).

The tiny config is the reference test's (4 layers, d_model 32, 4 heads /
2 kv, d_ff 64, vocab 64; B 8, T 16, 2 microbatches a data row, 2
steps), with a windowed variant (window 4, every 4th layer global) and
mamba2-780m cut to 4 layers.  The cells run as gloo CPU ranks started
as ``python -c`` subprocesses (a ``file://`` rendezvous in ``tmp_path``):
two ranks run every (pp=2, dp=1) cell, four ranks the (2, 2) and
(4, 1) cells and the ``CommsPlan(schedule="ring")`` one.  JAX is
imported inside fixtures only.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import Session  # noqa: E402
from repro_torch.configs import get_config, scale_config  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core.distributed import Mesh  # noqa: E402
from repro_torch.core.planner import pipeline_spec_for, plan_for  # noqa: E402
from repro_torch.models import Model, layers  # noqa: E402
from repro_torch.pipeline import (PipelineSpec, costs, partition,  # noqa: E402
                                  schedule)
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train.step import pipeline_train_step  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TINY = ModelConfig(name="pipe-tiny", family="dense", n_layers=4, d_model=32,
                   n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64,
                   vocab_size=64)
WINDOWED = dataclasses.replace(TINY, name="pipe-tiny-windowed", window=4,
                               local_global_pattern=3)
MAMBA = dataclasses.replace(scale_config(get_config("mamba2-780m"), 64),
                            n_layers=4)
CONFIGS = {"tiny": TINY, "windowed": WINDOWED, "mamba2": MAMBA}
B, SEQ, MB, STEPS, LR = 8, 16, 2, 2, 1e-2

# (config, pp, dp, schedule, comms)
CELLS = [(c, pp, dp, s, None) for pp, dp in ((2, 1), (2, 2), (4, 1))
         for c in ("tiny",) for s in ("gpipe", "1f1b")]
CELLS += [("tiny", 2, 2, "gpipe", "ring")]
CELLS += [(c, 2, 1, s, None) for c in ("windowed", "mamba2")
          for s in ("gpipe", "1f1b")]


def _tag(cell):
    c, pp, dp, s, comms = cell
    return f"{c}-pp{pp}-dp{dp}-{s}" + (f"-{comms}" if comms else "")


def _batch():
    rng = np.random.RandomState(0)
    toks = rng.randint(0, TINY.vocab_size, (B, SEQ + 1)).astype(np.int64)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _adamw():
    return topt.AdamWConfig(lr=LR, weight_decay=0.0)


_RANKS = r"""
import json, sys, torch
from repro_torch.api import Session
from repro_torch.comms.plan import CommsPlan
from repro_torch.core import distributed as D
from repro_torch.models import layers as L
sys.path.insert(0, sys.argv[5])
import test_torch_pipeline as T
rank, world, init, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])
params = torch.load(sys.argv[6])
cells = [tuple(c) for c in json.loads(sys.argv[7])]
D.init_group(init, rank=rank, world_size=world, device="cpu")
seen = []
real = L.lm_loss
def rec(logits, labels, **kw):
    loss, den = real(logits, labels, **kw)
    seen.append([float(loss.detach()).hex(), torch.is_grad_enabled()])
    return loss, den
L.lm_loss = rec
res = {}
for cell in cells:
    name, pp, dp, sched, comms = cell
    sess = Session(device="cpu", pp=pp)
    comms = "off" if comms is None else CommsPlan(schedule=comms,
                                                  bucket_bytes=1 << 16)
    plan = sess.plan(T.CONFIGS[name], batch=T.B, seq=T.SEQ, comms=comms,
                     microbatches=T.MB, pp_schedule=sched, adamw=T._adamw())
    assert plan.path == "pipeline", plan.path
    sess.init_state(plan, params=params[name])
    steps = []
    for t in range(T.STEPS):
        seen.clear()
        D.WIRE.reset()
        m = sess.step(plan, T._batch())
        steps.append(dict({k: float(v).hex() for k, v in m.items()},
                          send_recv=D.WIRE.bytes.get("send_recv", 0),
                          microbatch_losses=list(seen)))
    st = sess.state["train_state"]["params"]
    edge_bits = {k: st[k].detach().view(torch.int16).to(torch.int64)
                 .mul(torch.arange(st[k].numel()).reshape(st[k].shape) % 977
                      + 1).sum().item()
                 for k in ("embed", "unembed", "final_norm")}
    res[T._tag(cell)] = dict(steps=steps, coords=sess.mesh.coords,
                             edge_bits=edge_bits)
json.dump(res, open(out.format(rank), "w"))
D.close_group()
"""


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src") + os.pathsep
                + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")


def _global_params():
    return {name: Model(cfg, device="cpu").init(0)
            for name, cfg in CONFIGS.items()}


def _record_losses(fn):
    """(fn's result, the hex of every ``lm_loss`` value it computed)."""
    seen, real = [], layers.lm_loss

    def rec(logits, labels, **kw):
        loss, den = real(logits, labels, **kw)
        seen.append(float(loss.detach()).hex())
        return loss, den
    layers.lm_loss = rec
    try:
        return fn(), seen
    finally:
        layers.lm_loss = real


def _single_stage(cfg, params, n_microbatches):
    """The port's one-rank step on the whole batch in ``n_microbatches``
    microbatches: per step (metrics, the microbatches' losses)."""
    sess = Session(device="cpu")
    plan = sess.plan(cfg, batch=B, seq=SEQ, comms="off",
                     microbatches=n_microbatches, adamw=_adamw())
    assert plan.path == "gspmd" and plan.model.mesh is None
    sess.init_state(plan, params=params)
    out = []
    for _ in range(STEPS):
        m, seen = _record_losses(lambda: sess.step(plan, _batch()))
        out.append(({k: float(v) for k, v in m.items()}, seen))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every cell's rank results (by tag, by rank), the port's
    single-stage steps by (config, microbatch count), started together:
    the rank groups as subprocesses, the single-stage steps here."""
    tmp = tmp_path_factory.mktemp("pipeline")
    params = _global_params()
    torch.save(params, tmp / "params.pt")
    procs, outs = [], {}
    for world in (2, 4):
        cells = [c for c in CELLS if c[1] * c[2] == world]
        out = str(tmp / f"w{world}_rank{{}}.json")
        outs[world] = out
        for r in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _RANKS, str(r), str(world),
                 f"file://{tmp / f'rdv{world}'}", out, str(ROOT / "tests"),
                 str(tmp / "params.pt"), json.dumps(cells)],
                env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    single = {}
    for name, pp, dp, _, _ in CELLS:
        if (name, dp * MB) not in single:
            single[(name, dp * MB)] = _single_stage(CONFIGS[name],
                                                    params[name], dp * MB)
    logs = []
    for p in procs:
        log, _ = p.communicate(timeout=600)
        logs.append(log)
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-6000:]
    ranks = {}
    for world, out in outs.items():
        for r in range(world):
            for tag, res in json.loads(Path(out.format(r)).read_text()
                                       ).items():
                ranks.setdefault(tag, []).append(res)
    return SimpleNamespace(ranks=ranks, single=single, params=params)


@pytest.fixture(scope="module")
def J():
    pytest.importorskip("jax")
    import repro  # noqa: F401  (installs the JAX compat shims)
    import jax
    import jax.numpy as jnp
    from repro import pipeline as jpipe
    from repro.api.session import dispatch_train_step
    from repro.configs.base import ModelConfig as JModelConfig
    from repro.configs.base import get_config as jget_config
    from repro.core import planner as jplanner
    from repro.launch.mesh import make_mesh
    from repro.models import Model as JModel
    from repro.pipeline import partition as jpartition
    from repro.train import optimizer as jopt
    return SimpleNamespace(
        jax=jax, jnp=jnp, pipe=jpipe, partition=jpartition,
        planner=jplanner, dispatch=dispatch_train_step, JModel=JModel,
        ModelConfig=JModelConfig, get_config=jget_config, opt=jopt,
        mesh=make_mesh((1, 1), ("data", "model")))


def _metrics(res, t):
    return {k: float.fromhex(v) for k, v in res["steps"][t].items()
            if isinstance(v, str)}


def _last_stage_ranks(rows, pp):
    """The results of the last stage's ranks, in data order."""
    return sorted((r for r in rows if r["coords"]["pipe"] == pp - 1),
                  key=lambda r: r["coords"]["data"])


# ---------------------------------------------------------------------------
# the pure functions, equal to the reference's
# ---------------------------------------------------------------------------

WEIGHTS = {
    "uniform": [100] * 8,
    "heavy_tail": [1, 1, 1, 10],
    "ramp": list(range(1, 13)),
    "spiky": [5, 1, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9],
    "odd": [3] * 7,
}


@pytest.mark.parametrize("weights", sorted(WEIGHTS))
def test_partition_layers_is_the_references(J, weights):
    w = WEIGHTS[weights]
    for S in range(1, len(w) + 1):
        got = partition.partition_layers(w, S)
        want = J.partition.partition_layers(w, S)
        assert got.boundaries == want.boundaries, S
        assert got.stage_bytes == want.stage_bytes, S
        assert got.is_uniform == want.is_uniform
        assert got.imbalance == want.imbalance
    for S in (0, len(w) + 1):
        with pytest.raises(ValueError):
            partition.partition_layers(w, S)
        with pytest.raises(ValueError):
            J.partition.partition_layers(w, S)


def test_partition_model_is_the_references(J):
    class _M:
        shape = {"data": 16, "model": 16}

    cfg = get_config("qwen2-0.5b")
    jcfg = J.get_config("qwen2-0.5b")
    jmodel = J.JModel(jcfg, _M, J.planner.plan_for(jcfg, _M))
    model = Model(cfg, device="cpu")
    assert partition.per_layer_param_bytes(model) \
        == J.partition.per_layer_param_bytes(jmodel)
    for S in (1, 2, 3, 4, 6, 8, 12, 24):
        got = partition.partition_model(model, S)
        want = J.partition.partition_model(jmodel, S)
        assert (got.boundaries, got.stage_bytes) \
            == (want.boundaries, want.stage_bytes)
    with pytest.raises(ValueError):
        partition.partition_model(model, 5)
    zamba = SimpleNamespace(cfg=SimpleNamespace(family="hybrid",
                                                n_layers=38))
    with pytest.raises(NotImplementedError):
        partition.partition_model(zamba, 2)


def test_pipeline_spec_is_the_references(J):
    for kw in (dict(schedule="zigzag"), dict(num_microbatches=0),
               dict(num_microbatches=8, stash_slots=2),
               dict(num_microbatches=8, stash_slots=9)):
        with pytest.raises(ValueError):
            J.pipe.PipelineSpec(n_stages=2, **kw)
        with pytest.raises(ValueError):
            PipelineSpec(n_stages=2, **kw)
    for S in (1, 2, 3, 4, 8):
        for M in (1, 2, 3, 4, 8, 16):
            for slots in (None, costs.min_stash_slots(S, M), M):
                if slots is not None and slots < costs.min_stash_slots(S, M):
                    continue
                got = PipelineSpec(n_stages=S, num_microbatches=M,
                                   stash_slots=slots)
                want = J.pipe.PipelineSpec(n_stages=S, num_microbatches=M,
                                           stash_slots=slots)
                assert got.resolved_stash_slots() \
                    == want.resolved_stash_slots()
                assert got.bubble_fraction() == want.bubble_fraction()
                assert got.boundary_wire_bytes(2, 512, 896) \
                    == want.boundary_wire_bytes(2, 512, 896)


@pytest.mark.parametrize("shape", [
    {"data": 4, "pipe": 2, "model": 1}, {"data": 1, "pipe": 4, "model": 1},
    {"data": 2, "pipe": 2, "model": 2}, {"data": 64, "pipe": 4, "model": 1},
    {"data": 16, "model": 16}, {"pod": 2, "data": 8, "pipe": 3, "model": 1}])
def test_pipeline_spec_for_is_the_references(J, shape):
    mesh = SimpleNamespace(shape=shape)
    for arch in ("qwen2-0.5b", "gemma3-27b", "mamba2-780m"):
        cfg, jcfg = get_config(arch), J.get_config(arch)
        for kw in ({}, {"num_microbatches": 3, "schedule": "1f1b"}):
            try:
                want = J.planner.pipeline_spec_for(jcfg, mesh, **kw)
            except ValueError:
                with pytest.raises(ValueError):
                    pipeline_spec_for(cfg, mesh, **kw)
                continue
            got = pipeline_spec_for(cfg, mesh, **kw)
            assert (got is None) == (want is None)
            if want is not None:
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
        if cfg.n_layers % shape.get("pipe", 1) == 0:
            got = plan_for(cfg, mesh).pipeline
            want = J.planner.plan_for(jcfg, mesh).pipeline
            assert (None if got is None else dataclasses.asdict(got)) \
                == (None if want is None else dataclasses.asdict(want))


def test_pipeline_refuses_a_model_axis():
    model = Model(TINY, device="cpu")
    mesh = Mesh((1, 2, 2), ("data", "pipe", "model"))
    with pytest.raises(ValueError, match="size 1"):
        pipeline_train_step(model, mesh, _adamw(),
                            pipeline=pipeline_spec_for(TINY, mesh))


def test_stage_layers_take_their_global_windows():
    """A stage runs its layers with the global layer index: stage 1 of 2
    of the windowed config runs layers 2 (local, window 4) and 3
    (global), not the windows of layers 0 and 1."""
    model = Model(WINDOWED, device="cpu")
    params = model.init(0)
    stage = {k: (v[2:4] if k.startswith("layers.") else v)
             for k, v in params.items()}
    seen, real = [], model._dense_block

    def block(x, lp, window, *a):
        seen.append(window)
        return real(x, lp, window, *a)
    model._dense_block = block
    x = torch.zeros((1, SEQ, WINDOWED.d_model), dtype=torch.bfloat16)
    with torch.no_grad():
        schedule._stage_apply(model, stage, x, schedule._Geometry(1, 2, 2, 2))
    assert seen == [model._window(2), model._window(3)] == [4, None]


# ---------------------------------------------------------------------------
# the schedules on gloo CPU ranks
# ---------------------------------------------------------------------------

def _reference_steps(J, cfg, params):
    """The reference's gspmd step (one device, the reference test's
    baseline: MB microbatches of the whole batch) from the port's params:
    each step's metrics."""
    from repro_torch.models.params import nest_names
    jcfg = J.ModelConfig(**dataclasses.asdict(cfg))
    jparams = J.jax.tree.map(
        lambda t: J.jnp.asarray(t.float().numpy()).astype(J.jnp.bfloat16),
        nest_names(params))
    with J.jax.set_mesh(J.mesh):
        jmodel = J.JModel(jcfg, J.mesh, J.planner.plan_for(jcfg, J.mesh),
                          q_chunk=16, kv_chunk=16, ssd_chunk=16)
        step = J.jax.jit(J.dispatch(
            jmodel, J.mesh, adamw=J.opt.AdamWConfig(lr=LR, weight_decay=0.0),
            num_microbatches=MB, path="gspmd"))
        state = {"params": jparams,
                 "opt": J.opt.init_state(jparams, jmodel.param_specs(),
                                         J.mesh)}
        out = []
        for _ in range(STEPS):
            state, m = step(state, {k: J.jnp.asarray(v.astype(np.int32))
                                    for k, v in _batch().items()})
            out.append({k: float(v) for k, v in m.items()})
    return out


@pytest.fixture(scope="module")
def reference(J, runs):
    """The reference's gspmd steps for every config, by name."""
    return {name: _reference_steps(J, cfg, runs.params[name])
            for name, cfg in CONFIGS.items()}


@pytest.mark.parametrize("cell", CELLS, ids=_tag)
def test_schedule_matches_the_references_gspmd_step(runs, reference, cell):
    want = reference[cell[0]]
    for res in runs.ranks[_tag(cell)]:
        got = [_metrics(res, t) for t in range(STEPS)]
        np.testing.assert_allclose([g["loss"] for g in got],
                                   [w["loss"] for w in want],
                                   rtol=2e-2, atol=2e-2)
        np.testing.assert_allclose(got[0]["grad_norm"],
                                   want[0]["grad_norm"], rtol=5e-2)


@pytest.mark.parametrize("cell", CELLS, ids=_tag)
def test_step_one_matches_the_single_stage_step(runs, cell):
    name, pp, dp, sched, _ = cell
    rows = runs.ranks[_tag(cell)]
    (want, want_losses), _ = runs.single[(name, dp * MB)]
    got_losses = []
    for res in _last_stage_ranks(rows, pp):
        seen = res["steps"][0]["microbatch_losses"]
        if sched == "1f1b":
            # the forward slot's loss, then the backward slot's recompute
            assert [v for v, grad in seen if grad] \
                == [v for v, grad in seen if not grad]
            seen = [v for v, grad in seen if not grad]
        else:
            seen = [v for v, _ in seen]
        got_losses += seen
    assert got_losses == want_losses
    for res in rows:
        got = _metrics(res, 0)
        if dp == 1:
            assert got["loss"] == want["loss"]
        else:
            assert math.isclose(got["loss"], want["loss"], rel_tol=1e-6)
        assert math.isclose(got["grad_norm"], want["grad_norm"],
                            rel_tol=2.0 ** -9)
        assert got["tokens"] == want["tokens"]


@pytest.mark.parametrize("pair", sorted({c[:3] for c in CELLS}),
                         ids=lambda p: f"{p[0]}-pp{p[1]}-dp{p[2]}")
def test_gpipe_and_1f1b_agree(runs, pair):
    g = runs.ranks[_tag(pair + ("gpipe", None))]
    o = runs.ranks[_tag(pair + ("1f1b", None))]
    for a, b in zip(g, o):
        for t in range(STEPS):
            ma, mb = _metrics(a, t), _metrics(b, t)
            np.testing.assert_allclose(ma["loss"], mb["loss"], rtol=2e-3,
                                       atol=2e-3)
        assert _metrics(a, 0)["loss"] == _metrics(b, 0)["loss"]


@pytest.mark.parametrize("cell", [c for c in CELLS if c[4] is None],
                         ids=_tag)
def test_send_recv_bytes_are_the_boundary_wire_bytes(runs, cell):
    """Per step, the bytes a pipe line's ranks receive point to point are
    ``costs.boundary_wire_bytes``: only valid microbatches cross (the
    ring's data-parallel steps are point to point too, so the comms cell
    is left out)."""
    name, pp, dp, _, _ = cell
    cfg = CONFIGS[name]
    act = costs.boundary_act_bytes(B // dp // MB, SEQ, cfg.d_model)
    want = costs.boundary_wire_bytes(act, pp, MB)
    rows = runs.ranks[_tag(cell)]
    for d in range(dp):
        line = [r for r in rows if r["coords"]["data"] == d]
        assert len(line) == pp
        for t in range(STEPS):
            assert sum(r["steps"][t]["send_recv"] for r in line) == want


@pytest.mark.parametrize("cell", CELLS, ids=_tag)
def test_edge_params_are_bitwise_across_pipe(runs, cell):
    rows = runs.ranks[_tag(cell)]
    for d in range(cell[2]):
        line = [r["edge_bits"] for r in rows if r["coords"]["data"] == d]
        assert all(b == line[0] for b in line[1:])


def test_pipeline_composes_with_a_comms_plan(runs, reference):
    """The (2, 2) GPipe cell with its data-parallel sync through
    ``CommsPlan(schedule="ring")``: the reference's losses, and the same
    step-1 metrics as the pmean's within one rounding."""
    ring = runs.ranks[_tag(("tiny", 2, 2, "gpipe", "ring"))]
    plain = runs.ranks[_tag(("tiny", 2, 2, "gpipe", None))]
    for a, b in zip(ring, plain):
        np.testing.assert_allclose(
            [_metrics(a, t)["loss"] for t in range(STEPS)],
            [w["loss"] for w in reference["tiny"]], rtol=2e-2, atol=2e-2)
        assert _metrics(a, 0)["loss"] == _metrics(b, 0)["loss"]
        assert math.isclose(_metrics(a, 0)["grad_norm"],
                            _metrics(b, 0)["grad_norm"], rel_tol=2.0 ** -9)
