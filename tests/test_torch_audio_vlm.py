"""The audio (musicgen) and vlm (internvl2) families in the port against
the JAX reference, and the dry run's per-arch overrides.

Both families are the dense family's stack, so the reference's default
one-device plan is the one held (``tests/test_torch_dense_family.py``'s).
Configs are ``scale_config(..., 64)`` cuts.  The vlm's vision prefix is
drawn nonzero (standard normal, rounded to bf16), so a dropped or
misplaced prefix fails; its labels are -1, so the loss counts the text
only.  Inputs are numpy arrays from a seed; weights come from the
reference's init through ``from_jax``.  JAX runs on the CPU and is
imported inside fixtures; the port runs its kernels' plain versions.

Tolerances, derived:

- Logits: the bf16 rule, rtol 2e-2 with a floor of 2e-2 of the largest
  (``tests/test_torch_ssm.py``: the residual stream is stored in bf16).
- Loss: rtol 1e-4, ``tests/test_torch_parallel.py``'s.  XLA's default
  excess precision (a fused bf16 elementwise chain kept in fp32) moves
  the reference's loss at these cuts by 5.5e-6 to 2.2e-5 relative (four
  seeds each; past ``tests/test_torch_train.py``'s 8e-6); with
  ``--xla_allow_excess_precision=false`` the port agrees to 1.3e-6 or
  better on the same seeds.
- Gradients: the repo's bf16 rule, 2e-2 of each value plus 2e-2 of the
  leaf's largest.
- The train CLIs: ``tests/test_torch_launch.py``'s rtol 1e-3, the first
  loss (one forward) at the loss's 1e-4.
- The port's own pins (dense == paged == continuous, the pipeline
  against the single-stage step) are exact, as the dense family's and
  the moe family's are.
- The vlm on (2,2) head-TP and (1,4) SP meshes against the reference on
  the same mesh: ``tests/test_torch_parallel.py``'s rules, unchanged.
"""

import dataclasses
import json
import math
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, scale_config  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.params import from_jax  # noqa: E402
from repro_torch.serve import ContinuousEngine, Engine, Request  # noqa: E402

from test_torch_kernels import _config_matches_reference  # noqa: E402
from test_torch_launch import KW, _one_worker  # noqa: E402
from test_torch_train import SEQ, _close, _leaf_grads  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
AUDIO, VLM = "musicgen-medium", "internvl2-26b"
AUDIO_TINY = scale_config(get_config(AUDIO), 64)
VLM_TINY = scale_config(get_config(VLM), 64)
PROMPT_LENS, NEW_TOKENS, MAX_SEQ = (5, 19, 33, 12), 6, 64


@pytest.fixture(scope="module")
def J():
    pytest.importorskip("jax")
    import repro  # noqa: F401  (installs the JAX compat shims)
    import jax
    import jax.numpy as jnp
    from repro.configs import base
    from repro.launch import dryrun as jdryrun
    from repro.launch import train as jtrain
    from repro.launch.mesh import make_mesh
    from repro.models import Model as JModel
    mesh = make_mesh((1, 1), ("data", "model"))
    return SimpleNamespace(jax=jax, jnp=jnp, base=base, mesh=mesh,
                           JModel=JModel, train=jtrain, dryrun=jdryrun)


def _models(J, cfg, seed=0):
    """(the reference's model on its default one-device plan, its params
    as numpy, the port's model, its params)."""
    jcfg = dataclasses.replace(J.base.get_config(cfg.name),
                               **dataclasses.asdict(cfg))
    with J.jax.set_mesh(J.mesh):
        jmodel = J.JModel(jcfg, J.mesh)
        params = J.jax.tree.map(np.asarray,
                                jmodel.init(J.jax.random.PRNGKey(seed)))
    return jmodel, params, Model(cfg, device="cpu"), from_jax(params)


def _vision(seed, B, cfg):
    """A nonzero prefix, rounded to bf16 (the values both sides take)."""
    v = np.random.default_rng(seed).standard_normal(
        (B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    return torch.from_numpy(v).to(torch.bfloat16).float().numpy()


def _vlm_batch(cfg, B, seed=0):
    """The train CLI's vision stub on a structured batch, with a nonzero
    prefix in place of its zeros."""
    item = next(iter(SyntheticLM(cfg.vocab_size, B, SEQ, seed=seed,
                                 structured=True)))
    (stub,) = ttrain.vision_stub(cfg, B)
    item = stub.fn(item)
    item["vision_embeds"] = _vision(seed + 1, B, cfg)
    return item


# ---------------------------------------------------------------------------
# the configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [AUDIO, VLM])
def test_audio_and_vlm_configs_match_reference_field_by_field(J, arch):
    _config_matches_reference(J, arch)


def test_every_family_but_conv_is_a_model():
    """The Model takes the reference's six families; the conv family
    (alexnet, a model of its own) names its module."""
    for arch in ("qwen2-0.5b", "deepseek-moe-16b", "mamba2-780m",
                 "zamba2-1.2b", AUDIO, VLM):
        Model(scale_config(get_config(arch), 64), device="cpu")
    conv = dataclasses.replace(AUDIO_TINY, family="conv")
    with pytest.raises(NotImplementedError, match="models/convnet.py"):
        Model(conv, device="cpu")


# ---------------------------------------------------------------------------
# musicgen: the dense path
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def audio(J):
    return _models(J, AUDIO_TINY)


def test_musicgen_forward_loss_and_gradients_match_reference(audio, J):
    jmodel, params, tm, tp = audio
    batch = next(iter(SyntheticLM(AUDIO_TINY.vocab_size, 2, SEQ, seed=3,
                                  structured=True)))
    with J.jax.set_mesh(J.mesh):
        jb = {k: J.jnp.asarray(v) for k, v in batch.items()}
        jl = np.asarray(J.jax.jit(lambda p, t: jmodel.forward(p, t)[0])(
            params, jb["tokens"]))
        (jloss, _), jg = J.jax.jit(J.jax.value_and_grad(
            jmodel.loss_fn, has_aux=True))(params, jb)
    with torch.no_grad():
        tl = tm.forward(tp, torch.from_numpy(batch["tokens"]).long())[0]
    _close(tl, jl)
    p = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    loss, _ = tm.loss_fn(p, {k: torch.from_numpy(v).long()
                             for k, v in batch.items()})
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4)
    want = _leaf_grads(J, jg)
    grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    assert set(grads) == set(want)
    for name, g in grads.items():
        _close(g, want[name])


def _port_run(tm, tp, engine_cls, **kw):
    rng = np.random.default_rng(0)
    eng = engine_cls(tm, tp, batch_slots=2, max_seq=MAX_SEQ, **kw)
    for rid, n in enumerate(PROMPT_LENS):
        eng.submit(Request(rid=rid, prompt=rng.integers(
            0, tm.cfg.vocab_size, n).astype(np.int32),
            max_new_tokens=NEW_TOKENS))
    fin = eng.run()
    assert len(fin) == len(PROMPT_LENS)
    return {r.rid: list(r.out) for r in fin}


def test_musicgen_dense_equals_static_paged_equals_continuous(audio):
    """musicgen (MHA, vocab 2,048 cut to 256) through the port's three
    engines: the same greedy tokens; the dense engine attends through the
    one-page table."""
    _, _, tm, tp = audio
    assert tm.paged_supported()
    assert Engine(tm, tp, batch_slots=2, max_seq=MAX_SEQ)._table is not None
    dense = _port_run(tm, tp, Engine)
    paged = _port_run(tm, tp, Engine, paged=True, page_size=8,
                      prefill_chunk=8)
    cont = _port_run(tm, tp, ContinuousEngine, page_size=8, prefill_chunk=8)
    assert dense == paged == cont


# ---------------------------------------------------------------------------
# internvl2: the vision prefix
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vlm(J):
    return _models(J, VLM_TINY)


def test_vlm_forward_and_loss_with_a_prefix_match_reference(vlm, J):
    """Logits over the prefix and the text, the loss (the prefix's labels
    -1) and every gradient against the reference's, with a nonzero
    prefix; without it the logits move (the prefix is used)."""
    jmodel, params, tm, tp = vlm
    batch = _vlm_batch(VLM_TINY, 2)
    nv = VLM_TINY.n_vision_tokens
    assert batch["tokens"].shape == (2, SEQ - nv)
    assert (batch["labels"][:, :nv] == -1).all()
    with J.jax.set_mesh(J.mesh):
        jb = {k: J.jnp.asarray(v) for k, v in batch.items()}
        jl = np.asarray(J.jax.jit(lambda p, t, v: jmodel.forward(p, t, v)[0])(
            params, jb["tokens"], jb["vision_embeds"]))
        (jloss, jm), jg = J.jax.jit(J.jax.value_and_grad(
            jmodel.loss_fn, has_aux=True))(params, jb)
    tb = {"tokens": torch.from_numpy(batch["tokens"]).long(),
          "labels": torch.from_numpy(batch["labels"]).long(),
          "vision_embeds": torch.from_numpy(batch["vision_embeds"])}
    with torch.no_grad():
        tl = tm.forward(tp, tb["tokens"], tb["vision_embeds"])[0]
        bare = tm.forward(tp, tb["tokens"])[0]
    assert tl.shape == (2, SEQ, VLM_TINY.padded_vocab)
    _close(tl, jl)
    assert not torch.allclose(tl[:, nv:], bare, atol=1e-2)
    p = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    loss, m = tm.loss_fn(p, tb)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4)
    assert float(m["tokens"]) == float(jm["tokens"]) == 2 * (SEQ - nv)
    want = _leaf_grads(J, jg)
    grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    for name, g in grads.items():
        _close(g, want[name])


def test_vlm_prefill_with_a_prefix_matches_reference(vlm, J):
    """The prefill's last logits and its K/V over prefix and prompt; the
    engines serve a vlm as text, as the reference's do."""
    jmodel, params, tm, tp = vlm
    toks = np.random.default_rng(4).integers(0, VLM_TINY.vocab_size, (1, 9))
    ve = _vision(5, 1, VLM_TINY)
    with J.jax.set_mesh(J.mesh):
        jl, jc = J.jax.jit(lambda p, t, v: jmodel.prefill(p, t, v))(
            params, J.jnp.asarray(toks, J.jnp.int32), J.jnp.asarray(ve))
    with torch.no_grad():
        tl, tc = tm.prefill(tp, torch.from_numpy(toks),
                            torch.from_numpy(ve))
    _close(tl, np.asarray(jl))
    for k in ("k", "v"):
        assert tc[k].shape[2] == VLM_TINY.n_vision_tokens + 9
        _close(tc[k], np.asarray(jc[k]))
    assert _port_run(tm, tp, Engine) == _port_run(tm, tp, Engine, paged=True,
                                                   page_size=8,
                                                   prefill_chunk=8)


def test_vlm_session_step_keeps_the_prefix_floating():
    """``Session.step`` moves the prefix to the device in its floating
    dtype (token ids and labels as int64), and the model casts it to
    bf16: a step on the stub's batch gives the loss of ``loss_fn`` on the
    same params."""
    from repro_torch.api import Session
    sess = Session(device="cpu")
    plan = sess.plan(VLM_TINY, batch=2, seq=SEQ, comms="off")
    sess.init_state(plan, seed=0)
    batch = _vlm_batch(VLM_TINY, 2, seed=6)
    p0 = {k: v.detach().clone() for k, v in
          sess.state["train_state"]["params"].items()}
    with torch.no_grad():
        want, _ = plan.model.loss_fn(p0, {
            "tokens": torch.from_numpy(batch["tokens"]).long(),
            "labels": torch.from_numpy(batch["labels"]).long(),
            "vision_embeds": torch.from_numpy(batch["vision_embeds"])})
    m = sess.step(plan, batch)
    assert float(m["loss"]) == float(want)


def test_vlm_train_cli_with_the_vision_stub_matches_the_references(
        J, tmp_path, monkeypatch):
    """Both CLIs' ``vision_stub`` host stage (zero patch embeddings ahead
    of the text): the reference writes its step-0 state, the port resumes
    it, and the three losses agree."""
    _one_worker(J.train, monkeypatch)
    _one_worker(ttrain, monkeypatch)
    ck = str(tmp_path / "ck")
    assert J.train.run(VLM, steps=0, ckpt_dir=ck, **KW) == []
    want = J.train.run(VLM, steps=3, log_every=1, **KW)
    got = ttrain.run(VLM, steps=3, ckpt_dir=ck, resume=True, device="cpu",
                     log_every=1, **KW)
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-3)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    assert [s.name for s in ttrain.vision_stub(VLM_TINY, 2)] == \
        ["vision_stub"]
    assert ttrain.vision_stub(AUDIO_TINY, 2) == []


def test_musicgen_train_cli_matches_the_references(J, tmp_path, monkeypatch):
    _one_worker(J.train, monkeypatch)
    _one_worker(ttrain, monkeypatch)
    ck = str(tmp_path / "ck")
    assert J.train.run(AUDIO, steps=0, ckpt_dir=ck, **KW) == []
    want = J.train.run(AUDIO, steps=3, log_every=1, **KW)
    got = ttrain.run(AUDIO, steps=3, ckpt_dir=ck, resume=True, device="cpu",
                     log_every=1, **KW)
    np.testing.assert_allclose(got, want, rtol=1e-3)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)


# ---------------------------------------------------------------------------
# the vlm on a (data, model) mesh, against the reference on the same mesh
# ---------------------------------------------------------------------------

VLM_MESH = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                head_dim=16, d_ff=128, vocab_size=250, n_vision_tokens=8)


def _vlm_mesh_cases():
    import test_torch_parallel as par
    return [par._case("vlm_tp_2x2", VLM, VLM_MESH, (2, 2)),
            par._case("vlm_sp_1x4", VLM, dict(VLM_MESH, n_heads=3,
                                              n_kv_heads=1), (1, 4))]


def _vlm_mesh_inputs(cases):
    """The mesh module's params and batches, each batch's last
    ``n_vision_tokens`` tokens making way for a nonzero bf16 prefix whose
    labels are -1 (the train CLI's stub, with values)."""
    import test_torch_parallel as par
    data = par._inputs(cases)
    nv = VLM_MESH["n_vision_tokens"]
    rng = np.random.default_rng(7)
    for t in range(par.STEPS):
        data[f"b{t}/tokens"] = data[f"b{t}/tokens"][:, :-nv]
        data[f"b{t}/labels"][:, :nv] = -1
        v = rng.standard_normal((par.BATCH, nv, VLM_MESH["d_model"]))
        data[f"b{t}/vision_embeds"] = torch.from_numpy(
            v.astype(np.float32)).to(torch.bfloat16).float().numpy()
    return data


@pytest.fixture(scope="module")
def vlm_mesh(tmp_path_factory):
    pytest.importorskip("jax")
    import test_torch_parallel as par
    cases = _vlm_mesh_cases()
    inputs = _vlm_mesh_inputs(cases)
    runs = par.run_both(tmp_path_factory.mktemp("vlm_mesh"), cases, inputs,
                        par._PORT_CASES_ONLY, jax_children=len(cases))
    return runs, {c["id"]: c for c in cases}, inputs


@pytest.mark.parametrize("check", ["logits", "loss", "gradients", "steps",
                                   "metrics"])
@pytest.mark.parametrize("cid", ["vlm_tp_2x2", "vlm_sp_1x4"])
def test_vlm_mesh_matches_reference(vlm_mesh, cid, check):
    """The vision prefix split over the batch rows like the tokens, joined
    on each rank's D-column block and relaid with the text onto the
    sequence shards: logits over prefix and text, the loss, every synced
    gradient, params and moments after 2 steps (``Session.step`` keeping
    the prefix floating), the step metrics."""
    import test_torch_parallel as par
    runs, by_id, inputs = vlm_mesh
    if check == "steps":
        par.check_steps(*runs, by_id[cid], inputs)
    else:
        getattr(par, f"check_{check}")(*runs, by_id[cid])


# ---------------------------------------------------------------------------
# the pipeline: audio runs, hybrid and vlm are refused as the reference's
# ---------------------------------------------------------------------------

_PIPE_RANKS = r"""
import json, sys, torch
from repro_torch.api import Session
from repro_torch.core import distributed as D
from repro_torch.models import layers as L
sys.path.insert(0, sys.argv[5])
import test_torch_pipeline as P
import test_torch_audio_vlm as T
rank, world, init, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])
params = torch.load(sys.argv[6])
D.init_group(init, rank=rank, world_size=world, device="cpu")
seen = []
real = L.lm_loss
def rec(logits, labels, **kw):
    loss, den = real(logits, labels, **kw)
    seen.append([float(loss.detach()).hex(), torch.is_grad_enabled()])
    return loss, den
L.lm_loss = rec
res = {}
for sched in ("gpipe", "1f1b"):
    sess = Session(device="cpu", pp=2)
    plan = sess.plan(T.AUDIO_TINY, batch=P.B, seq=P.SEQ, comms="off",
                     microbatches=P.MB, pp_schedule=sched, adamw=P._adamw())
    assert plan.path == "pipeline", plan.path
    sess.init_state(plan, params=params)
    steps = []
    for t in range(P.STEPS):
        seen.clear()
        m = sess.step(plan, P._batch())
        steps.append(dict({k: float(v).hex() for k, v in m.items()},
                          microbatch_losses=list(seen)))
    res[sched] = dict(steps=steps, coords=sess.mesh.coords)
json.dump(res, open(out.format(rank), "w"))
D.close_group()
"""


@pytest.fixture(scope="module")
def pipe_runs(tmp_path_factory):
    """GPipe and 1F1B on 2 gloo CPU ranks (one musicgen layer a stage),
    ``test_torch_pipeline``'s batch, 2 microbatches and 2 steps, and the
    port's single-stage step on the same microbatches."""
    import test_torch_pipeline as P
    tmp = tmp_path_factory.mktemp("audio_pipe")
    params = Model(AUDIO_TINY, device="cpu").init(0)
    torch.save(params, tmp / "params.pt")
    out = str(tmp / "rank{}.json")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _PIPE_RANKS, str(r), "2",
         f"file://{tmp / 'rdv'}", out, str(ROOT / "tests"),
         str(tmp / "params.pt")],
        env=P._env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    single = P._single_stage(AUDIO_TINY, params, P.MB)
    logs = [p.communicate(timeout=600)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-6000:]
    ranks = [json.loads(Path(out.format(r)).read_text()) for r in range(2)]
    return SimpleNamespace(ranks=ranks, single=single)


@pytest.mark.parametrize("sched", ["gpipe", "1f1b"])
def test_audio_pipeline_step_matches_the_single_stage_step(pipe_runs, sched):
    """musicgen through the stage body, as the reference's ``_stage_apply``
    runs the audio family: every step-1 microbatch loss bitwise the
    single-stage step's, the step's loss within 1e-6 relative, the grad
    norm within 2^-9, the second step within the step rule."""
    import test_torch_pipeline as P
    (want, want_losses), (want2, _) = pipe_runs.single
    last = next(r[sched] for r in pipe_runs.ranks
                if r[sched]["coords"]["pipe"] == 1)
    seen = last["steps"][0]["microbatch_losses"]
    if sched == "1f1b":
        assert [v for v, g in seen if g] == [v for v, g in seen if not g]
        seen = [v for v, g in seen if not g]
    else:
        seen = [v for v, _ in seen]
    assert seen == want_losses
    for res in pipe_runs.ranks:
        got = P._metrics(res[sched], 0)
        assert math.isclose(got["loss"], want["loss"], rel_tol=1e-6)
        assert math.isclose(got["grad_norm"], want["grad_norm"],
                            rel_tol=2.0 ** -9)
        got2 = P._metrics(res[sched], 1)
        np.testing.assert_allclose(got2["loss"], want2["loss"], rtol=1e-3)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", VLM])
def test_pipeline_refuses_hybrid_and_vlm_as_the_reference(arch):
    from repro_torch.core.distributed import Mesh
    from repro_torch.pipeline import schedule
    from repro_torch.pipeline.spec import PipelineSpec
    cfg = scale_config(get_config(arch), 64)
    mesh = Mesh((1, 2, 1), ("data", "pipe", "model"))
    with pytest.raises(NotImplementedError, match="nor does the reference"):
        schedule._stage_geometry(Model(cfg, device="cpu"),
                                 PipelineSpec(n_stages=2), mesh)


# ---------------------------------------------------------------------------
# the dry run: the overrides, the cells
# ---------------------------------------------------------------------------

def test_overrides_are_the_references_key_by_key(J):
    """Every arch's entry, every key, the moment dtype by name; each
    ``adamw_kwargs`` turned into an AdamWConfig as the reference's
    ``_adamw_from`` does."""
    want = J.dryrun.OVERRIDES
    assert set(dryrun.OVERRIDES) == set(want)
    for arch, over in want.items():
        got = dryrun.OVERRIDES[arch]
        assert set(got) == set(over), arch
        for key, val in over.items():
            assert got[key] == val, (arch, key)
        jadamw, tadamw = J.dryrun._adamw_from(over), dryrun.adamw_from(got)
        assert (jadamw is None) == (tadamw is None), arch
        if jadamw is not None:
            assert str(tadamw.moment_dtype).split(".")[-1] == \
                np.dtype(jadamw.moment_dtype).name == "bfloat16"


@pytest.mark.parametrize("arch,micro,remat,fsdp,moment", [
    ("dbrx-132b", 16, "group:8", 0.4 * 2**30, torch.bfloat16),
    ("deepseek-moe-16b", 2, "full", 4 * 2**30, torch.float32),
    (VLM, 8, "group:8", 2 * 2**30, torch.float32),
    (AUDIO, 2, "full", 4 * 2**30, torch.float32),
    ("zamba2-1.2b", 1, "full", 4 * 2**30, torch.float32),
])
def test_train_4k_plans_take_the_references_overrides(monkeypatch, arch,
                                                      micro, remat, fsdp,
                                                      moment):
    """The plan each cell is traced under, on 16 x 16 fake ranks: the
    reference's microbatches, remat, FSDP bound and moment dtype."""
    from repro_torch.api import Session
    from repro_torch.core import memory as mem_mod
    from repro_torch.launch.mesh import make_production_mesh
    monkeypatch.setattr(Session, "dryrun", lambda self, plan: (None, {}))
    with dryrun.fake_world(256):
        sess = Session(device="cpu", mesh=make_production_mesh(),
                       hbm_gib=mem_mod.HBM_BUDGETS["h100"].hbm_bytes
                       / mem_mod.GIB)
        _, _, plan = dryrun.build_traced(arch, "train_4k", sess)
    assert plan.num_microbatches == micro
    assert plan.model.remat == remat
    assert plan.parallel.fsdp_tensor_bytes == fsdp
    got = plan.adamw.moment_dtype if plan.adamw else torch.float32
    assert got == moment


@pytest.mark.parametrize("arch,down", [(AUDIO, 4), (VLM, 8)])
@pytest.mark.parametrize("multi_pod", [False, True])
def test_audio_and_vlm_train_4k_trace_on_both_meshes(arch, down, multi_pod):
    """``train_4k`` scaled down, traced on 16 x 16 and 2 x 16 x 16; the
    vlm's fake batch carries its bf16 vision prefix (the sequence's first
    ``n_vision_tokens`` positions)."""
    assert dryrun.skip_reason(arch, "train_4k") is None
    assert "item 13" in dryrun.skip_reason(arch, "prefill_32k")
    res = dryrun.run_cell(arch, "train_4k", multi_pod=multi_pod,
                          scale_down=down)
    assert res["memory"]["peak_bytes"] > 0
    assert res["cost"]["kernel_calls"]["attention"] > 0
    assert res["collectives"]


def test_only_alexnet_skips_for_its_family():
    from repro_torch.configs import base
    skipped = {a for a in tuple(base.ARCH_IDS) + ("alexnet",)
               if dryrun.skip_reason(a, "train_4k") is not None}
    assert skipped == {"alexnet"}
    assert "lists none" in dryrun.skip_reason("alexnet", "train_4k")
