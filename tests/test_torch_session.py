"""The whole Session against the JAX reference's: plans by shape and kind,
the capability table, ``input_specs``, ``cells``, ``Session.serve`` on
persistent params with the engines' caches in the state registry and
their steps in the compiled-artifact cache, ``describe``, the
``publish_metrics`` gauges, the autotuner, the roofline gate and the
backend ``init_group`` picks.

The reference runs in this process on one CPU device (imported inside
fixtures).  Both sides serve the same weights: the reference's params,
carried across with ``from_jax`` and put under ``serve/params`` on both
sides before the first ``serve``.  Greedy tokens on this tiny config
(``test_torch_model.CFG``) are held equal outright.
"""

import dataclasses
import time
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs as tobs  # noqa: E402
from repro_torch.api import PlanMemoryError, Session  # noqa: E402
from repro_torch.api.plan import capability_table  # noqa: E402
from repro_torch.configs import SHAPES, cells, input_specs  # noqa: E402
from repro_torch.configs import get_config, ported_archs  # noqa: E402
from repro_torch.core import autotune  # noqa: E402
from repro_torch.core.distributed import select_backend  # noqa: E402
from repro_torch.core.layout import Layout  # noqa: E402
from repro_torch.core.planner import plan_for  # noqa: E402
from repro_torch.kernels import roofline  # noqa: E402
from repro_torch.models.params import from_jax  # noqa: E402
from repro_torch.serve import Request  # noqa: E402

MAX_SEQ, SLOTS, PAGE, CHUNK = 64, 2, 8, 8
PROMPT_LENS = (5, 12, 20, 9)
NEW_TOKENS = 6
ENGINES = {"static": dict(),
           "paged": dict(paged=True, page_size=PAGE, prefill_chunk=CHUNK),
           "continuous": dict(scheduler="continuous", page_size=PAGE,
                              prefill_chunk=CHUNK)}


@pytest.fixture(scope="module")
def J():
    """The reference's modules, imported here only."""
    pytest.importorskip("jax")
    import repro  # noqa: F401  (installs the JAX compat shims)
    import jax
    import jax.numpy as jnp
    from repro import obs as jobs
    from repro.api import PlanMemoryError as JPlanMemoryError
    from repro.api import Session as JSession
    from repro.api.plan import capability_table as jtable
    from repro.configs import cells as jcells
    from repro.configs import input_specs as jinput_specs
    from repro.configs.base import get_config as jget_config
    from repro.core import autotune as jautotune
    from repro.core.planner import plan_for as jplan_for
    from repro.kernels import roofline as jroofline
    from repro.serve import Request as JRequest
    return SimpleNamespace(
        jax=jax, jnp=jnp, obs=jobs, PlanMemoryError=JPlanMemoryError,
        Session=JSession, capability_table=jtable, cells=jcells,
        input_specs=jinput_specs, get_config=jget_config,
        autotune=jautotune, plan_for=jplan_for, roofline=jroofline,
        Request=JRequest)


@pytest.fixture(scope="module")
def tiny(J):
    """(config, reference params as device arrays, the port's params)."""
    cfg = dataclasses.replace(
        J.get_config("qwen2-0.5b"), n_layers=2, d_model=128, n_heads=14,
        n_kv_heads=2, head_dim=16, d_ff=256, vocab_size=512)
    from repro.launch.mesh import make_mesh
    from repro.models import Model as JModel
    mesh = make_mesh((1, 1), ("data", "model"))
    with J.jax.set_mesh(mesh):
        jmodel = JModel(cfg, mesh, J.plan_for(cfg, mesh))
        params = J.jax.tree.map(np.asarray,
                                jmodel.init(J.jax.random.PRNGKey(0)))
    attn = params["layers"]["attn"]
    for i, name in enumerate(("bq", "bk", "bv")):
        rng = np.random.default_rng(10 + i)
        attn[name] = np.asarray(J.jnp.asarray(
            rng.standard_normal(attn[name].shape) * 0.5, J.jnp.bfloat16))
    return cfg, J.jax.tree.map(J.jnp.asarray, params), from_jax(params)


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in PROMPT_LENS]


def _serve(eng, request_cls, vocab):
    for rid, p in enumerate(_prompts(vocab)):
        eng.submit(request_cls(rid=rid, prompt=p, max_new_tokens=NEW_TOKENS))
    return {r.rid: list(map(int, r.out)) for r in eng.run()}


# ---------------------------------------------------------------------------
# plans by shape, the capability table, input specs, cells
# ---------------------------------------------------------------------------

PLAN_CASES = [
    ("qwen2-0.5b", dict(shape="train_4k", comms="off",
                        check_memory=False)),
    ("qwen2-0.5b", dict(shape="decode_32k")),
    ("gemma-2b", dict(shape="prefill_32k")),
    ("mamba2-780m", dict(shape="long_500k")),
    ("qwen3-14b", dict(shape=SHAPES["decode_32k"])),
    ("qwen2-0.5b", dict(batch=8, seq=128, kind="decode")),
    ("qwen2-0.5b", dict(batch=4, seq=64, kind="prefill", scale_down=16)),
    ("gemma-2b", dict(batch=8, seq=256, comms="off", scale_down=8)),
    ("qwen2-0.5b", dict(batch=8, seq=256, comms="off", microbatches=4,
                        scale_down=16)),
]


@pytest.mark.parametrize("arch,kw", PLAN_CASES,
                         ids=[f"{a}-{i}" for i, (a, _) in
                              enumerate(PLAN_CASES)])
def test_plans_by_shape_and_kind_are_the_references(J, arch, kw):
    """Path, microbatches, the shape cell's views, ``capability()`` and
    ``describe()`` equal the reference's (one device; the train cells
    with ``comms="off"``: with no process group the port's ``auto``
    keeps the one-rank path, ROADMAP queue 3)."""
    jkw = dict(kw)
    if not isinstance(jkw.get("shape"), (str, type(None))):
        jkw["shape"] = jkw["shape"].name       # the reference's own type
    want = J.Session().plan(arch, **jkw)
    got = Session(device="cpu").plan(arch, **kw)
    assert got.path == want.path
    assert got.kind == want.kind
    assert got.shape.name == want.shape.name
    assert (got.global_batch, got.seq_len) == (want.global_batch,
                                               want.seq_len)
    assert got.num_microbatches == want.num_microbatches
    assert got.capability() == want.capability()
    assert got.describe() == want.describe()
    assert got.fits() == want.fits()


def test_capability_table_is_the_references(J):
    """The table and every row's text are the reference's, and the port
    dispatches every row: a pipe axis (or a PipelineSpec) selects the
    pipeline path, as the reference's ``select_path`` does."""
    from repro.api.plan import CAPABILITIES as JCAP
    from repro.api.plan import select_path as jselect
    from repro_torch.api.plan import CAPABILITIES, select_path
    assert capability_table() == J.capability_table()
    assert CAPABILITIES == JCAP
    assert set(CAPABILITIES) == {"gspmd", "comms", "pipeline"}
    for shape, kw in (({"data": 1, "pipe": 2, "model": 1}, {}),
                      ({"data": 4, "model": 1}, {"pipeline": object()}),
                      ({"data": 2, "pipe": 2, "model": 1},
                       {"comms": object()}),
                      ({"data": 4, "model": 1}, {"comms": object()}),
                      ({"data": 4, "model": 1}, {})):
        assert select_path(shape, **kw) == jselect(shape, **kw)
    assert select_path({"data": 1, "pipe": 2, "model": 1}) == "pipeline"


@pytest.mark.parametrize("mesh_shape", [(16, 16), (2, 16, 16), (4, 2),
                                        (1, 1)])
def test_input_specs_are_the_references(J, mesh_shape):
    """Names, shapes, dtypes and the batch dims' mesh axes of every
    cell's inputs (shape-only meshes: the reference's bare specs)."""
    axes = ("data", "model") if len(mesh_shape) == 2 \
        else ("pod", "data", "model")
    shape = dict(zip(axes, mesh_shape))
    mesh = SimpleNamespace(shape=shape)
    for arch in ("qwen2-0.5b", "gemma3-27b"):
        for cell in SHAPES.values():
            jcfg = J.get_config(arch)
            want, wdims = J.input_specs(jcfg, cell, mesh,
                                        J.plan_for(jcfg, mesh),
                                        make_shardings=False)
            cfg = get_config(arch)
            got, gdims = input_specs(cfg, cell, mesh, plan_for(cfg, mesh),
                                     make_shardings=False)
            assert list(got) == list(want)
            for k in want:
                assert tuple(got[k].shape) == tuple(want[k].shape), k
                assert str(got[k].dtype).split(".")[-1] == \
                    str(want[k].dtype), k
                assert got[k].device.type == "meta"
                assert Layout(tuple(gdims[k])) == Layout(tuple(wdims[k])), k


def test_cells_are_the_references_filtered_to_the_ported_archs(J):
    ported = set(ported_archs())
    assert ported == {"qwen2-0.5b", "gemma-2b", "gemma3-27b", "qwen3-14b",
                      "dbrx-132b", "deepseek-moe-16b", "mamba2-780m",
                      "zamba2-1.2b", "musicgen-medium", "internvl2-26b"}
    for skipped in (False, True):
        want = [c for c in J.cells(include_skipped=skipped)
                if c[0] in ported]
        assert cells(include_skipped=skipped) == want


# ---------------------------------------------------------------------------
# Session.serve: tokens, the registry, the op cache, describe, gauges
# ---------------------------------------------------------------------------

def _sessions(J, tiny, **kw):
    """Both sessions with the same params resident under serve/params,
    and a decode plan on each."""
    cfg, jparams, tparams = tiny
    jsess = J.Session(obs=kw.get("jobs"), hbm_gib=kw.get("hbm_gib"))
    tsess = Session(device="cpu", obs=kw.get("tobs"),
                    hbm_gib=kw.get("hbm_gib"))
    jsess.put("serve/params", jparams, kind="params")
    tsess.put("serve/params", tparams, kind="params")
    jplan = jsess.plan(cfg, batch=SLOTS, seq=MAX_SEQ, kind="decode")
    tplan = tsess.plan(cfg, batch=SLOTS, seq=MAX_SEQ, kind="decode")
    return jsess, jplan, tsess, tplan


@pytest.fixture(scope="module")
def served(J, tiny):
    """The same sequence on both sides (a decode plan, every engine kind
    served twice under one name, a train plan's step built twice),
    telemetry on: the tokens, the sessions and their Obs."""
    cfg = tiny[0]
    jobs, tobs_ = J.obs.Obs(name="j"), tobs.Obs(name="t")
    jsess, jplan, tsess, tplan = _sessions(J, tiny, jobs=jobs, tobs=tobs_)
    tokens = {}
    with J.jax.set_mesh(jsess.mesh):
        for kind, kw in ENGINES.items():
            for _ in range(2):
                want = _serve(jsess.serve(jplan, batch_slots=SLOTS,
                                          max_seq=MAX_SEQ, **kw),
                              J.Request, cfg.vocab_size)
                eng = tsess.serve(tplan, batch_slots=SLOTS, max_seq=MAX_SEQ,
                                  **kw)
                assert eng.params is tsess.get("serve/params")
                got = _serve(eng, Request, cfg.vocab_size)
                tokens.setdefault(kind, []).append((got, want))
        jtrain = jsess.plan(cfg, batch=2, seq=16, comms="off")
        ttrain = tsess.plan(cfg, batch=2, seq=16, comms="off")
        steps = []
        for _ in range(2):
            jsess.train_step(jtrain)
            steps.append(tsess.train_step(ttrain))
        assert steps[0] is steps[1]
    jsess.publish_metrics()
    tsess.publish_metrics()
    return SimpleNamespace(tokens=tokens, jsess=jsess, tsess=tsess,
                           jobs=jobs, tobs=tobs_)


@pytest.mark.parametrize("kind", list(ENGINES))
def test_served_greedy_tokens_are_the_references(served, kind):
    for got, want in served.tokens[kind]:
        assert len(got) == len(PROMPT_LENS)
        assert got == want


def test_engines_share_tokens_and_reuse_params(served):
    first = served.tokens["static"][0][0]
    for kind in ENGINES:
        for got, _ in served.tokens[kind]:
            assert got == first


def test_registry_entries_are_the_references(served):
    """Name, kind and bytes of every entry (params, the static engine's
    dense cache, its paged cache under the same key, the continuous
    pool with its table), and the report's text."""
    J, T = served.jsess.state, served.tsess.state
    assert sorted(T.keys()) == sorted(J.keys()) == [
        "serve/kv_cache", "serve/kv_pool", "serve/params"]
    for k in J.keys():
        je, te = J.entry(k), T.entry(k)
        assert (te.kind, te.nbytes) == (je.kind, je.nbytes), k
    assert T.report() == J.report()
    assert served.tsess.describe() == served.jsess.describe()


def test_opcache_stats_are_the_references(served):
    """Per op: the second engine of each kind replays the first's steps,
    the static paged and continuous engines share theirs, and the train
    step is built once for two calls."""
    want = {op: (s.hits, s.misses, s.compiles)
            for op, s in served.jsess.opcache.stats().items()}
    got = {op: (s.hits, s.misses, s.compiles)
           for op, s in served.tsess.opcache.stats().items()}
    assert got == want
    assert got["train_step"] == (1, 1, 1)
    assert got["serve_decode_paged"] == (3, 1, 1)


def test_publish_metrics_gauges_are_the_references(served):
    want = served.jobs.metrics.summary()["gauges"]
    got = served.tobs.metrics.summary()["gauges"]
    assert got == want
    assert got["opcache.serve_prefill.hits"] == 1


def test_the_second_engine_reuses_the_params_tensors(tiny):
    """Restart: the same tensors (storages), nothing initialized again."""
    cfg = tiny[0]
    sess = Session(device="cpu")
    plan = sess.plan(cfg, batch=SLOTS, seq=MAX_SEQ, kind="decode")
    first = sess.serve(plan, batch_slots=SLOTS, max_seq=MAX_SEQ, seed=3)
    ptrs = {k: v.data_ptr() for k, v in first.params.items()}
    second = sess.serve(plan, batch_slots=SLOTS, max_seq=MAX_SEQ, seed=4)
    assert {k: v.data_ptr() for k, v in second.params.items()} == ptrs
    assert second.cache is sess.get("serve/kv_cache")


def test_an_over_budget_pool_is_refused_on_both_sides(J, tiny):
    """A pool past the budget raises PlanMemoryError on both sides; the
    registry keeps the params and no pool."""
    cfg = tiny[0]
    hbm_gib = 0.002
    jsess, jplan, tsess, tplan = _sessions(J, tiny, hbm_gib=hbm_gib)
    kw = dict(batch_slots=SLOTS, max_seq=MAX_SEQ, scheduler="continuous",
              page_size=PAGE, prefill_chunk=CHUNK, num_pages=4000)
    with J.jax.set_mesh(jsess.mesh):
        with pytest.raises(J.PlanMemoryError, match="evict"):
            jsess.serve(jplan, **kw)
    with pytest.raises(PlanMemoryError, match="evict") as ei:
        tsess.serve(tplan, **kw)
    assert "serve/kv_pool" in str(ei.value)
    assert sorted(tsess.state.keys()) == sorted(jsess.state.keys()) \
        == ["serve/params"]
    del cfg


def test_params_of_another_model_are_refused_with_the_references_words(
        J, tiny):
    cfg = tiny[0]
    other = dataclasses.replace(cfg, d_model=64, head_dim=8)
    jsess, _, tsess, _ = _sessions(J, tiny)
    with J.jax.set_mesh(jsess.mesh):
        with pytest.raises(ValueError) as jerr:
            jsess.serve(jsess.plan(other, batch=SLOTS, seq=MAX_SEQ,
                                   kind="decode"),
                        batch_slots=SLOTS, max_seq=MAX_SEQ)
    with pytest.raises(ValueError) as terr:
        tsess.serve(tsess.plan(other, batch=SLOTS, seq=MAX_SEQ,
                               kind="decode"),
                    batch_slots=SLOTS, max_seq=MAX_SEQ)
    assert str(terr.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# autotune, the roofline gate, the backend
# ---------------------------------------------------------------------------

def _toy_candidates(mod, calls):
    def sleeper(name, s):
        def fn(x):
            calls.append(name)
            time.sleep(s)
            return x
        return fn

    def broken(x):
        calls.append("broken")
        raise RuntimeError("no")

    return [mod.Candidate("slow", sleeper("slow", 0.05)),
            mod.Candidate("fast", sleeper("fast", 0.01)),
            mod.Candidate("huge", sleeper("huge", 0.001),
                          workspace_bytes=10**9),
            mod.Candidate("broken", broken)]


def test_autotune_choice_memo_and_disqualifications_are_the_references(J):
    for budget in (10**6, None):
        results = []
        for mod in (J.autotune, autotune):
            calls = []
            tuner = mod.AutoTuner(budget_bytes=budget, warmup=1, iters=2)
            r = tuner.pick("k", _toy_candidates(mod, calls), 1)
            n = len(calls)
            again = tuner.pick("k", _toy_candidates(mod, calls), 1)
            assert again is r and len(calls) == n       # memoized
            assert list(tuner.choices()) == ["k"]
            results.append((r.name, r.disqualified, n))
        assert results[1] == results[0]
        assert results[1][0] == ("fast" if budget else "huge")
    for mod in (J.autotune, autotune):
        with pytest.raises(RuntimeError, match="every candidate"):
            mod.AutoTuner(budget_bytes=0).pick(
                "k", [mod.Candidate("a", lambda: 0, workspace_bytes=1)])


def test_autotune_waits_for_the_card_before_reading_the_clock(monkeypatch):
    """A candidate's CUDA result is waited for (``torch.cuda.synchronize``
    on its device) before the clock is read; a CPU result is not."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    waited = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: waited.append(str(device)))
    with FakeTensorMode():
        on_card = torch.empty(2, device="cuda")
    autotune._ready({"a": [torch.zeros(1)], "b": (torch.zeros(1),)})
    assert waited == []
    autotune._ready({"a": [torch.zeros(1), on_card]})
    assert waited == ["cuda:0"]
    tuner = autotune.AutoTuner(warmup=1, iters=2)
    assert tuner.pick("card", [autotune.Candidate(
        "c", lambda: on_card)]).name == "c"
    assert waited == ["cuda:0"] * 4


@pytest.mark.parametrize("flops,bytes_ref,bytes_fused", [
    (1e6, 10**6, 10**5), (1e12, 10**6, 10**5), (1e6, 10**5, 10**5),
    (3e9, 10**8, 10**7), (0.0, 0, 0)])
def test_roofline_gate_is_the_references_at_equal_constants(
        J, monkeypatch, flops, bytes_ref, bytes_fused):
    monkeypatch.setattr(roofline, "HBM_BYTES_PER_S",
                        J.roofline.HBM_BYTES_PER_S)
    assert roofline.ridge_intensity() == J.roofline.ridge_intensity()
    got = roofline.gate("op", flops=flops, bytes_ref=bytes_ref,
                        bytes_fused=bytes_fused)
    want = J.roofline.gate("op", flops=flops, bytes_ref=bytes_ref,
                           bytes_fused=bytes_fused)
    assert got.to_dict() == want.to_dict()


def test_roofline_holds_the_h100s_constants():
    assert roofline.HBM_BYTES_PER_S == 3.35e12
    assert round(roofline.BF16_FLOPS / roofline.HBM_BYTES_PER_S) == 295
    assert roofline.bound(3.35e9, 0.0) == (1.0, "bytes")
    assert roofline.bound(0.0, 989e9) == (1.0, "operations")
    assert roofline.causal_pairs(4, 4) == 10
    assert roofline.causal_pairs(2, 6, q_offset=4) == 11
    assert roofline.causal_pairs(4, 4, window=2) == 7


@pytest.mark.parametrize("device,cards,world,local,want", [
    ("cuda", 1, 1, 0, "nccl"),        # one rank on its card
    ("cuda", 4, 4, 3, "nccl"),        # every rank its own card
    ("cuda", 8, 4, 1, "nccl"),
    ("cuda", 1, 2, 0, "gloo"),        # two ranks share a card
    ("cuda", 1, 4, 3, "gloo"),        # four ranks on one card
    ("cuda", 2, 4, 1, "gloo"),
    ("cuda", 0, 1, 0, "gloo"),
    ("cpu", 8, 2, 0, "gloo"),         # CPU ranks
    ("cpu", 0, 1, 0, "gloo"),
])
def test_init_group_takes_nccl_only_for_ranks_with_cards_of_their_own(
        device, cards, world, local, want):
    assert select_backend(device, cards, world, local) == want


def test_the_new_entry_points_default_to_the_card(monkeypatch):
    """Without a card the Session, its serve CLI and ``init_group`` raise
    unless the CPU is asked for; the dry run, which runs nothing, traces
    fake CPU tensors there."""
    from repro_torch.core.distributed import init_group
    from repro_torch.launch import dryrun, serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (Session, lambda: init_group("file:///nonexistent",
                                             rank=0, world_size=1),
                 lambda: serve.run("qwen2-0.5b")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert dryrun.default_device() == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert dryrun.default_device() == "cuda"
