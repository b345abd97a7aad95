"""The rest of the dense family against the JAX reference: qk-norm
(qwen3-14b, gemma3-27b), gemma3's windowed dense cache (O(window) rings on
its local layers, a full cache on its global ones) through the model
steps and the static ``Engine``, and qwen3-14b and gemma-2b through the
port's three engines.

Tiny configs cut from the real ones: ``scale_config(..., 64)`` keeps each
family's topology, but gemma3 at that cut has 2 layers and so no global
layer, so its tests take 7 (one local:global group of 5 + 1 and a local
tail), with its window of 16 cut from 1,024 so that prompts wrap the
ring.  gemma-2b's cut has head dim 32; ``HD256`` keeps its 256.  Weights
come from the reference's init through ``from_jax``, with the qk-norm
scales (ones at init) drawn away from one so that they matter.

Tolerances as in ``test_torch_dense_cache.py``: fp32 results of the same
operands in another order at rtol 1e-5; anything stored in or computed
from bf16 at rtol 2e-2 with a floor of 2e-2 of the largest magnitude;
greedy streams by the margin rule (tokens equal up to and including the
first step whose reference top-1/top-2 margin is under twice 2% of the
largest reference logit).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro  # noqa: F401,E402  (installs the JAX compat shims)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.configs.base import scale_config as jscale_config  # noqa: E402
from repro.core import precision as jprecision  # noqa: E402
from repro.core.planner import plan_for  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve.engine import _make_prefill_fn  # noqa: E402

from repro_torch.core import precision  # noqa: E402
from repro_torch.models import Model, attention, layers  # noqa: E402
from repro_torch.models.params import from_jax  # noqa: E402
from repro_torch.serve import ContinuousEngine, Engine, Request  # noqa: E402

from test_torch_model import _bf16, _close, _normal, mesh  # noqa: E402,F401

G3 = dataclasses.replace(jscale_config(jget_config("gemma3-27b"), 64),
                         n_layers=7)
QWEN3 = jscale_config(jget_config("qwen3-14b"), 64)
GEMMA2B = jscale_config(jget_config("gemma-2b"), 64)
HD256 = dataclasses.replace(GEMMA2B, head_dim=256)
W = G3.window                                  # 16
MAX_SEQ = 48
# the stale-ring case: two prompts that wrap the ring, then two shorter
# ones refilling the same two slots
PROMPT_LENS = (23, 37, 6, 11)
NEW_TOKENS = 8
REL = 2e-2                  # logits within 2% of the largest reference one


def _jmodel(cfg, mesh, seed=0):
    """(JAX model, JAX params as numpy, port model, port params) on one
    set of weights, qk-norm scales drawn away from one."""
    with jax.set_mesh(mesh):
        jmodel = JModel(cfg, mesh, plan_for(cfg, mesh))
        params = jax.tree.map(np.asarray,
                              jmodel.init(jax.random.PRNGKey(seed)))
    attn = params["layers"]["attn"]
    for i, name in enumerate(("q_norm", "k_norm")):
        if name in attn:
            attn[name] = np.asarray(jnp.asarray(
                1.0 + _normal(20 + i, attn[name].shape, 0.3), jnp.bfloat16))
    return jmodel, params, Model(cfg, device="cpu"), from_jax(params)


@pytest.fixture(scope="module")
def g3(mesh):
    return _jmodel(G3, mesh)


@pytest.fixture(scope="module")
def qwen3(mesh):
    return _jmodel(QWEN3, mesh)


def _layer(params, i):
    return jax.tree.map(lambda a: a[i], params["layers"])


def _tokens(seed, n, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (1, n))


def _margin(logits):
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


# ---------------------------------------------------------------------------
# qk-norm
# ---------------------------------------------------------------------------

def test_qk_norm_specs_and_carry():
    """``attn_specs`` gains the (hd,) ``q_norm``/``k_norm`` ones, exactly
    where the reference's does, and ``from_jax`` carries them."""
    for cfg in (QWEN3, G3, GEMMA2B):
        got = Model(cfg, device="cpu").param_specs()
        have = {"layers.attn.q_norm", "layers.attn.k_norm"} <= set(got)
        assert have == cfg.qk_norm
        if cfg.qk_norm:
            spec = got["layers.attn.q_norm"]
            assert spec.shape == (cfg.n_layers, cfg.d_head)
            assert spec.init == "ones"


@pytest.mark.parametrize("arch", ["qwen3", "g3"])
def test_qk_norm_qkv_and_forward_match_reference(request, mesh, arch):
    """``_qkv`` (projections, per-head RMSNorm of q and k, rotary) and
    the full-sequence ``attention.forward`` with the K/V it writes, at a
    local layer's window for gemma3."""
    jmodel, params, _, tparams = request.getfixturevalue(arch)
    cfg = jmodel.cfg
    window = cfg.window
    jx, tx = _bf16(_normal(30, (2, 21, cfg.d_model)))
    pos = np.arange(21)
    lp = Model._layer(tparams, 0)
    with jax.set_mesh(mesh):
        jq, jk, jv = jattention._qkv(jx, _layer(params, 0)["attn"], cfg,
                                     jmodel.plan, jnp.asarray(pos),
                                     jprecision.MIXED)
        jy, (jkc, jvc) = jattention.forward(
            jx, _layer(params, 0)["attn"], cfg, jmodel.plan, mesh,
            policy=jprecision.MIXED, window=window, with_cache=True)
    tq, tk, tv = attention._qkv(tx, lp["attn"], cfg, torch.from_numpy(pos),
                                precision.MIXED)
    for got, want in ((tq, jq), (tk, jk), (tv, jv)):
        _close(got, want)
    ty, (tkc, tvc) = attention.forward(tx, lp["attn"], cfg, window=window,
                                       with_cache=True)
    _close(ty, jy)
    _close(tkc, jkc)
    _close(tvc, jvc)


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pos", [3, 15, 16, 40, [0, 15, 16, 37]],
                         ids=["warm", "full", "wrap", "wrapped", "per_slot"])
@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
def test_decode_attention_ring_matches_reference(pos, qdtype):
    B, Hq, Hkv, D = 4, 6, 2, 16
    q = _normal(40, (B, Hq, 1, D))
    jk, tk = _bf16(_normal(41, (B, W, Hkv, D)))
    jv, tv = _bf16(_normal(42, (B, W, Hkv, D)))
    pos = np.asarray(pos)
    jq, tq = (_bf16(q) if qdtype == "bfloat16"
              else (jnp.asarray(q), torch.from_numpy(q)))
    want = jlayers.decode_attention_ring(jq, jk, jv,
                                         jnp.asarray(pos, jnp.int32))
    got = layers.decode_attention_ring(tq, tk, tv, torch.from_numpy(pos))
    assert got.dtype == tq.dtype and got.shape == (B, Hq, 1, D)
    _close(got, want, exact_fp32=qdtype == "float32")


@pytest.mark.parametrize("pos", [5, 16, 29, [2, 15, 16, 45]],
                         ids=["warm", "wrap", "wrapped", "per_slot"])
def test_decode_ring_matches_reference(g3, mesh, pos):
    """One local layer's decode step: the new K/V at ring slot pos mod W,
    then attention through the paged-decode kernel's plain version with
    ``seq_lens = min(pos + 1, W)``, against the reference's
    ``decode_ring`` (``decode_attention_ring``)."""
    jmodel, params, _, tparams = g3
    B = 4
    shape = (B, W, G3.n_kv_heads, G3.d_head)
    jk, tk = _bf16(_normal(50, shape))
    jv, tv = _bf16(_normal(51, shape))
    pos = np.asarray(pos)
    jx, tx = _bf16(_normal(52, (B, 1, G3.d_model)))
    with jax.set_mesh(mesh):
        jy, jk2, jv2 = jattention.decode_ring(
            jx, _layer(params, 0)["attn"], G3, jmodel.plan, jk, jv,
            jnp.asarray(pos, jnp.int32), policy=jprecision.MIXED)
    lp = Model._layer(tparams, 0)
    ty, tk2, tv2 = attention.decode_ring(tx, lp["attn"], G3, tk, tv,
                                         torch.from_numpy(pos))
    assert tk2 is tk and tv2 is tv                  # updated in place
    _close(ty, jy)
    _close(tk, jk2)
    _close(tv, jv2)


def test_windowed_cache_specs_match_reference(g3):
    jmodel, _, tmodel, _ = g3
    for T in (8, MAX_SEQ):
        want = jmodel.cache_specs(3, T)
        got = tmodel.cache_specs(3, T)
        assert set(got) == set(want) == {"k_g", "v_g", "k_l", "v_l"}
        for name, spec in got.items():
            assert spec.shape == want[name].shape, name
            assert spec.dtype == torch.bfloat16 and spec.init == "zeros"
    assert got["k_l"].shape[:3] == (6, 3, W)         # layers 0-4 and 6
    assert got["k_g"].shape[:3] == (1, 3, MAX_SEQ)   # layer 5


@pytest.mark.parametrize("S", [11, 16, 29])
def test_prefill_ring_leaves_match_reference(g3, mesh, S):
    """``prefill`` without a cache: logits and each leaf, the local
    layers' rings (W' = min(16, S) slots, slot j holding the last p = j
    mod W') against the reference's ``k_l``/``v_l``, the global layer's
    K/V against ``k_g``/``v_g``."""
    jmodel, params, tmodel, tparams = g3
    tokens = _tokens(60 + S, S, G3.vocab_size)
    with jax.set_mesh(mesh):
        jl, jc = jax.jit(jmodel.prefill)(params, jnp.asarray(tokens))
    tl, tc = tmodel.prefill(tparams, torch.from_numpy(tokens))
    _close(tl, jl)
    assert set(tc) == set(jc)
    for name in tc:
        assert tuple(tc[name].shape) == jc[name].shape, name
        _close(tc[name], jc[name])
    assert tc["k_l"].shape[2] == min(W, S)


def test_prefill_and_decode_across_the_wrap_match_reference(g3, mesh):
    """Two prompts prefilled into rows 1 and 0 of a 2-slot cache (one
    wraps its ring, one does not), then decode steps at per-slot
    positions that carry the short one across the wrap; logits after
    each, every cache leaf at the end."""
    jmodel, params, tmodel, tparams = g3
    B = 2
    prompts = [_tokens(70 + i, n, G3.vocab_size)
               for i, n in enumerate((21, 12))]
    jcache = jmodel.init_cache(B, MAX_SEQ)
    tcache = tmodel.init_cache(B, MAX_SEQ)
    assert {n: tuple(t.shape) for n, t in tcache.items()} == {
        n: a.shape for n, a in jcache.items()}
    with jax.set_mesh(mesh):
        pre = jax.jit(_make_prefill_fn(jmodel))
        dec = jax.jit(jmodel.decode_step)
        for slot, prompt in zip((1, 0), prompts):
            jl, jcache = pre(params, jcache, jnp.asarray(prompt, jnp.int32),
                             jnp.asarray(slot, jnp.int32))
            tl, tcache2 = tmodel.prefill(tparams, torch.from_numpy(prompt),
                                         cache=tcache, slot=slot)
            assert tcache2 is tcache
            _close(tl[:, -1], jl)
        for name in tcache:
            _close(tcache[name], jcache[name])
        pos = np.array([12, 21])
        for step in range(7):                    # slot 0: 12 .. 18
            tok = np.array([[3 + step], [5 * step + 1]])
            jl, jcache = dec(params, jcache, jnp.asarray(tok, jnp.int32),
                             jnp.asarray(pos + step, jnp.int32))
            tl, _ = tmodel.decode_step(tparams, tcache, torch.from_numpy(tok),
                                       torch.from_numpy(pos + step))
            assert tl.shape == (B, 1, G3.padded_vocab)
            _close(tl, jl)
    for name in tcache:
        _close(tcache[name], jcache[name])


def test_decode_step_takes_a_scalar_position(g3, mesh):
    """The lockstep batch (scalar ``pos``) of the reference's signature,
    past the wrap."""
    jmodel, params, tmodel, tparams = g3
    tokens = _tokens(75, 19, G3.vocab_size)
    jcache = jmodel.init_cache(2, MAX_SEQ)
    tcache = tmodel.init_cache(2, MAX_SEQ)
    tok = np.array([[4], [9]])
    with jax.set_mesh(mesh):
        pre = jax.jit(_make_prefill_fn(jmodel))
        for slot in range(2):
            _, jcache = pre(params, jcache, jnp.asarray(tokens, jnp.int32),
                            jnp.asarray(slot, jnp.int32))
            tmodel.prefill(tparams, torch.from_numpy(tokens), cache=tcache,
                           slot=slot)
        jl, _ = jax.jit(jmodel.decode_step)(params, jcache, jnp.asarray(tok),
                                            jnp.asarray(19, jnp.int32))
    tl, _ = tmodel.decode_step(tparams, tcache, torch.from_numpy(tok),
                               torch.tensor(19))
    _close(tl, jl)


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

def _prompts(cfg):
    rng = np.random.default_rng(1)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in PROMPT_LENS]


def _port_run(tmodel, tparams, engine_cls, **kw):
    eng = engine_cls(tmodel, tparams, batch_slots=2, max_seq=MAX_SEQ, **kw)
    for rid, p in enumerate(_prompts(tmodel.cfg)):
        eng.submit(Request(rid=rid, prompt=p, max_new_tokens=NEW_TOKENS))
    fin = eng.run()
    assert len(fin) == len(PROMPT_LENS)
    return {r.rid: list(r.out) for r in fin}


@pytest.fixture(scope="module")
def g3_streams(g3, mesh):
    """The reference static Engine's greedy streams on gemma3 (two slots:
    the two wrapping prompts, then the two shorter ones refill their
    slots), and the reference's teacher-forced logits along them."""
    jmodel, params, _, _ = g3
    prompts = _prompts(G3)
    with jax.set_mesh(mesh):
        eng = JEngine(jmodel, params, batch_slots=2, max_seq=MAX_SEQ)
        for rid, p in enumerate(prompts):
            eng.submit(JRequest(rid=rid, prompt=p,
                                max_new_tokens=NEW_TOKENS))
        streams = {r.rid: list(r.out) for r in eng.run()}
        pre = jax.jit(_make_prefill_fn(jmodel))
        dec = jax.jit(jmodel.decode_step)
        B = len(prompts)
        jcache = jmodel.init_cache(B, MAX_SEQ)
        jl = np.zeros((B, NEW_TOKENS, G3.padded_vocab), np.float32)
        for b, p in enumerate(prompts):
            last, jcache = pre(params, jcache, jnp.asarray(p[None]),
                               jnp.asarray(b, jnp.int32))
            jl[b, 0] = np.asarray(last[0], np.float32)
        for s in range(1, NEW_TOKENS):
            tok = np.array([[streams[b][s - 1]] for b in range(B)])
            pos = np.array([len(p) + s - 1 for p in prompts])
            logits, jcache = dec(params, jcache, jnp.asarray(tok, jnp.int32),
                                 jnp.asarray(pos, jnp.int32))
            jl[:, s] = np.asarray(logits[:, 0], np.float32)
    return streams, jl


def test_gemma3_engine_matches_reference_where_margins_allow(g3,
                                                             g3_streams):
    """The port's static Engine on the ring cache: each stream equals the
    reference's up to its first low-margin step, the refilled slots (a
    shorter prompt on a ring a longer one wrapped) included."""
    _, _, tmodel, tparams = g3
    streams, jl = g3_streams
    atol = REL * np.abs(jl).max()
    got = _port_run(tmodel, tparams, Engine)
    compared = 0
    for rid, stream in streams.items():
        sure = _margin(jl[rid]) > 2 * atol
        n = int(np.argmin(sure)) if not sure.all() else NEW_TOKENS
        assert got[rid][:n + 1] == stream[:n + 1], rid
        compared += n
    assert compared > 0


def test_gemma3_refilled_slot_reads_nothing_stale(g3):
    """A slot whose ring a wrapping prompt filled, refilled with a short
    prompt, gives the tokens the short prompt gives on a fresh engine,
    and its rings end bitwise as the fresh engine's: the prefill pads the
    short prompt's ring with zeros, as the reference's does."""
    _, _, tmodel, tparams = g3
    prompts = _prompts(G3)
    used = Engine(tmodel, tparams, batch_slots=1, max_seq=MAX_SEQ)
    used.submit(Request(rid=0, prompt=prompts[1], max_new_tokens=NEW_TOKENS))
    used.run()
    # the slots the short prompt's prefill does not write hold values
    assert used.cache["k_l"][:, 0, len(prompts[2]):].abs().amax() > 0
    used.submit(Request(rid=1, prompt=prompts[2], max_new_tokens=NEW_TOKENS))
    stale = {r.rid: list(r.out) for r in used.run()}
    fresh = Engine(tmodel, tparams, batch_slots=1, max_seq=MAX_SEQ)
    fresh.submit(Request(rid=1, prompt=prompts[2],
                         max_new_tokens=NEW_TOKENS))
    assert {r.rid: list(r.out) for r in fresh.run()}[1] == stale[1]
    for name in ("k_l", "v_l"):
        assert torch.equal(used.cache[name], fresh.cache[name])


def test_windowed_config_refuses_the_paged_engines(g3):
    _, _, tmodel, tparams = g3
    assert not tmodel.paged_supported()
    with pytest.raises(ValueError, match="paged decode unsupported"):
        Engine(tmodel, tparams, batch_slots=2, max_seq=MAX_SEQ, paged=True,
               page_size=8, prefill_chunk=8)
    with pytest.raises(ValueError, match="paged decode unsupported"):
        ContinuousEngine(tmodel, tparams, batch_slots=2, max_seq=MAX_SEQ,
                         page_size=8, prefill_chunk=8)


@pytest.mark.parametrize("cfg", [QWEN3, GEMMA2B, HD256],
                         ids=["qwen3", "gemma2b", "gemma2b_hd256"])
def test_dense_equals_static_paged_equals_continuous(mesh, cfg):
    """qwen3-14b (qk-norm) and gemma-2b (MQA, GeGLU, ``emb_scale``; at
    its cut head dim 32 and at its own 256) through the port's three
    engines: the same greedy tokens."""
    _, _, tmodel, tparams = _jmodel(cfg, mesh)
    dense = _port_run(tmodel, tparams, Engine)
    paged = _port_run(tmodel, tparams, Engine, paged=True, page_size=8,
                      prefill_chunk=8)
    cont = _port_run(tmodel, tparams, ContinuousEngine, page_size=8,
                     prefill_chunk=8)
    assert dense == paged == cont


@pytest.mark.parametrize("arch", ["qwen3", "gemma2b_hd256"])
def test_dense_prefill_and_decode_match_reference(request, mesh, arch):
    """qwen3-14b's and gemma-2b's (head dim 256) dense prefill into a
    cache row and three decode steps against the reference's."""
    if arch == "qwen3":
        jmodel, params, tmodel, tparams = request.getfixturevalue("qwen3")
    else:
        jmodel, params, tmodel, tparams = _jmodel(HD256, mesh)
    cfg = jmodel.cfg
    prompt = _tokens(90, 13, cfg.vocab_size)
    jcache = jmodel.init_cache(1, 24)
    tcache = tmodel.init_cache(1, 24)
    with jax.set_mesh(mesh):
        jl, jcache = jax.jit(_make_prefill_fn(jmodel))(
            params, jcache, jnp.asarray(prompt, jnp.int32),
            jnp.asarray(0, jnp.int32))
        tl, _ = tmodel.prefill(tparams, torch.from_numpy(prompt),
                               cache=tcache, slot=0)
        _close(tl[:, -1], jl)
        dec = jax.jit(jmodel.decode_step)
        for step in range(3):
            tok = np.array([[7 + step]])
            pos = np.array([13 + step])
            jl, jcache = dec(params, jcache, jnp.asarray(tok, jnp.int32),
                             jnp.asarray(pos, jnp.int32))
            tl, _ = tmodel.decode_step(tparams, tcache, torch.from_numpy(tok),
                                       torch.from_numpy(pos))
            _close(tl, jl)
    for name in tcache:
        _close(tcache[name], jcache[name])


def test_qk_norm_leaves_round_trip_the_reference_checkpoint(qwen3, mesh,
                                                            tmp_path):
    """A qwen3-14b train state (with its ``q_norm``/``k_norm`` leaves)
    written by the reference restores bitwise in the port, and the port
    writes it back as the same files, byte for byte."""
    import filecmp
    import os

    from repro.checkpoint import CheckpointManager as JManager
    from repro.train import init_state

    from repro_torch.checkpoint import (CheckpointManager, state_from_tree,
                                        state_tree)
    jmodel, params, _, tparams = qwen3
    with jax.set_mesh(mesh):
        opt = init_state(jmodel, mesh, jax.random.PRNGKey(0)).opt
    jstate = {"params": params, "opt": jax.tree.map(np.asarray, opt)}
    JManager(str(tmp_path / "j")).save(2, jstate, blocking=True)
    got = state_from_tree(CheckpointManager(str(tmp_path / "j")).restore())
    assert set(got["params"]) == set(tparams)
    for name in ("layers.attn.q_norm", "layers.attn.k_norm"):
        assert torch.equal(got["params"][name].view(torch.int16),
                           tparams[name].view(torch.int16)), name
        want = jstate["opt"]["master"]["layers"]["attn"][name.split(".")[-1]]
        assert np.array_equal(got["opt"]["master"][name].numpy(), want), name
    CheckpointManager(str(tmp_path / "t")).save(2, state_tree(got),
                                                blocking=True)
    j, t = tmp_path / "j" / "step_2", tmp_path / "t" / "step_2"
    names = sorted(os.listdir(j))
    assert sorted(os.listdir(t)) == names
    assert any("q_norm" in n for n in names)
    _, mismatch, errors = filecmp.cmpfiles(j, t, names, shallow=False)
    assert mismatch == errors == []
