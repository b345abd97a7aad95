"""The dense family's dense KV cache against the JAX reference's: the
plain ``layers.decode_attention`` (the reference's decode oracle),
``attention.decode``, the dense ``Model.prefill`` / ``decode_step`` and
the static ``Engine(paged=False)``, and the port's own pin of its three
engines on one model.

Same tiny qwen2-shaped model and weights as ``test_torch_model.py`` (GQA
group 7, QKV bias non-zero).  Tolerances as there: fp32 results of the
same operands in another order at rtol 1e-5; anything stored in or
computed from bf16 at rtol 2e-2 with a floor of 2e-2 of the largest
magnitude.  Greedy streams follow ``test_torch_serve.py``'s margin rule:
logits within 2% of the largest reference logit, tokens equal up to and
including the first step whose reference top-1/top-2 margin is under
twice that.

The dense prefill runs the full-sequence forward (the wide fp32 MLP
product) and the paged prefill ``glu_mlp``'s bf16 product, in both
packages; the three engines' greedy tokens still agree on this model,
which pins the dense == paged == continuous equality the reference's
``tests/test_serve.py`` pins on its own tiny model.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import precision as jprecision  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve.engine import _make_prefill_fn  # noqa: E402

from repro_torch.models import Model, attention, layers  # noqa: E402
from repro_torch.serve import ContinuousEngine, Engine, Request  # noqa: E402

from test_torch_model import (CFG, _bf16, _close, _layer0,  # noqa: E402,F401
                              _normal, mesh, models)

MAX_SEQ, PAGE, CHUNK = 64, 8, 8
PROMPT_LENS = (5, 12, 20, 9)
NEW_TOKENS = 6


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, CFG.vocab_size, n).astype(np.int32)
            for n in PROMPT_LENS]


def _margin(logits):
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("per_slot", [False, True])
@pytest.mark.parametrize("window,softcap", [(None, None), (5, None),
                                            (None, 30.0), (7, 20.0)])
@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
def test_decode_attention_matches_reference(per_slot, window, softcap,
                                            qdtype):
    B, T, Hq, Hkv, D = 3, 24, 14, 2, 16
    q = _normal(60, (B, Hq, 1, D))
    jk, tk = _bf16(_normal(61, (B, T, Hkv, D)))
    jv, tv = _bf16(_normal(62, (B, T, Hkv, D)))
    pos = np.array([0, 9, 23]) if per_slot else np.array(13)
    if qdtype == "bfloat16":
        jq, tq = _bf16(q)
    else:
        jq, tq = jnp.asarray(q), torch.from_numpy(q)
    want = jlayers.decode_attention(jq, jk, jv, jnp.asarray(pos, jnp.int32),
                                    window=window, softcap=softcap)
    got = layers.decode_attention(tq, tk, tv, torch.from_numpy(pos),
                                  window=window, softcap=softcap)
    assert got.dtype == tq.dtype and got.shape == (B, Hq, 1, D)
    _close(got, want, exact_fp32=qdtype == "float32")


@pytest.mark.parametrize("per_slot", [False, True])
def test_attention_decode_matches_reference(models, mesh, per_slot):
    """One decode step on the dense cache: the new K/V at each slot's
    position, attention through the paged-decode kernel's plain version
    (each row one page) against the reference's ``decode_attention``."""
    jmodel, params, _, tparams = models
    B, T = 3, 32
    shape = (B, T, CFG.n_kv_heads, CFG.d_head)
    jk, tk = _bf16(_normal(70, shape))
    jv, tv = _bf16(_normal(71, shape))
    pos = np.array([0, 9, 31]) if per_slot else np.array(17)
    jx, tx = _bf16(_normal(72, (B, 1, CFG.d_model)))
    with jax.set_mesh(mesh):
        jy, jk2, jv2 = jattention.decode(
            jx, _layer0(params)["attn"], CFG, jmodel.plan, jk, jv,
            jnp.asarray(pos, jnp.int32), policy=jprecision.MIXED)
    lp = Model._layer(tparams, 0)
    ty, tk2, tv2 = attention.decode(tx, lp["attn"], CFG, tk, tv,
                                    torch.from_numpy(pos))
    assert tk2 is tk and tv2 is tv                  # updated in place
    _close(ty, jy)
    _close(tk, jk2)
    _close(tv, jv2)


def test_attention_decode_refuses_window_and_softcap(models):
    import dataclasses
    _, _, _, tparams = models
    lp = Model._layer(tparams, 0)
    shape = (2, 16, CFG.n_kv_heads, CFG.d_head)
    k, v = torch.zeros(shape, dtype=torch.bfloat16), torch.zeros(
        shape, dtype=torch.bfloat16)
    x = torch.zeros(2, 1, CFG.d_model, dtype=torch.bfloat16)
    pos = torch.tensor([1, 2])
    with pytest.raises(NotImplementedError, match="item 3"):
        attention.decode(x, lp["attn"], CFG, k, v, pos, window=4)
    capped = dataclasses.replace(CFG, attn_softcap=30.0)
    with pytest.raises(NotImplementedError, match="item 3"):
        attention.decode(x, lp["attn"], capped, k, v, pos)


# ---------------------------------------------------------------------------
# the dense model steps
# ---------------------------------------------------------------------------

def test_dense_prefill_and_decode_steps_match_reference(models, mesh):
    """Two prompts prefilled into rows 1 and 0 of a 2-slot cache (the
    engine's one-slot prefill), then three decode steps at per-slot
    positions; logits after each, the whole cache at the end."""
    jmodel, params, tmodel, tparams = models
    B, T = 2, 32
    prompts = [np.random.default_rng(80 + i).integers(
        0, CFG.vocab_size, (1, n)) for i, n in enumerate((11, 5))]
    jcache = jmodel.init_cache(B, T)
    tcache = tmodel.init_cache(B, T)
    assert set(tcache) == {"k", "v"}
    assert tcache["k"].shape == (CFG.n_layers, B, T, CFG.n_kv_heads,
                                 CFG.d_head)
    assert tcache["k"].dtype == torch.bfloat16
    with jax.set_mesh(mesh):
        pre = jax.jit(_make_prefill_fn(jmodel))
        dec = jax.jit(jmodel.decode_step)
        for slot, prompt in zip((1, 0), prompts):
            jl, jcache = pre(params, jcache, jnp.asarray(prompt, jnp.int32),
                             jnp.asarray(slot, jnp.int32))
            tl, tcache2 = tmodel.prefill(tparams, torch.from_numpy(prompt),
                                         cache=tcache, slot=slot)
            assert tcache2 is tcache and tl.shape == (1, 1,
                                                      CFG.padded_vocab)
            _close(tl[:, -1], jl)
        pos = np.array([5, 11])
        for step in range(3):
            tok = np.array([[3 + step], [7 * step + 1]])
            jl, jcache = dec(params, jcache, jnp.asarray(tok, jnp.int32),
                             jnp.asarray(pos + step, jnp.int32))
            tl, _ = tmodel.decode_step(tparams, tcache, torch.from_numpy(tok),
                                       torch.from_numpy(pos + step))
            assert tl.shape == (B, 1, CFG.padded_vocab)
            _close(tl, jl)
    _close(tcache["k"], jcache["k"])
    _close(tcache["v"], jcache["v"])


def test_dense_prefill_without_a_cache_matches_the_forward(models):
    """``prefill`` with no cache returns the stacked K/V of the prompt;
    written into a cache row it equals those rows, bitwise."""
    _, _, tmodel, tparams = models
    tokens = torch.from_numpy(np.random.default_rng(85).integers(
        0, CFG.vocab_size, (1, 9)))
    logits, kv = tmodel.prefill(tparams, tokens)
    assert set(kv) == {"k", "v"} and kv["k"].shape == (
        CFG.n_layers, 1, 9, CFG.n_kv_heads, CFG.d_head)
    last, _, _ = tmodel.forward(tparams, tokens, last_only=True)
    assert torch.equal(logits, last)
    cache = tmodel.init_cache(3, 16)
    logits2, _ = tmodel.prefill(tparams, tokens, cache=cache, slot=2)
    assert torch.equal(logits2, logits)
    for name in ("k", "v"):
        assert torch.equal(cache[name][:, 2, :9], kv[name][:, 0])
        assert not cache[name][:, :2].any() and not cache[name][:, 2,
                                                                 9:].any()


# ---------------------------------------------------------------------------
# the static dense-cache engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_dense(models, mesh):
    """The reference dense Engine's greedy streams, and the reference's
    and the port's teacher-forced logits along them (each prompt
    prefilled into its own slot, then decode steps fed the streams)."""
    jmodel, params, tmodel, tparams = models
    prompts = _prompts()
    with jax.set_mesh(mesh):
        eng = JEngine(jmodel, params, batch_slots=2, max_seq=MAX_SEQ)
        for rid, p in enumerate(prompts):
            eng.submit(JRequest(rid=rid, prompt=p,
                                max_new_tokens=NEW_TOKENS))
        streams = {r.rid: list(r.out) for r in eng.run()}
        assert len(streams) == len(prompts)
        B = len(prompts)
        pre = jax.jit(_make_prefill_fn(jmodel))
        dec = jax.jit(jmodel.decode_step)
        jcache = jmodel.init_cache(B, MAX_SEQ)
        jl = np.zeros((B, NEW_TOKENS, CFG.padded_vocab), np.float32)
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
    tcache = tmodel.init_cache(B, MAX_SEQ)
    tl = np.zeros_like(jl)
    for b, p in enumerate(prompts):
        last, _ = tmodel.prefill(tparams, torch.from_numpy(
            p[None].astype(np.int64)), cache=tcache, slot=b)
        tl[b, 0] = last[0, -1].numpy()
    for s in range(1, NEW_TOKENS):
        tok = np.array([[streams[b][s - 1]] for b in range(B)])
        pos = np.array([len(p) + s - 1 for p in prompts])
        logits, _ = tmodel.decode_step(tparams, tcache,
                                       torch.from_numpy(tok),
                                       torch.from_numpy(pos))
        tl[:, s] = logits[:, 0].numpy()
    return streams, jl, tl


def _port_run(models, engine_cls, **kw):
    _, _, tmodel, tparams = models
    eng = engine_cls(tmodel, tparams, batch_slots=2, max_seq=MAX_SEQ, **kw)
    for rid, p in enumerate(_prompts()):
        eng.submit(Request(rid=rid, prompt=p, max_new_tokens=NEW_TOKENS))
    fin = eng.run()
    assert len(fin) == len(PROMPT_LENS)
    return {r.rid: list(r.out) for r in fin}


def test_dense_teacher_forced_logits_match_reference(jax_dense):
    streams, jl, tl = jax_dense
    assert np.isfinite(tl).all()
    atol = 2e-2 * np.abs(jl).max()
    np.testing.assert_allclose(tl, jl, rtol=0, atol=atol)
    assert (jl.argmax(-1) == np.array(
        [streams[b] for b in range(len(PROMPT_LENS))])).all()


def test_dense_engine_matches_reference_where_margins_allow(models,
                                                            jax_dense):
    streams, jl, _ = jax_dense
    atol = 2e-2 * np.abs(jl).max()
    got = _port_run(models, Engine)
    compared = 0
    for rid, stream in streams.items():
        sure = _margin(jl[rid]) > 2 * atol
        n = int(np.argmin(sure)) if not sure.all() else NEW_TOKENS
        assert got[rid][:n + 1] == stream[:n + 1], rid
        compared += n
    assert compared > 0


def test_dense_equals_static_paged_equals_continuous(models):
    """The port's own pin: the dense-cache engine (default), the static
    paged engine and continuous batching give the same greedy tokens."""
    dense = _port_run(models, Engine)
    paged = _port_run(models, Engine, paged=True, page_size=PAGE,
                      prefill_chunk=CHUNK)
    cont = _port_run(models, ContinuousEngine, page_size=PAGE,
                     prefill_chunk=CHUNK)
    assert dense == paged == cont


def test_dense_engine_keeps_one_table_and_reads_nothing_stale(models):
    """The engine's (B, 1) table is made once and stays the same tensor;
    a refilled slot's stale positions past its new prompt are never read
    (a run over a used cache gives the tokens of a fresh one)."""
    _, _, tmodel, tparams = models
    eng = Engine(tmodel, tparams, batch_slots=2, max_seq=MAX_SEQ)
    table = eng._table
    assert table.dtype == torch.int32 and table.tolist() == [[0], [1]]
    for rid, p in enumerate(_prompts()):
        eng.submit(Request(rid=rid, prompt=p, max_new_tokens=NEW_TOKENS))
    first = {r.rid: list(r.out) for r in eng.run()}
    assert eng._table is table
    eng.finished.clear()
    for rid, p in enumerate(_prompts()):
        eng.submit(Request(rid=rid, prompt=p, max_new_tokens=NEW_TOKENS))
    again = {r.rid: list(r.out) for r in eng.run()}
    assert again == first == _port_run(models, Engine)
