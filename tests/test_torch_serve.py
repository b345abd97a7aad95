"""The serve slice end to end: the port's engines against the JAX
reference's, and the port's own static == continuous pin.

Same tiny qwen2-shaped model and weights as ``test_torch_model.py``.  The
reference's ``ContinuousEngine`` generates greedy streams; both packages'
serve steps then replay those streams teacher-forced (chunked paged
prefill of the prompt, then one decode step per generated token), so a
difference at one step cannot compound into the next.

Tolerance: bf16 activations round at different places in XLA and in
PyTorch, and a flipped rounding moves an activation by 2^-8 of itself;
through two layers and the unembed that moves a logit by a small fraction
of the logits' spread.  Each logit must agree within ``LOGIT_ATOL``, set
to 2% of the largest reference logit (measured: 0.32%).  A greedy
token can then only flip where the reference's top-1/top-2 margin is at
most ``2 * LOGIT_ATOL``, so tokens must agree wherever the margin exceeds
that.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.serve import ContinuousEngine as JContinuousEngine  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402

from repro_torch.serve import ContinuousEngine, Engine, Request  # noqa: E402

from test_torch_model import CFG, mesh, models  # noqa: E402,F401 (fixtures)

PAGE, MAX_SEQ, CHUNK = 8, 64, 8
PROMPT_LENS = (5, 12, 20, 9)
NEW_TOKENS = 6


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, CFG.vocab_size, n).astype(np.int32)
            for n in PROMPT_LENS]


@pytest.fixture(scope="module")
def jax_streams(models, mesh):
    """Greedy streams from the reference's continuous engine."""
    jmodel, params, _, _ = models
    with jax.set_mesh(mesh):
        eng = JContinuousEngine(jmodel, params, batch_slots=2,
                                max_seq=MAX_SEQ, page_size=PAGE,
                                prefill_chunk=CHUNK)
        for rid, p in enumerate(_prompts()):
            eng.submit(JRequest(rid=rid, prompt=p, max_new_tokens=NEW_TOKENS))
        fin = eng.run()
    assert len(fin) == len(PROMPT_LENS)
    return {r.rid: list(r.out) for r in fin}


def _teacher_forced(prefill, decode, cache, table, streams, to_tokens):
    """Logits (n_req, NEW_TOKENS, V) at every generated position: chunked
    prefill of each prompt into its slot, then decode steps fed the
    reference's tokens."""
    prompts = _prompts()
    B = len(prompts)
    out = np.zeros((B, NEW_TOKENS, CFG.padded_vocab), np.float32)
    for b, p in enumerate(prompts):
        for start in range(0, len(p), CHUNK):
            chunk = np.zeros((1, CHUNK), np.int64)
            n = min(CHUNK, len(p) - start)
            chunk[0, :n] = p[start:start + n]
            logits, cache = prefill(cache, to_tokens(chunk), table[b], start)
        out[b, 0] = np.asarray(logits[0, n - 1], np.float32)
    for s in range(1, NEW_TOKENS):
        tok = np.array([[streams[b][s - 1]] for b in range(B)], np.int64)
        pos = np.array([len(p) + s - 1 for p in prompts], np.int64)
        logits, cache = decode(cache, to_tokens(tok), pos)
        out[:, s] = np.asarray(logits[:, 0], np.float32)
    return out


@pytest.fixture(scope="module")
def forced(models, mesh, jax_streams):
    jmodel, params, tmodel, tparams = models
    B = len(PROMPT_LENS)
    with jax.set_mesh(mesh):
        pre = jax.jit(jmodel.prefill_chunk_paged)
        dec = jax.jit(jmodel.decode_step_paged)
        jcache = jmodel.init_paged_cache(B, MAX_SEQ, PAGE)
        jl = _teacher_forced(
            lambda c, t, row, s: pre(params, c, t, row,
                                     jnp.asarray(s, jnp.int32)),
            lambda c, t, pos: dec(params, c, t, jnp.asarray(pos, jnp.int32)),
            jcache, jcache["table"], jax_streams,
            lambda x: jnp.asarray(x, jnp.int32))
    tcache = tmodel.init_paged_cache(B, MAX_SEQ, PAGE)
    tl = _teacher_forced(
        lambda c, t, row, s: tmodel.prefill_chunk_paged(tparams, c, t, row,
                                                        s),
        lambda c, t, pos: tmodel.decode_step_paged(tparams, c, t,
                                                   torch.from_numpy(pos)),
        tcache, tcache["table"], jax_streams, torch.from_numpy)
    return jl, tl


def _margin(logits):
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


def test_teacher_forced_logits_and_tokens_match_reference(forced,
                                                          jax_streams):
    jl, tl = forced
    assert np.isfinite(tl).all()
    atol = 2e-2 * np.abs(jl).max()
    np.testing.assert_allclose(tl, jl, rtol=0, atol=atol)
    # the reference's argmax under teacher forcing is its own stream
    assert (jl.argmax(-1) == np.array(
        [jax_streams[b] for b in range(len(PROMPT_LENS))])).all()
    sure = _margin(jl) > 2 * atol
    assert sure.mean() > 0.5
    assert (tl.argmax(-1)[sure] == jl.argmax(-1)[sure]).all()


def _port_run(engine_cls, models, **kw):
    _, _, tmodel, tparams = models
    eng = engine_cls(tmodel, tparams, batch_slots=2, max_seq=MAX_SEQ,
                     page_size=PAGE, prefill_chunk=CHUNK, **kw)
    for rid, p in enumerate(_prompts()):
        eng.submit(Request(rid=rid, prompt=p, max_new_tokens=NEW_TOKENS))
    fin = eng.run()
    assert len(fin) == len(PROMPT_LENS)
    return {r.rid: list(r.out) for r in fin}, fin


def test_continuous_engine_matches_reference_where_margins_allow(
        models, forced, jax_streams):
    jl, _ = forced
    atol = 2e-2 * np.abs(jl).max()
    got, _ = _port_run(ContinuousEngine, models)
    compared = 0
    for rid, stream in jax_streams.items():
        sure = _margin(jl[rid]) > 2 * atol
        n = int(np.argmin(sure)) if not sure.all() else NEW_TOKENS
        # tokens agree up to (and including) the first low-margin step
        assert got[rid][:n + 1] == stream[:n + 1], rid
        compared += n
    assert compared > 0


def test_static_paged_equals_continuous_token_for_token(models):
    """The port's own pin (as the reference's test_serve pins its engines):
    same model steps, physically permuted pages, identical tokens."""
    static, _ = _port_run(Engine, models, paged=True)
    assert _port_run(ContinuousEngine, models)[0] == static
    # a pool too small for both slots' growth forces preempt-and-requeue
    # and page recycling; greedy restarts regenerate the same tokens
    small, fin = _port_run(ContinuousEngine, models, num_pages=5)
    assert sum(r.n_preempted for r in fin) > 0
    assert small == static


def test_engines_refuse_chunks_that_do_not_divide_the_row(models):
    _, _, tmodel, tparams = models
    for cls, kw in ((Engine, dict(paged=True)), (ContinuousEngine, {})):
        with pytest.raises(ValueError, match="does not divide"):
            cls(tmodel, tparams, batch_slots=2, max_seq=MAX_SEQ,
                page_size=PAGE, prefill_chunk=24, **kw)
