"""Serving on a mesh for the dense family against the JAX reference's.

The reference runs in three children on 4 fake CPU devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``), one a mesh; the
port as 4 CPU ranks of one gloo group (``python -c`` subprocesses, a
``file://`` rendezvous in ``tmp_path``), all started together.  Both
take the same weights: bf16 values drawn by numpy in this process (the
port's leaf names, the reference's tree by ``nest_names``).  The model is
``test_torch_model.py``'s qwen2-shaped cut (14 query heads on 2 kv heads,
qkv bias), so (1,4) runs SP attention with the MLP replicated and (2,2)
head-TP with the MLP blocked over ``model``, as qwen2-0.5b does.

- ``Model.prefill`` (no cache: its logits and this rank's block of the
  reference's K/V) and then three ``decode_step`` s on a 32-position
  cache, the prompt's K/V written into it, at (1,4) and (2,2) with 4 rows,
  and decode alone at batch 1 on (2,2) and (4,1), where the sequence
  takes (data, model).  Held at the one-rank serve parity tolerance of
  ``test_torch_dense_cache.py``: rtol 2e-2 with a floor of 2e-2 of the
  largest reference magnitude.
- ``ContinuousEngine`` greedy tokens bitwise the reference's on (2,2),
  (1,4) and (4,1); the static ``Engine`` bitwise the reference's on
  (1,4) at prompt lengths the model axis divides, and bitwise the port's
  one-rank ``Engine`` on (2,2) and at ragged lengths, where the
  reference's one-slot prefill raises (a batch of 1 does not split over
  ``data``; a ragged prompt does not split over ``model``).
- Every rank's tokens are the same, the logits the same bits on every
  rank, and each rank's cache and pool bytes equal the global bytes over
  its shards.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
RANKS = 4
MESHES = ("1x4", "2x2", "4x1")
B, S, T, STEPS = 4, 8, 32, 3
EVEN_LENS = (8, 12, 4, 16, 8)            # the model axis divides them
RAGGED_LENS = (5, 11, 3, 9, 7)
NEW = 4
SLOTS, MAX_SEQ, PAGE, CHUNK = 2, 64, 8, 8

_COMMON = textwrap.dedent("""
    import dataclasses, json, sys
    import numpy as np
    CFG_FIELDS = dict(n_layers=2, d_model=128, n_heads=14, n_kv_heads=2,
                      head_dim=16, d_ff=256, vocab_size=512)
    B, S, T, STEPS = %d, %d, %d, %d
    EVEN_LENS, RAGGED_LENS, NEW = %r, %r, %d
    SLOTS, MAX_SEQ, PAGE, CHUNK = %d, %d, %d, %d

    def prompts(lens, seed):
        rng = np.random.default_rng(seed)
        return [rng.integers(0, 512, n).astype(np.int32) for n in lens]

    def steps_tokens(b):
        rng = np.random.default_rng(90 + b)
        return [rng.integers(0, 512, (b, 1)) for _ in range(STEPS)]
""" % (B, S, T, STEPS, EVEN_LENS, RAGGED_LENS, NEW, SLOTS, MAX_SEQ, PAGE,
       CHUNK))

_JAX_SIDE = _COMMON + textwrap.dedent("""
    import repro  # noqa: F401
    import jax, jax.numpy as jnp
    from repro.configs import get_config
    from repro.core.planner import plan_for
    from repro.launch.mesh import make_mesh
    from repro.models import Model
    from repro.serve import ContinuousEngine, Engine, Request
    from repro_torch.models.params import nest_names

    params_path, out_path, shape = sys.argv[1], sys.argv[2], sys.argv[3]
    cfg = dataclasses.replace(get_config("qwen2-0.5b"), **CFG_FIELDS)
    dims = tuple(int(x) for x in shape.split("x"))
    mesh = make_mesh(dims, ("data", "model"))
    out = {}
    with jax.set_mesh(mesh):
        model = Model(cfg, mesh, plan_for(cfg, mesh), q_chunk=16,
                      kv_chunk=16)
        like = model.init(jax.random.PRNGKey(0))
        flat = dict(np.load(params_path))
        params = jax.tree.map(lambda l, x: jnp.asarray(x, l.dtype), like,
                              nest_names(flat))
        params = jax.device_put(params, model.param_shardings())

        def run(eng, lens, seed):
            for i, p in enumerate(prompts(lens, seed)):
                eng.submit(Request(rid=i, prompt=p, max_new_tokens=NEW))
            return {str(r.rid): [int(t) for t in r.out] for r in eng.run()}

        if shape != "4x1":
            toks = np.random.default_rng(80).integers(0, 512, (B, S))
            logits, kv = jax.jit(model.prefill)(params, jnp.asarray(toks))
            out["prefill"] = np.asarray(logits, np.float32)
            out["prefill_k"] = np.asarray(kv["k"], np.float32)
            cache = model.init_cache(B, T)
            cache = {n: cache[n].at[:, :, :S].set(kv[n]) for n in cache}
            dec = jax.jit(model.decode_step)
            for i, tok in enumerate(steps_tokens(B)):
                lg, cache = dec(params, cache, jnp.asarray(tok, jnp.int32),
                                jnp.full((B,), S + i, jnp.int32))
                out[f"decode{i}"] = np.asarray(lg, np.float32)
        if shape != "1x4":
            cache = model.init_cache(1, T)
            dec = jax.jit(model.decode_step)
            for i, tok in enumerate(steps_tokens(1)):
                lg, cache = dec(params, cache, jnp.asarray(tok, jnp.int32),
                                jnp.asarray([i], jnp.int32))
                out[f"b1_{i}"] = np.asarray(lg, np.float32)
        out["tokens"] = {
            "continuous": run(ContinuousEngine(
                model, params, batch_slots=SLOTS, max_seq=MAX_SEQ,
                page_size=PAGE, prefill_chunk=CHUNK), RAGGED_LENS, 7),
            "continuous_wide": run(ContinuousEngine(
                model, params, batch_slots=SLOTS, max_seq=MAX_SEQ,
                page_size=PAGE, prefill_chunk=2 * CHUNK), RAGGED_LENS, 7)}
        if shape == "1x4":
            out["tokens"]["engine_even"] = run(Engine(
                model, params, batch_slots=SLOTS, max_seq=MAX_SEQ),
                EVEN_LENS, 8)
    toks = out.pop("tokens")
    np.savez(out_path, tokens=json.dumps(toks), **out)
""")

_PORT_RANK = _COMMON + textwrap.dedent("""
    import torch
    torch.set_num_threads(1)
    from repro_torch.configs import get_config
    from repro_torch.core import distributed as D
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model
    from repro_torch.serve import ContinuousEngine, Engine, Request

    params_path, rank, init, out_path = sys.argv[1:5]
    rank = int(rank)
    cfg = dataclasses.replace(get_config("qwen2-0.5b"), **CFG_FIELDS)
    flat = {k: torch.from_numpy(v).to(torch.bfloat16)
            for k, v in np.load(params_path).items()}
    one = Model(cfg, device="cpu")
    D.init_group(init, rank=rank, world_size=4, backend="gloo",
                 device="cpu")
    out = {}

    def run(eng, lens, seed):
        for i, p in enumerate(prompts(lens, seed)):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=NEW))
        return {str(r.rid): [int(t) for t in r.out] for r in eng.run()}

    def cache_bytes(c):
        return sum(t.numel() * t.element_size() for t in c.values()
                   if t.dtype == torch.bfloat16)

    toks_out = {}
    for shape in %r:
        dims = tuple(int(x) for x in shape.split("x"))
        mesh = make_mesh(dims, ("data", "model"))
        model = Model(cfg, device="cpu", mesh=mesh)
        params = model.shard(flat)
        tag = f"{shape}|{rank}"
        if shape != "4x1":
            toks = np.random.default_rng(80).integers(0, 512, (B, S))
            logits, kv = model.prefill(params, torch.from_numpy(toks))
            out[f"prefill@{tag}"] = logits.float().numpy()
            out[f"prefill_k@{tag}"] = kv["k"].float().numpy()
            out[f"prefill_kv@{tag}"] = np.asarray(
                [kv.offset, kv["k"].shape[1], kv["k"].shape[2]])
            cache = model.init_cache(B, T)
            for b in range(B):
                model.prefill(params, torch.from_numpy(toks[b:b + 1]),
                              cache=cache, slot=b)
            out[f"cache_bytes@{tag}"] = np.asarray(
                [cache_bytes(cache), cache_bytes(one.init_cache(B, T))])
            for i, tok in enumerate(steps_tokens(B)):
                lg, _ = model.decode_step(params, cache,
                                          torch.from_numpy(tok),
                                          torch.full((B,), S + i))
                out[f"decode{i}@{tag}"] = lg.float().numpy()
        if shape != "1x4":
            cache = model.init_cache(1, T)
            for i, tok in enumerate(steps_tokens(1)):
                lg, _ = model.decode_step(params, cache,
                                          torch.from_numpy(tok),
                                          torch.tensor([i]))
                out[f"b1_{i}@{tag}"] = lg.float().numpy()
        cont = ContinuousEngine(model, params, batch_slots=SLOTS,
                                max_seq=MAX_SEQ, page_size=PAGE,
                                prefill_chunk=CHUNK)
        out[f"pool_bytes@{tag}"] = np.asarray(
            [cache_bytes(cont.cache), cont.blocks.num_pages])
        # a prefill chunk over 4 live pages: each rank sends the pages it
        # holds, so a row on one rank's pages moves more than a row spread
        # over the ranks (pages 1.. on rank (p - 1) mod 4)
        chunk = torch.from_numpy(np.random.default_rng(5).integers(
            0, 512, (1, CHUNK)))
        wire = []
        for row in ([1, 2, 3, 4, 5, 6, 7, 8],
                    [1, 5, 9, 13, 17, 21, 25, 29]):
            pool = model.init_paged_pool(33, PAGE)
            D.WIRE.reset()
            model.prefill_chunk_paged(params, pool, chunk,
                                      torch.tensor(row, dtype=torch.int32),
                                      3 * PAGE)
            wire.append(D.WIRE.bytes["all_gather"])
        out[f"chunk_wire@{tag}"] = np.asarray(wire)
        got = {"continuous": run(cont, RAGGED_LENS, 7),
               "continuous_wide": run(ContinuousEngine(
                   model, params, batch_slots=SLOTS, max_seq=MAX_SEQ,
                   page_size=PAGE, prefill_chunk=2 * CHUNK), RAGGED_LENS, 7),
               "engine_ragged": run(Engine(model, params, batch_slots=SLOTS,
                                           max_seq=MAX_SEQ), RAGGED_LENS, 9),
               "engine_even": run(Engine(model, params, batch_slots=SLOTS,
                                         max_seq=MAX_SEQ), EVEN_LENS, 8)}
        if shape == "2x2":
            # Session.serve on the session's mesh, on the same params, and
            # the serve CLI's run(mesh=)
            from repro_torch.api import Session
            from repro_torch.launch import serve as serve_cli
            sess = Session(device="cpu", mesh=mesh)
            plan = sess.plan(cfg, batch=SLOTS, seq=MAX_SEQ, kind="decode")
            sess.state.put("serve/params", params, kind="params")
            got["session"] = run(sess.serve(plan, batch_slots=SLOTS,
                                            max_seq=MAX_SEQ),
                                 RAGGED_LENS, 9)
            total, _ = serve_cli.run(
                "qwen2-0.5b", n_requests=3, batch_slots=2, max_seq=32,
                prompt_len=(3, 9), new_tokens=2, scale_down=16,
                device="cpu", mesh=mesh)
            got["cli_tokens"] = total
        toks_out[shape] = got
    if rank == 0:
        toks_out["one"] = {
            "engine_ragged": run(Engine(one, flat, batch_slots=SLOTS,
                                        max_seq=MAX_SEQ), RAGGED_LENS, 9),
            "engine_even": run(Engine(one, flat, batch_slots=SLOTS,
                                      max_seq=MAX_SEQ), EVEN_LENS, 8)}
    np.savez(out_path, tokens=json.dumps(toks_out), **out)
    D.close_group()
""" % (MESHES,))


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), **extra)
    env.setdefault("JAX_PLATFORMS", "cpu")
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(port: {key: array}, port tokens by rank, reference by mesh)."""
    pytest.importorskip("jax")
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    import dataclasses
    tmp = tmp_path_factory.mktemp("serve_mesh")
    cfg = dataclasses.replace(get_config("qwen2-0.5b"), n_layers=2,
                              d_model=128, n_heads=14, n_kv_heads=2,
                              head_dim=16, d_ff=256, vocab_size=512)
    params = Model(cfg, device="cpu").init(3)
    for i, name in enumerate(("bq", "bk", "bv")):       # non-zero biases
        g = torch.Generator().manual_seed(10 + i)
        leaf = params[f"layers.attn.{name}"]
        leaf.copy_((torch.randn(leaf.shape, generator=g) * 0.5).to(
            leaf.dtype))
    np.savez(tmp / "params.npz", **{k: v.float().numpy()
                                    for k, v in params.items()})
    jax_procs = {shape: subprocess.Popen(
        [sys.executable, "-c", _JAX_SIDE, str(tmp / "params.npz"),
         str(tmp / f"jax_{shape}.npz"), shape],
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for shape in MESHES}
    init = f"file://{tmp / 'rendezvous'}"
    ranks = [subprocess.Popen(
        [sys.executable, "-c", _PORT_RANK, str(tmp / "params.npz"), str(r),
         init, str(tmp / f"t{r}.npz")],
        env=_env(OMP_NUM_THREADS="1"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(RANKS)]
    for p in ranks:
        out = p.communicate(timeout=900)[0]
        assert p.returncode == 0, out[-3000:]
    ref = {}
    for shape, p in jax_procs.items():
        out = p.communicate(timeout=900)[0]
        assert p.returncode == 0, out[-3000:]
        got = dict(np.load(tmp / f"jax_{shape}.npz"))
        got["tokens"] = json.loads(str(got["tokens"]))
        ref[shape] = got
    port, tokens = {}, []
    for r in range(RANKS):
        got = dict(np.load(tmp / f"t{r}.npz"))
        tokens.append(json.loads(str(got.pop("tokens"))))
        port.update(got)
    return port, tokens, ref


def _close(got, want):
    """The one-rank serve parity tolerance (``test_torch_dense_cache``):
    rtol 2e-2, atol 2e-2 of the largest reference magnitude."""
    np.testing.assert_allclose(got, want, rtol=2e-2,
                               atol=2e-2 * float(np.abs(want).max()))


def _kv_block(full, shape, r, offset, b_loc, t_loc):
    """Rank r's block of the reference's (L, B, S, Hkv, hd) K: its rows
    (the data coordinate's, where they split) and its sequence shard."""
    dims = tuple(int(x) for x in shape.split("x"))
    d = np.unravel_index(r, dims)[0]
    rows = slice(d * b_loc, (d + 1) * b_loc) if b_loc < full.shape[1] \
        else slice(None)
    return full[:, rows, offset:offset + t_loc]


@pytest.mark.parametrize("shape", ["1x4", "2x2"])
def test_prefill_and_decode_logits_match_the_reference(runs, shape):
    port, _, ref = runs
    want = ref[shape]
    for r in range(RANKS):
        tag = f"{shape}|{r}"
        _close(port[f"prefill@{tag}"], want["prefill"])
        offset, b_loc, t_loc = (int(x) for x in port[f"prefill_kv@{tag}"])
        _close(port[f"prefill_k@{tag}"],
               _kv_block(want["prefill_k"], shape, r, offset, b_loc, t_loc))
        for i in range(STEPS):
            _close(port[f"decode{i}@{tag}"], want[f"decode{i}"])
            assert np.array_equal(port[f"decode{i}@{tag}"],
                                  port[f"decode{i}@{shape}|0"])


@pytest.mark.parametrize("shape", ["2x2", "4x1"])
def test_batch_one_decode_over_every_axis_matches_the_reference(runs,
                                                                shape):
    """One row on a mesh whose data axis it cannot split: the sequence
    over (data, model), every rank decoding the row."""
    port, _, ref = runs
    for r in range(RANKS):
        for i in range(STEPS):
            _close(port[f"b1_{i}@{shape}|{r}"], ref[shape][f"b1_{i}"])


@pytest.mark.parametrize("shape", MESHES)
def test_continuous_engine_tokens_are_the_references(runs, shape):
    _, tokens, ref = runs
    want = ref[shape]["tokens"]["continuous"]
    assert len(want) == len(RAGGED_LENS)
    assert all(len(out) == NEW for out in want.values())
    for r in range(RANKS):
        assert tokens[r][shape]["continuous"] == want


def test_static_engine_tokens_on_1x4_are_the_references(runs):
    _, tokens, ref = runs
    for r in range(RANKS):
        assert tokens[r]["1x4"]["engine_even"] == \
            ref["1x4"]["tokens"]["engine_even"]


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("which", ["engine_even", "engine_ragged"])
def test_static_engine_tokens_are_the_one_rank_engines(runs, shape, which):
    """Where the reference raises (a one-slot prefill on (2,2) or (4,1),
    a ragged prompt on the model axis) the port serves, bitwise its own
    one-rank engine."""
    _, tokens, _ = runs
    for r in range(RANKS):
        assert tokens[r][shape][which] == tokens[0]["one"][which]


def test_session_serve_and_the_cli_run_on_the_sessions_mesh(runs):
    """``Session(mesh=).serve`` on the test's params gives the engine's
    tokens; ``launch.serve.run(mesh=)`` serves its requests on every
    rank (its count is the decode steps' tokens: each request's first
    comes from its prefill)."""
    _, tokens, _ = runs
    for r in range(RANKS):
        assert tokens[r]["2x2"]["session"] == \
            tokens[r]["2x2"]["engine_ragged"]
        assert tokens[r]["2x2"]["cli_tokens"] == 3 * (2 - 1)


@pytest.mark.parametrize("shape", ["1x4", "2x2"])
def test_each_ranks_cache_is_its_share_of_the_global_bytes(runs, shape):
    port, _, _ = runs
    for r in range(RANKS):
        local, whole = (int(x) for x in port[f"cache_bytes@{shape}|{r}"])
        assert local * RANKS == whole


@pytest.mark.parametrize("shape", MESHES)
def test_each_ranks_pool_holds_its_share_of_the_pages(runs, shape):
    """The pool's pages over all four ranks: ceil(pages / 4) each (the
    default pool, 1 + slots * pages a row, whose NULL page each rank
    keeps for itself)."""
    port, _, _ = runs
    from repro_torch.configs import get_config
    cfg = get_config("qwen2-0.5b")
    page_bytes = 2 * 2 * 2 * PAGE * cfg.n_kv_heads * 16   # k, v; L = 2
    for r in range(RANKS):
        local, pages = (int(x) for x in port[f"pool_bytes@{shape}|{r}"])
        assert local == -(-pages // RANKS) * page_bytes


@pytest.mark.parametrize("shape", MESHES)
def test_a_prefill_chunk_gathers_only_the_held_pages(runs, shape):
    """A chunk at position 24 reads 4 live pages of 8 positions.  Spread
    over the 4 ranks, each sends its one page; all on rank 0, rank 0
    sends 4 and the others pad to 4.  Each rank's all-gather bytes differ
    by exactly 3 pages of K and V from each of the 3 others, in each of
    the 2 layers (2 kv heads of 16, bf16)."""
    port, _, _ = runs
    page_bytes = 2 * PAGE * 2 * 16 * 2                   # K and V of a page
    for r in range(RANKS):
        spread, one = port[f"chunk_wire@{shape}|{r}"]
        assert one - spread == 2 * (RANKS - 1) * (4 - 1) * page_bytes


@pytest.mark.parametrize("shape", MESHES)
def test_continuous_engine_with_chunks_of_two_pages_is_the_references(
        runs, shape):
    """Chunks of two pages: a prompt of at most one page pads its chunk
    into a table entry still on the NULL page, which no rank holds (read
    as zeros, past every real query).  Tokens bitwise the reference's."""
    _, tokens, ref = runs
    want = ref[shape]["tokens"]["continuous_wide"]
    for r in range(RANKS):
        assert tokens[r][shape]["continuous_wide"] == want

