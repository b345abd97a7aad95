"""The port's layers, paged attention and model steps against the JAX
reference's, on the reference's weights carried over by ``from_jax``.

The model is qwen2-0.5b cut to a tiny width that keeps its shape: GQA
group 7, QKV bias (set non-zero here), rope theta 1e6.  Inputs come from a
numpy seed; JAX runs on the CPU through its plain reference paths, the
port through its kernels' plain versions.

Tolerances: outputs that are fp32 GEMM results of identical bf16 operands
differ only by summation order (rtol 1e-5).  Outputs stored in bf16 may
differ by one bf16 rounding (2^-8 relative) where the two frameworks'
fp32 intermediates straddle a rounding boundary, and such a flip
propagates through later products, so bf16 outputs and anything computed
from them are compared at ``BF16 = rtol 2e-2`` with an absolute floor of
2e-2 of the tensor's largest magnitude.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro  # noqa: F401,E402  (installs the JAX compat shims)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.core import precision as jprecision  # noqa: E402
from repro.core.planner import plan_for  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402

from repro_torch.core import precision  # noqa: E402
from repro_torch.models import Model, attention, layers  # noqa: E402
from repro_torch.models.params import from_jax  # noqa: E402

CFG = dataclasses.replace(
    jget_config("qwen2-0.5b"), n_layers=2, d_model=128, n_heads=14,
    n_kv_heads=2, head_dim=16, d_ff=256, vocab_size=512)


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _bf16(x):
    """(JAX bf16 array, torch bf16 tensor) holding the same bits."""
    j = jnp.asarray(x, jnp.bfloat16)
    bits = np.asarray(j).view(np.uint16).copy()
    return j, torch.from_numpy(bits).view(torch.bfloat16)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, want, *, exact_fp32=False):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if exact_fp32:
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=2e-2,
                                   atol=2e-2 * np.abs(want).max())


@pytest.fixture(scope="module")
def mesh():
    return make_mesh((1, 1), ("data", "model"))


@pytest.fixture(scope="module")
def models(mesh):
    """(JAX model, JAX params, port model, port params) on one set of
    weights, biases non-zero."""
    with jax.set_mesh(mesh):
        jmodel = JModel(CFG, mesh, plan_for(CFG, mesh))
        params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    attn = params["layers"]["attn"]
    for i, name in enumerate(("bq", "bk", "bv")):
        attn[name] = np.asarray(jnp.asarray(
            _normal(10 + i, attn[name].shape, 0.5), jnp.bfloat16))
    tmodel = Model(CFG, device="cpu")
    tparams = from_jax(params)
    return jmodel, params, tmodel, tparams


def _layer0(params):
    return jax.tree.map(lambda a: a[0], params["layers"])


def test_from_jax_carries_every_param_bit_for_bit(models):
    _, params, tmodel, tparams = models
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(flat) == len(tparams) == len(tmodel.param_specs())
    for path, leaf in flat:
        name = ".".join(k.key for k in path)
        spec = tmodel.param_specs()[name]
        got = tparams[name]
        assert tuple(got.shape) == leaf.shape == spec.shape, name
        assert got.dtype == spec.dtype == torch.bfloat16, name
        assert np.array_equal(got.view(torch.int16).numpy(),
                              leaf.view(np.int16)), name


def test_init_follows_the_reference_std_rule():
    tmodel = Model(CFG, device="cpu")
    p = tmodel.init(seed=1)
    L = CFG.n_layers
    assert float(p["embed"].float().std()) == pytest.approx(0.02, rel=0.05)
    assert float(p["layers.attn.wo"].float().std()) == pytest.approx(
        0.02 / (2 * L) ** 0.5, rel=0.05)
    assert (p["layers.attn.bq"] == 0).all() and (p["final_norm"] == 1).all()


def test_layers_match_reference():
    jx, tx = _bf16(_normal(0, (2, 8, 128)))
    jw, tw = _bf16(_normal(1, (128,), 0.5) + 1.0)
    _close(layers.rms_norm(tx, tw), jlayers.rms_norm(jx, jw))

    xr = _normal(2, (2, 8, 14, 16))
    pos = np.arange(8) + 100
    _close(layers.rotary(torch.from_numpy(xr), torch.from_numpy(pos), 1e6),
           jlayers.rotary(jnp.asarray(xr), jnp.asarray(pos), 1e6),
           exact_fp32=True)

    jg, tg = _bf16(_normal(3, (128, 256), 0.1))
    ji, ti = _bf16(_normal(4, (128, 256), 0.1))
    jo, to = _bf16(_normal(5, (256, 128), 0.1))
    _close(layers.glu_mlp(tx, tg, ti, to),
           jlayers.glu_mlp(jx, jg, ji, jo, act="silu",
                           policy=jprecision.MIXED))
    for act in ("silu", "gelu"):
        z = _normal(6, (64,), 3.0)
        _close(layers.act_fn(act)(torch.from_numpy(z)),
               jlayers.act_fn(act)(jnp.asarray(z)), exact_fp32=True)

    je, te = _bf16(_normal(7, (512, 128)))
    tok = np.random.default_rng(8).integers(0, 512, (2, 8))
    for scale in (False, True):
        _close(layers.embed(torch.from_numpy(tok), te, scale=scale),
               jlayers.embed(jnp.asarray(tok), je, scale=scale))
    _close(layers.unembed(tx, tg), jlayers.unembed(jx, jg,
                                                   policy=jprecision.MIXED),
           exact_fp32=True)


def test_glu_mlp_forms_are_bitwise_the_references(models, mesh,
                                                 monkeypatch):
    """The default form is the reference's ``glu_mlp`` and the ``wide``
    one its ``glu_mlp_shardmap`` under a one-device mesh and the default
    plan, bitwise; the two differ.  The model's full-sequence forward
    takes the wide form and its paged prefill and decode steps the
    default one.

    The inputs make every product exact, so that the only roundings left
    are the forms': x and the gate and in weights are multiples of 1/16
    below 1 (each sum of 128 products is exact in fp32 in any order), and
    the out weights pick one hidden unit per column, times a power of
    two."""
    jmodel, _, tmodel, tparams = models
    rng = np.random.default_rng(20)
    grid = lambda shape: rng.integers(-15, 16, shape) / 16.0  # noqa: E731
    w_out = np.zeros((256, 128))
    w_out[rng.permutation(256)[:128], np.arange(128)] = \
        2.0 ** rng.integers(-1, 2, 128)
    jx, tx = _bf16(grid((2, 16, 128)))
    jg, tg = _bf16(grid((128, 256)) / 4)
    ji, ti = _bf16(grid((128, 256)) / 4)
    jo, to = _bf16(w_out)
    with jax.set_mesh(mesh):
        jplan = plan_for(CFG, mesh)
        assert jplan.seq_parallel_residual
        wide = jax.jit(lambda *a: jlayers.glu_mlp_shardmap(
            *a, act="silu", mesh=mesh, plan=jplan,
            policy=jprecision.MIXED))(jx, jg, ji, jo)
    narrow = jax.jit(lambda *a: jlayers.glu_mlp(
        *a, act="silu", policy=jprecision.MIXED))(jx, jg, ji, jo)
    bits = lambda a: np.asarray(a).view(np.uint16)  # noqa: E731
    got_wide = layers.glu_mlp(tx, tg, ti, to, wide=True)
    got = layers.glu_mlp(tx, tg, ti, to)
    np.testing.assert_array_equal(got_wide.view(torch.int16).numpy()
                                  .view(np.uint16), bits(wide))
    np.testing.assert_array_equal(got.view(torch.int16).numpy()
                                  .view(np.uint16), bits(narrow))
    assert (bits(wide) != bits(narrow)).mean() > 0.1

    forms = []
    real = layers.glu_mlp

    def spy(*a, **k):
        forms.append(k.get("wide", False))
        return real(*a, **k)

    monkeypatch.setattr(layers, "glu_mlp", spy)
    tokens = torch.from_numpy(np.arange(12).reshape(1, 12) % CFG.vocab_size)
    with torch.no_grad():
        tmodel.forward(tparams, tokens)
        assert forms == [True] * CFG.n_layers
        forms.clear()
        cache = tmodel.init_paged_cache(1, 64, page_size=16)
        tmodel.prefill_chunk_paged(tparams, cache, tokens,
                                   cache["table"][0], 0)
        tmodel.decode_step_paged(tparams, cache, tokens[:, :1],
                                 torch.tensor([12]))
    assert forms == [False] * (2 * CFG.n_layers)


def _pool(seed, P, page):
    shape = (P, page, CFG.n_kv_heads, CFG.d_head)
    return _bf16(_normal(seed, shape)), _bf16(_normal(seed + 1, shape))


def test_decode_paged_matches_reference(models, mesh):
    jmodel, params, _, tparams = models
    B, page, nb = 3, 8, 4
    P = B * nb + 1
    (jk, tk), (jv, tv) = _pool(20, P, page)
    tbl = (np.random.default_rng(21).permutation(P - 1) + 1) \
        .reshape(B, nb).astype(np.int32)
    pos = np.array([0, 9, 31], np.int64)
    jx, tx = _bf16(_normal(22, (B, 1, CFG.d_model)))
    with jax.set_mesh(mesh):
        jy, jk2, jv2 = jattention.decode_paged(
            jx, _layer0(params)["attn"], CFG, jmodel.plan, jk, jv,
            jnp.asarray(tbl), jnp.asarray(pos, jnp.int32),
            policy=jprecision.MIXED)
    lp = Model._layer(tparams, 0)
    ty, tk2, tv2 = attention.decode_paged(
        tx, lp["attn"], CFG, tk, tv, torch.from_numpy(tbl),
        torch.from_numpy(pos))
    assert tk2 is tk and tv2 is tv                  # updated in place
    _close(ty, jy)
    _close(tk, jk2)
    _close(tv, jv2)


@pytest.mark.parametrize("start", [0, 16])
def test_prefill_chunk_paged_matches_reference(models, mesh, start):
    jmodel, params, _, tparams = models
    page, nb, C = 8, 6, 16
    P = nb + 2
    (jk, tk), (jv, tv) = _pool(30, P, page)
    row = (np.random.default_rng(31).permutation(P - 1) + 1)[:nb] \
        .astype(np.int32)
    jx, tx = _bf16(_normal(32, (1, C, CFG.d_model)))
    with jax.set_mesh(mesh):
        jy, jk2, jv2 = jattention.prefill_chunk_paged(
            jx, _layer0(params)["attn"], CFG, jmodel.plan, jk, jv,
            jnp.asarray(row), jnp.asarray(start, jnp.int32),
            policy=jprecision.MIXED, q_chunk=8, kv_chunk=16)
    lp = Model._layer(tparams, 0)
    ty, _, _ = attention.prefill_chunk_paged(
        tx, lp["attn"], CFG, tk, tv, torch.from_numpy(row), start)
    _close(ty, jy)
    _close(tk, jk2)
    _close(tv, jv2)


def test_prefill_chunk_past_the_table_row_raises(models):
    """The reference clamps the scatter and overwrites live positions of
    the row's last page; the port refuses the chunk."""
    _, _, _, tparams = models
    (_, tk), (_, tv) = _pool(40, 4, 8)
    _, tx = _bf16(_normal(41, (1, 16, CFG.d_model)))
    lp = Model._layer(tparams, 0)
    with pytest.raises(ValueError, match="past the table row"):
        attention.prefill_chunk_paged(tx, lp["attn"], CFG, tk, tv,
                                      torch.tensor([1, 2, 3]), 16)


def test_model_steps_match_reference(models, mesh):
    """A prompt through two prefill chunks of the static slot-major cache,
    then two decode steps, logits and pages compared after each."""
    jmodel, params, tmodel, tparams = models
    B, T, page, C = 2, 32, 8, 8
    jcache = jmodel.init_paged_cache(B, T, page)
    tcache = tmodel.init_paged_cache(B, T, page)
    prompt = np.random.default_rng(50).integers(0, CFG.vocab_size, (1, 2 * C))
    with jax.set_mesh(mesh):
        pre = jax.jit(jmodel.prefill_chunk_paged)
        dec = jax.jit(jmodel.decode_step_paged)
        for start in (0, C):
            chunk = prompt[:, start:start + C]
            jl, jcache = pre(params, jcache, jnp.asarray(chunk, jnp.int32),
                             jcache["table"][1], jnp.asarray(start, jnp.int32))
            tl, tcache = tmodel.prefill_chunk_paged(
                tparams, tcache, torch.from_numpy(chunk), tcache["table"][1],
                start)
            assert tl.dtype == torch.float32 and tl.shape == (1, C, 512 * 1)
            _close(tl, jl)
        pos = np.array([3, 2 * C], np.int64)
        for step in range(2):
            tok = np.array([[5 + step], [int(np.argmax(_np(jl)[0, -1]))]])
            jl, jcache = dec(params, jcache, jnp.asarray(tok, jnp.int32),
                             jnp.asarray(pos + step, jnp.int32))
            tl, tcache = tmodel.decode_step_paged(
                tparams, tcache, torch.from_numpy(tok),
                torch.from_numpy(pos + step))
            assert tl.shape == (B, 1, CFG.padded_vocab)
            _close(tl, jl)
    _close(tcache["k_pages"], jcache["k_pages"])
    _close(tcache["v_pages"], jcache["v_pages"])


def test_einsum_rejects_specs_that_are_not_one_gemm():
    a = torch.zeros(2, 3, 4)
    for spec in ("bsd,bd->bs", "bsd,dv->bvs", "bsd,df->bsd"):
        with pytest.raises(ValueError):
            precision.einsum(spec, a, torch.zeros(4, 5))
