"""The ssm slice of the port against the JAX reference: the SSD scan's
plain version, the Mamba2 model steps and the dense-cache static engine.

The JAX package is imported inside fixtures only.  Inputs are made with
numpy from a seed and fed to both packages; bf16 values are rounded once,
on the JAX side, and carried bit for bit.  JAX runs on the CPU, its Pallas
SSD kernel in interpret mode; the port runs its kernels' plain versions.

Tolerances, each with its reason:

- the SSD scan against ``ssd_chunked``, the sequential oracle and the
  Pallas kernel: the reference's own SSD test's (``tests/test_kernels.py``),
  rtol = atol = 2e-4 in fp32 (the same fp32 math, summed in another
  order and chunked differently) and 5e-2 in bf16 (y stored in bf16);
- chunk invariance: 1e-4, the reference's;
- model logits and caches: ``_bf16_close``, as in ``test_torch_model.py``.
  Identical bf16 operands give fp32 GEMM results that differ only by
  summation order, but the residual stream is stored in bf16, so one
  rounding that falls the other way in the two frameworks moves a value
  by 2^-8 of itself and propagates: rtol 2e-2 with an absolute floor of
  2e-2 of the tensor's largest magnitude;
- greedy tokens: they must agree wherever the reference's top-1/top-2
  margin exceeds twice the logits' tolerance, as in
  ``test_torch_serve.py``.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, scale_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.params import from_jax  # noqa: E402
from repro_torch.serve import ContinuousEngine, Engine, Request  # noqa: E402

from test_torch_kernels import ssd_case  # noqa: E402

TOL = {"float32": 2e-4, "bfloat16": 5e-2}
ARCH = "mamba2-780m"
SSD_CHUNK = 16        # the reference model's, as in tests/test_arch_smoke.py;
                     # the port's scan chunk is its own (the result does
                     # not depend on it)


@pytest.fixture(scope="module")
def J():
    pytest.importorskip("jax")
    import repro  # noqa: F401  (installs the JAX compat shims)
    import jax
    import jax.numpy as jnp
    from repro.configs import base
    from repro.core.planner import plan_for
    from repro.kernels import ref as jref
    from repro.kernels import ssd_scan
    from repro.launch.mesh import make_mesh
    from repro.models import Model as JModel
    from repro.models import ssm as jssm
    from repro.serve import Engine as JEngine
    return SimpleNamespace(
        jax=jax, jnp=jnp, base=base, plan_for=plan_for, ref=jref,
        kssd=ssd_scan, make_mesh=make_mesh, Model=JModel, ssm=jssm,
        Engine=JEngine)


def _to_jax(J, case):
    """The port's CPU inputs as JAX arrays with the same values (a bf16
    value survives the round trip through fp32 exactly)."""
    return {k: J.jnp.asarray(v.float().numpy()).astype(
        J.jnp.bfloat16 if v.dtype == torch.bfloat16 else J.jnp.float32)
        for k, v in case.items()}


def _reference_case(seed, B, S, H, P, G, N, dtype):
    """The reference SSD test's draws: x, B, C standard normal,
    dt = softplus(normal), A = -exp(normal)."""
    rng = np.random.default_rng(seed)
    raw = dict(x=rng.standard_normal((B, S, H, P)),
               dt=np.log1p(np.exp(rng.standard_normal((B, S, H)))),
               A=-np.exp(rng.standard_normal(H)),
               Bm=rng.standard_normal((B, S, G, N)),
               C=rng.standard_normal((B, S, G, N)))
    case = {k: torch.from_numpy(v.astype(np.float32)) for k, v in raw.items()}
    for k in ("x", "Bm", "C"):
        case[k] = case[k].to(torch.bfloat16 if dtype == "bfloat16"
                             else torch.float32)
    return case


def _close(got, want, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _args(d):
    return d["x"], d["dt"], d["A"], d["Bm"], d["C"]


# ---------------------------------------------------------------------------
# the SSD scan's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,g", [(4, 1), (4, 2)])
def test_ssd_plain_matches_model_oracle_and_pallas(J, h, g, dtype):
    case = _reference_case(0, 2, 256, h, 32, g, 16, dtype)
    jc = _to_jax(J, case)
    y, state = ops.ssd(*_args(case), chunk=64)
    assert y.dtype == case["x"].dtype and state.dtype == torch.float32
    tol = TOL[dtype]
    for want in (J.ssm.ssd_chunked(*_args(jc), chunk=64),
                 J.ref.ssd(*_args(jc))):
        _close(y, want[0], tol)
        _close(state, want[1], tol)
    y_k, s_k = J.kssd.ssd(*_args(jc), chunk=64, interpret=True)
    _close(y, y_k, tol)
    _close(state, s_k, tol)


def test_ssd_plain_ragged_tail_and_init_state(J):
    """S = 200 against chunk 64: the tail steps act as dt = 0; the
    initial state is carried in, as ``ref.ssd(init_state=...)`` does."""
    case = _reference_case(1, 2, 200, 4, 32, 2, 16, "float32")
    h0 = np.random.default_rng(2).standard_normal((2, 4, 32, 16)) \
        .astype(np.float32)
    jc = _to_jax(J, case)
    for init in (None, h0):
        kw_t = {} if init is None else dict(init_state=torch.from_numpy(init))
        kw_j = {} if init is None else dict(init_state=J.jnp.asarray(init))
        y, state = ops.ssd(*_args(case), chunk=64, **kw_t)
        assert y.shape == (2, 200, 4, 32) and state.shape == (2, 4, 32, 16)
        for want in (J.ssm.ssd_chunked(*_args(jc), chunk=64, **kw_j),
                     J.ref.ssd(*_args(jc), **kw_j)):
            _close(y, want[0], TOL["float32"])
            _close(state, want[1], TOL["float32"])
        y_r, s_r = ref.ssd(*_args(case), **kw_t)    # the port's oracle
        _close(y, y_r, TOL["float32"])
        _close(state, s_r, TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 64])
def test_ssd_plain_at_the_kernels_chunk_matches_model_oracle(J, S, dtype):
    """One step (a one-token prompt) and exactly one of the CUDA kernel's
    chunks, chunked as the kernel chunks, against ``ssd_chunked``."""
    from repro_torch.kernels import ssd_scan
    case = _reference_case(5, 2, S, 4, 32, 2, 16, dtype)
    jc = _to_jax(J, case)
    y, state = ssd_scan.ssd_plain(*_args(case), chunk=ssd_scan.CHUNK)
    assert y.shape == (2, S, 4, 32) and state.shape == (2, 4, 32, 16)
    want = J.ssm.ssd_chunked(*_args(jc), chunk=ssd_scan.CHUNK)
    _close(y, want[0], TOL[dtype])
    _close(state, want[1], TOL[dtype])


def test_ssd_plain_does_not_depend_on_the_chunk():
    case = _reference_case(3, 1, 128, 2, 16, 1, 8, "float32")
    y32, s32 = ops.ssd(*_args(case), chunk=32)
    y128, s128 = ops.ssd(*_args(case), chunk=128)
    _close(y32, y128, 1e-4)
    _close(s32, s128, 1e-4)


def test_ssd_plain_is_finite_at_the_models_decay_rates():
    """Decay drawn as the model's inits draw it (A = -U[1, 16], dt
    log-uniform in [1e-3, 0.1]), plus one head at the edge of both ranges
    (A = -16, dt = 0.1).  Across a 256-step chunk a_i - a_j then exceeds
    88, where exp overflows fp32: multiplying a 0/1 mask by those infs
    would give NaN."""
    case = ssd_case(4, 1, 512, 4, 16, 1, 16, "float32")
    case["A"][0] = -16.0
    case["dt"][:, :, 0] = 0.1
    a = torch.cumsum(case["dt"][0, :256, 0] * case["A"][0], 0)
    assert float(a[0] - a[-1]) > 88.0
    y, state = ops.ssd(*_args(case), chunk=256)
    assert torch.isfinite(y).all() and torch.isfinite(state).all()
    y_r, s_r = ref.ssd(*_args(case))
    _close(y, y_r, TOL["float32"])
    _close(state, s_r, TOL["float32"])


# ---------------------------------------------------------------------------
# the model steps on the reference's weights
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mamba(J):
    """(JAX model, JAX params, port model, port params, mesh) at
    scale_config(mamba2-780m, 64) on one set of weights.

    The JAX model's plan keeps the residual stream unsharded
    (``seq_parallel_residual=False``), so its prefill runs ``ssm.forward``,
    the mixer the port carries over (fp32 activations into the conv and
    the scan).  The default plan sends it through ``forward_shardmap``,
    which runs them in bf16; ``test_prefill_matches_reference`` holds the
    port against that path too."""
    return _models(J, 2)


def _models(J, n_layers):
    jcfg = dataclasses.replace(
        J.base.scale_config(J.base.get_config(ARCH), 64), n_layers=n_layers)
    mesh = J.make_mesh((1, 1), ("data", "model"))
    with J.jax.set_mesh(mesh):
        jmodel = J.Model(jcfg, mesh, J.plan_for(
            jcfg, mesh, seq_parallel_residual=False), ssd_chunk=SSD_CHUNK)
        params = J.jax.tree.map(np.asarray,
                                jmodel.init(J.jax.random.PRNGKey(0)))
    tcfg = dataclasses.replace(scale_config(get_config(ARCH), 64),
                               n_layers=n_layers)
    tmodel = Model(tcfg, device="cpu")
    return jmodel, params, tmodel, from_jax(params), mesh


def _bf16_close(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-2,
                               atol=2e-2 * np.abs(want).max())


def test_mamba2_config_matches_reference_field_by_field(J):
    want = J.base.get_config(ARCH)
    got = get_config(ARCH)
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert (got.padded_vocab, got.param_count()) == \
        (want.padded_vocab, want.param_count()) == (50304, 857_293_056)
    for down in (1, 2, 8, 64):
        assert dataclasses.asdict(scale_config(got, down)) == \
            dataclasses.asdict(J.base.scale_config(want, down))


def test_from_jax_carries_the_ssm_params_bit_for_bit(mamba, J):
    _, params, tmodel, tparams, _ = mamba
    specs = tmodel.param_specs()
    flat = J.jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(flat) == len(tparams) == len(specs)
    for path, leaf in flat:
        name = ".".join(k.key for k in path)
        got = tparams[name]
        assert tuple(got.shape) == leaf.shape == specs[name].shape, name
        assert got.dtype == specs[name].dtype, name
        fp32 = name.split(".")[-1] in ("A", "dt_bias", "D_skip")
        assert got.dtype == (torch.float32 if fp32 else torch.bfloat16), name
        bits = (torch.int32, np.int32) if fp32 else (torch.int16, np.int16)
        assert np.array_equal(got.view(bits[0]).numpy(),
                              leaf.view(bits[1])), name


def test_init_draws_the_ssm_params_from_the_reference_ranges():
    p = Model(scale_config(get_config(ARCH), 64), device="cpu").init(3)
    A, dt_bias = p["layers.ssm.A"], p["layers.ssm.dt_bias"]
    assert A.dtype == dt_bias.dtype == torch.float32
    assert float(A.min()) >= -16.0 and float(A.max()) <= -1.0
    dt = torch.nn.functional.softplus(dt_bias)
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1 * 1.001
    assert (p["layers.ssm.D_skip"] == 1).all()


def _prompt(seed, B, S, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, S))


@pytest.mark.parametrize("n_layers", [2, 8])
def test_prefill_matches_reference(mamba, J, n_layers):
    """Logits of the last position and the whole decode cache after a
    prompt of 40 tokens (ragged against the chunk of 16), against the
    reference's prefill through ``ssm.forward``; the logits also against
    its default plan's ``forward_shardmap``.  At 2 layers the port's
    logits equal the reference's to ~1e-7 of the largest; at 8 a bf16
    rounding of the residual stream falls the other way and they differ
    by 0.17% of it (measured on this test's inputs), the drift with depth
    from which ``chip_smoke.py`` derives its card-against-CPU tolerance."""
    jmodel, params, tmodel, tparams, mesh = \
        mamba if n_layers == 2 else _models(J, n_layers)
    toks = _prompt(5, 2, 40, tmodel.cfg.vocab_size)
    sp_model = J.Model(jmodel.cfg, mesh, ssd_chunk=SSD_CHUNK)
    assert sp_model.plan.seq_parallel_residual
    with J.jax.set_mesh(mesh):
        jl, jcache = J.jax.jit(lambda p, t: jmodel.prefill(p, t))(
            params, J.jnp.asarray(toks, J.jnp.int32))
        jl_sp, _ = J.jax.jit(lambda p, t: sp_model.prefill(p, t))(
            params, J.jnp.asarray(toks, J.jnp.int32))
    tl, tcache = tmodel.prefill(tparams, torch.from_numpy(toks))
    assert tl.dtype == torch.float32 and tl.shape == (2, 1, 896)
    _bf16_close(tl, jl)
    _bf16_close(tl, jl_sp)
    assert set(tcache) == set(jcache) == {"conv", "ssm", "bc_conv"}
    for k in tcache:
        assert tcache[k].dtype == torch.float32 \
            and str(jcache[k].dtype) == "float32", k
        _bf16_close(tcache[k], jcache[k])


def test_decode_step_matches_reference(mamba, J):
    """Two decode steps from the same cache (the reference's prefill
    cache, cast to the cache dtypes and carried over), logits and cache
    compared after each."""
    jmodel, params, tmodel, tparams, mesh = mamba
    toks = _prompt(6, 2, 24, tmodel.cfg.vocab_size)
    jcache = {k: np.asarray(v) for k, v in jmodel.init_cache(2, 64).items()}
    with J.jax.set_mesh(mesh):
        _, pre = J.jax.jit(lambda p, t: jmodel.prefill(p, t))(
            params, J.jnp.asarray(toks, J.jnp.int32))
        jcache = {k: J.jnp.asarray(pre[k]).astype(jcache[k].dtype)
                  for k in jcache}
        tcache = from_jax({k: np.asarray(v) for k, v in jcache.items()})
        dec = J.jax.jit(jmodel.decode_step)
        for step in range(2):
            tok = np.array([[3 + step], [7 * step + 1]])
            pos = np.array([24 + step] * 2)
            jl, jcache = dec(params, jcache, J.jnp.asarray(tok, J.jnp.int32),
                             J.jnp.asarray(pos, J.jnp.int32))
            tl, tcache2 = tmodel.decode_step(tparams, tcache,
                                             torch.from_numpy(tok),
                                             torch.from_numpy(pos))
            assert tcache2 is tcache                  # updated in place
            assert tl.shape == (2, 1, 896)
            _bf16_close(tl, jl)
            for k in tcache:
                assert tcache[k].dtype == {"float32": torch.float32,
                                           "bfloat16": torch.bfloat16}[
                    str(jcache[k].dtype)], k
                _bf16_close(tcache[k], jcache[k])


def test_prefill_then_decode_equals_the_full_forward(mamba):
    """The port's own consistency (the reference's
    ``test_arch_prefill_decode_consistency``): prefill S-1 tokens, decode
    position S-1, compare with the last row of ``forward`` on S tokens."""
    _, _, tmodel, tparams, _ = mamba
    S = 37
    toks = torch.from_numpy(_prompt(7, 2, S, tmodel.cfg.vocab_size))
    full, _, _ = tmodel.forward(tparams, toks)
    _, cache = tmodel.prefill(tparams, toks[:, :-1])
    dense = tmodel.init_cache(2, 64)
    for k in dense:
        dense[k].copy_(cache[k])
    dec, _ = tmodel.decode_step(tparams, dense, toks[:, -1:],
                                torch.tensor([S - 1, S - 1]))
    _bf16_close(dec[:, 0], full[:, -1].numpy())


def test_prefill_into_a_cache_row_equals_the_stacked_prefill(mamba):
    """The engine's prefill writes a prompt's states straight into its
    slot's row of the dense cache: the same logits and states as the
    stacked prefill (bit for bit: the same ops on the same inputs, the
    states rounded once to the cache dtypes), the other rows untouched."""
    _, _, tmodel, tparams, _ = mamba
    toks = torch.from_numpy(_prompt(8, 1, 29, tmodel.cfg.vocab_size))
    want_logits, want = tmodel.prefill(tparams, toks)
    dense = tmodel.init_cache(3, 64)
    for k in dense:
        dense[k].fill_(7.0)
    logits, got = tmodel.prefill(tparams, toks, cache=dense, slot=1)
    assert got is dense
    assert torch.equal(logits, want_logits)
    for k in dense:
        assert torch.equal(dense[k][:, 1], want[k][:, 0].to(dense[k].dtype))
        assert bool((dense[k][:, [0, 2]] == 7.0).all()), k
    with pytest.raises(ValueError, match="one prompt"):
        tmodel.prefill(tparams, toks.repeat(2, 1), cache=dense, slot=0)


# ---------------------------------------------------------------------------
# the dense-cache static engine
# ---------------------------------------------------------------------------

PROMPT_LENS = (5, 19, 33, 12)
NEW_TOKENS = 6
MAX_SEQ = 64


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in PROMPT_LENS]


def _margin(logits):
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


def test_dense_engine_matches_reference_where_margins_allow(mamba, J):
    """Greedy streams of the reference's static Engine (dense cache, its
    default) against the port's ``Engine(paged=False)``.  The reference's
    streams are replayed teacher-forced through both packages' prefill and
    decode steps: logits must agree within 2% of the largest, and the
    port's tokens must match up to and including the first step whose
    reference margin is at most twice that."""
    jmodel, params, tmodel, tparams, mesh = mamba
    vocab = tmodel.cfg.vocab_size
    with J.jax.set_mesh(mesh):
        jeng = J.Engine(jmodel, params, batch_slots=2, max_seq=MAX_SEQ)
        from repro.serve import Request as JRequest
        for rid, p in enumerate(_prompts(vocab)):
            jeng.submit(JRequest(rid=rid, prompt=p,
                                 max_new_tokens=NEW_TOKENS))
        streams = {r.rid: list(r.out) for r in jeng.run()}
        assert len(streams) == len(PROMPT_LENS)
        pre = J.jax.jit(lambda p, t: jmodel.prefill(p, t))
        dec = J.jax.jit(jmodel.decode_step)
        jl = np.zeros((len(PROMPT_LENS), NEW_TOKENS, 896), np.float32)
        tl = np.zeros_like(jl)
        for rid, p in enumerate(_prompts(vocab)):
            lj, cj = pre(params, J.jnp.asarray(p[None], J.jnp.int32))
            lt, ct = tmodel.prefill(tparams, torch.from_numpy(
                p[None].astype(np.int64)))
            jl[rid, 0], tl[rid, 0] = np.asarray(lj[0, -1]), lt[0, -1].numpy()
            for s in range(1, NEW_TOKENS):
                tok = np.array([[streams[rid][s - 1]]])
                pos = np.array([len(p) + s - 1])
                lj, cj = dec(params, cj, J.jnp.asarray(tok, J.jnp.int32),
                             J.jnp.asarray(pos, J.jnp.int32))
                lt, ct = tmodel.decode_step(tparams, ct,
                                            torch.from_numpy(tok),
                                            torch.from_numpy(pos))
                jl[rid, s], tl[rid, s] = np.asarray(lj[0, 0]), \
                    lt[0, 0].numpy()
    atol = 2e-2 * np.abs(jl).max()
    np.testing.assert_allclose(tl, jl, rtol=0, atol=atol)
    assert (jl.argmax(-1) == np.array(
        [streams[r] for r in range(len(PROMPT_LENS))])).all()

    eng = Engine(tmodel, tparams, batch_slots=2, max_seq=MAX_SEQ)
    for rid, p in enumerate(_prompts(vocab)):
        eng.submit(Request(rid=rid, prompt=p, max_new_tokens=NEW_TOKENS))
    got = {r.rid: list(r.out) for r in eng.run()}
    compared = 0
    for rid, stream in streams.items():
        sure = _margin(jl[rid]) > 2 * atol
        n = int(np.argmin(sure)) if not sure.all() else NEW_TOKENS
        assert got[rid][:n + 1] == stream[:n + 1], rid
        compared += n
    assert compared > 0


def test_engine_defaults_to_the_dense_cache_as_the_reference(mamba, J):
    """No ``paged`` argument: both packages hold the model's dense cache
    (same keys and shapes); ``paged=True`` gives both the paged cache; an
    SSM refuses it in both.  The dense family holds its dense KV cache by
    default in both too."""
    jmodel, params, tmodel, tparams, mesh = mamba
    with J.jax.set_mesh(mesh):
        jeng = J.Engine(jmodel, params, batch_slots=3, max_seq=MAX_SEQ)
        with pytest.raises(AssertionError):
            J.Engine(jmodel, params, batch_slots=3, max_seq=MAX_SEQ,
                     paged=True)
    teng = Engine(tmodel, tparams, batch_slots=3, max_seq=MAX_SEQ)
    shapes = {k: tuple(v.shape) for k, v in teng.cache.items()}
    assert not teng.paged
    assert shapes == {k: tuple(v.shape) for k, v in jeng.cache.items()}
    assert {k: v.dtype for k, v in teng.cache.items()} == {
        "ssm": torch.float32, "conv": torch.bfloat16,
        "bc_conv": torch.bfloat16}
    with pytest.raises(ValueError, match="paged decode unsupported"):
        Engine(tmodel, tparams, batch_slots=3, max_seq=MAX_SEQ, paged=True)
    with pytest.raises(ValueError, match="paged decode unsupported"):
        ContinuousEngine(tmodel, tparams, batch_slots=3, max_seq=MAX_SEQ)

    qcfg = J.base.scale_config(J.base.get_config("qwen2-0.5b"), 64)
    with J.jax.set_mesh(mesh):
        qj = J.Model(qcfg, mesh, J.plan_for(qcfg, mesh))
        qparams = qj.init(J.jax.random.PRNGKey(0))
        jpaged = J.Engine(qj, qparams, batch_slots=3, max_seq=MAX_SEQ,
                          paged=True)
        jdense = J.Engine(qj, qparams, batch_slots=3, max_seq=MAX_SEQ)
        assert set(jdense.cache) == {"k", "v"}
    qt = Model(scale_config(get_config("qwen2-0.5b"), 64), device="cpu")
    qtparams = from_jax(J.jax.tree.map(np.asarray, qparams))
    tpaged = Engine(qt, qtparams, batch_slots=3, max_seq=MAX_SEQ, paged=True)
    assert {k: tuple(v.shape) for k, v in tpaged.cache.items()} == \
        {k: tuple(v.shape) for k, v in jpaged.cache.items()}
    tdense = Engine(qt, qtparams, batch_slots=3, max_seq=MAX_SEQ)
    assert not tdense.paged
    assert {k: (tuple(v.shape), v.dtype) for k, v in tdense.cache.items()} \
        == {k: (tuple(v.shape), torch.bfloat16)
            for k, v in jdense.cache.items()}


def test_serve_cli_runs_mamba2_on_the_cpu(capsys):
    from repro_torch.launch import serve
    total, _ = serve.run(ARCH, n_requests=3, batch_slots=2, max_seq=32,
                         prompt_len=9, new_tokens=4, scale_down=64,
                         device="cpu")
    assert total == 3 * 3        # the first token of each comes at prefill
    assert "3 finished" in capsys.readouterr().out
