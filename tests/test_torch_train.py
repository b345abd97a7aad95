"""The port's train path against the JAX reference's.

qwen2-0.5b cut with ``scale_config(..., 16)`` (2 layers, d_model 64, the
Session's ``scale_down``) and, for the gradients, a width that keeps
qwen2's GQA group of 7.  Weights come from the reference's init through
``from_jax``; batches from ``SyntheticLM`` (seeded numpy, pinned to the
reference's).  JAX runs on the CPU through the model it trains
(``layers.flash_attention_jnp``, ``precision.einsum``); the port through
its kernels' plain versions.  JAX is imported inside fixtures only.

Tolerances, derived:

- Losses: fp32 logits of identical bf16 operands, sums in another order,
  and the MLP rounding as the reference's default plan does (the
  full-sequence forward multiplies ``act(g) * h`` in fp32): rtol 8e-6
  (measured 9.4e-7 and 5.6e-6; with the serve path's bf16 product,
  2.3e-6 and 9.2e-6).
- Gradients: every GEMM backward rounds its fp32 cotangent to bf16 once
  (the kernel's operand type; JAX multiplies the fp32 cotangent), a
  relative 2^-9 per product, and gradients are stored in bf16 (another
  2^-9); through a few products per layer that measures ~0.5% relative
  rms.  Held at 2e-2 of each value plus 2e-2 of the leaf's largest, the
  repo's bf16 rule.
- AdamW on the same gradients: the same fp32 expressions; rtol 1e-6 on
  the fp32 state, and the bf16 params may round one ulp the other way.
- Steps: at step t AdamW moves every weight by about lr_t whatever the
  gradient's size, so an element whose gradient is near zero may move the
  other way: |dparam| <= 2 * sum(lr) (+ one bf16 ulp), and such elements
  must be rare (under 0.5% of the model; measured 0.03%); the updates
  differ by under 10% of their rms (measured 1.7-3.4%, mostly those
  elements).  Losses, learning rates and grad norms rtol 1e-3 (measured
  5e-6 and 2e-4).
"""

import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import CAPABILITIES, Session  # noqa: E402
from repro_torch.comms.plan import CommsPlan  # noqa: E402
from repro_torch.configs import get_config, scale_config  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import Model, layers  # noqa: E402
from repro_torch.models.params import from_jax  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SCALED = scale_config(get_config("qwen2-0.5b"), 16)
GQA7 = dataclasses.replace(
    get_config("qwen2-0.5b"), n_layers=2, d_model=128, n_heads=14,
    n_kv_heads=2, head_dim=16, d_ff=256, vocab_size=512)
SEQ = 64
PEAK, WARMUP, TOTAL = 3e-3, 2, 10


@pytest.fixture(scope="module")
def J():
    pytest.importorskip("jax")
    import repro  # noqa: F401  (installs the JAX compat shims)
    import jax
    import jax.numpy as jnp
    from repro.api.session import dispatch_train_step
    from repro.configs.base import get_config as jget_config
    from repro.core.planner import plan_for
    from repro.data import pipeline
    from repro.launch.mesh import make_mesh
    from repro.models import Model as JModel
    from repro.models import layers as jlayers
    from repro.train import optimizer as jopt
    mesh = make_mesh((1, 1), ("data", "model"))
    return SimpleNamespace(jax=jax, jnp=jnp, dispatch=dispatch_train_step,
                           get_config=jget_config, plan_for=plan_for,
                           pipeline=pipeline, mesh=mesh, JModel=JModel,
                           layers=jlayers, opt=jopt)


def _jcfg(J, cfg):
    """The reference's config with the port config's fields."""
    return dataclasses.replace(J.get_config(cfg.name),
                               **dataclasses.asdict(cfg))


def _models(J, cfg, seed=0):
    """(JAX model, JAX params as numpy, port model) on one set of
    weights."""
    jcfg = _jcfg(J, cfg)
    with J.jax.set_mesh(J.mesh):
        jmodel = J.JModel(jcfg, J.mesh, J.plan_for(jcfg, J.mesh))
        params = J.jax.tree.map(np.asarray,
                                jmodel.init(J.jax.random.PRNGKey(seed)))
    return jmodel, params, Model(cfg, device="cpu")


def _leaf_grads(J, tree):
    return {".".join(k.key for k in path): np.asarray(v, np.float32)
            for path, v in J.jax.tree_util.tree_flatten_with_path(tree)[0]}


def _batch(cfg, batch, seed=0):
    return next(iter(SyntheticLM(cfg.vocab_size, batch, SEQ, seed=seed,
                                 structured=True)))


def _close(got, want, rtol=2e-2, frac=2e-2):
    got = got.float().detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=frac * float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# copies and pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("structured", [False, True])
def test_synthetic_lm_batches_are_the_references(J, structured):
    got = iter(SyntheticLM(1000, 3, 40, seed=7, structured=structured))
    want = iter(J.pipeline.SyntheticLM(1000, 3, 40, seed=7,
                                       structured=structured))
    for _ in range(3):
        g, w = next(got), next(want)
        assert set(g) == set(w) == {"tokens", "labels"}
        for k in g:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


def test_lm_loss_matches_reference(J):
    rng = np.random.default_rng(0)
    V, real = 160, 151                       # padded vocab columns 151..
    logits = (rng.standard_normal((2, 12, V)) * 4).astype(np.float32)
    labels = rng.integers(0, real, (2, 12)).astype(np.int32)
    labels[0, :5] = -1                       # ignored
    got, denom = layers.lm_loss(torch.from_numpy(logits),
                                torch.from_numpy(labels), vocab_real=real)
    want, jdenom = J.layers.lm_loss(J.jnp.asarray(logits),
                                    J.jnp.asarray(labels), vocab_real=real)
    assert float(denom) == float(jdenom) == 19.0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    none, d0 = layers.lm_loss(torch.from_numpy(logits),
                              torch.full((2, 12), -1), vocab_real=real)
    assert float(none) == 0.0 and float(d0) == 1.0     # denominator >= 1


ATTN_BWD_CASES = [
    # (Hq, Hkv, S, T, q_offset, window, softcap)
    (14, 2, 32, 32, 0, None, None),          # qwen2's GQA group, train
    (4, 2, 24, 40, 16, None, None),          # query offset
    (4, 1, 32, 32, 0, 8, None),              # sliding window
    (4, 2, 32, 32, 0, None, 5.0),            # softcap
    (2, 1, 8, 32, 20, 1, None),              # rows 12.. see no key
]


@pytest.mark.parametrize("hq,hkv,s,t,off,window,softcap", ATTN_BWD_CASES)
def test_attention_plain_backward_matches_the_models_attention(
        J, hq, hkv, s, t, off, window, softcap):
    """dq, dk, dv of the plain attention (fp32) against JAX's gradients
    through ``flash_attention_jnp``, which the reference model trains
    through, at fp32 (rtol/atol 2e-5 of the largest): zeros included on
    rows with no visible key."""
    rng = np.random.default_rng(hq * 100 + s)
    q = rng.standard_normal((2, hq, s, 16)).astype(np.float32)
    k = rng.standard_normal((2, hkv, t, 16)).astype(np.float32)
    v = rng.standard_normal((2, hkv, t, 16)).astype(np.float32)
    do = rng.standard_normal((2, hq, s, 16)).astype(np.float32)
    kw = dict(causal=True, window=window, softcap=softcap, q_offset=off)
    got = ref.attention_backward(*(torch.from_numpy(x) for x in (q, k, v)),
                                 torch.from_numpy(do), **kw)
    f = lambda a, b, c: J.layers.flash_attention_jnp(a, b, c, bq=8, bkv=8,
                                                     **kw)
    _, vjp = J.jax.vjp(f, *(J.jnp.asarray(x) for x in (q, k, v)))
    want = vjp(J.jnp.asarray(do))
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        _close(g, w, rtol=2e-5, frac=2e-5)
    if window == 1:
        assert (got[0][:, :, 12:] == 0).all()
        assert (np.asarray(want[0])[:, :, 12:] == 0).all()


@pytest.mark.parametrize("cfg", [SCALED, GQA7], ids=["scale16", "gqa7"])
def test_loss_and_every_gradient_match_reference(J, cfg):
    jmodel, params, tmodel = _models(J, cfg)
    batch = _batch(cfg, 2)
    with J.jax.set_mesh(J.mesh):
        (jloss, jm), jgrads = J.jax.jit(J.jax.value_and_grad(
            jmodel.loss_fn, has_aux=True))(
            params, {k: J.jnp.asarray(v) for k, v in batch.items()})
    tparams = {k: v.requires_grad_(True) for k, v in from_jax(params).items()}
    loss, metrics = tmodel.loss_fn(
        tparams, {k: torch.from_numpy(v).long() for k, v in batch.items()})
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=8e-6)
    assert float(metrics["tokens"]) == float(jm["tokens"]) == 2 * SEQ
    grads = dict(zip(tparams, torch.autograd.grad(loss,
                                                  list(tparams.values()))))
    want = _leaf_grads(J, jgrads)
    assert set(grads) == set(want)
    for name, g in grads.items():
        assert g.dtype == tparams[name].dtype, name
        _close(g, want[name])


def _remat_grads(cfg, params, batch, remat):
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in params.items()}
    loss, _ = Model(cfg, device="cpu", remat=remat).loss_fn(p, batch)
    return loss, dict(zip(p, torch.autograd.grad(loss, list(p.values()))))


def test_remat_and_unbound_layers_change_no_gradient():
    """``remat="full"`` (checkpointed layers), ``"group:2"`` (checkpointed
    groups of checkpointed layers) and ``"none"`` give the same gradients
    bit for bit, and each stacked leaf's gradient is one (L, ...)
    tensor."""
    params = Model(SCALED, device="cpu").init(3)
    batch = {k: torch.from_numpy(v).long()
             for k, v in _batch(SCALED, 2, seed=3).items()}
    out = [_remat_grads(SCALED, params, batch, remat)[1]
           for remat in ("full", "none", "group:2")]
    for name, g in out[0].items():
        assert g.shape == params[name].shape
        for other in out[1:]:
            assert torch.equal(g, other[name]), name
    with pytest.raises(ValueError, match="group:G"):
        Model(SCALED, device="cpu", remat="group:0")


@pytest.mark.parametrize("n_layers", [4, 5])
def test_grouped_remat_matches_reference_and_full(J, n_layers):
    """``remat="group:2"`` at L = 4 (the groups divide the stack: the
    reference's sqrt-L double remat) and L = 5 (they do not: both
    packages run without remat): loss and every gradient against the
    reference's under the same setting, and bitwise the port's under
    ``"full"``."""
    cfg = dataclasses.replace(SCALED, n_layers=n_layers)
    jmodel, params, _ = _models(J, cfg)
    jmodel = dataclasses.replace(jmodel, remat="group:2")
    batch = _batch(cfg, 2)
    with J.jax.set_mesh(J.mesh):
        (jloss, _), jgrads = J.jax.jit(J.jax.value_and_grad(
            jmodel.loss_fn, has_aux=True))(
            params, {k: J.jnp.asarray(v) for k, v in batch.items()})
    tbatch = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    loss, grads = _remat_grads(cfg, from_jax(params), tbatch, "group:2")
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=8e-6)
    want = _leaf_grads(J, jgrads)
    assert set(grads) == set(want)
    for name, g in grads.items():
        _close(g, want[name])
    loss_full, full = _remat_grads(cfg, from_jax(params), tbatch, "full")
    assert torch.equal(loss, loss_full)
    for name, g in grads.items():
        assert torch.equal(g, full[name]), name


# the rest of the dense family at its cut widths: gemma3's cut has two
# layers and so no global one, so it takes seven (a local:global group of
# five and one, then a local tail)
NEW_DENSE = {
    "qwen3-14b": scale_config(get_config("qwen3-14b"), 64),
    "gemma-2b": scale_config(get_config("gemma-2b"), 64),
    "gemma3-27b": dataclasses.replace(
        scale_config(get_config("gemma3-27b"), 64), n_layers=7),
}


@pytest.mark.parametrize("arch", sorted(NEW_DENSE))
def test_new_dense_archs_step_through_session_as_the_reference(J, arch):
    """qwen3-14b (qk-norm), gemma-2b (MQA, GeGLU, ``emb_scale``) and
    gemma3-27b (qk-norm and local:global windows) through
    ``Session.plan/step`` with ``model_kwargs={"remat": "group:G"}``:
    the loss and every gradient against the reference's, then two AdamW
    steps by the step rule.  The qk-norm scales are drawn away from
    their init of one."""
    cfg = NEW_DENSE[arch]
    jmodel, params, _ = _models(J, cfg)
    attn = params["layers"]["attn"]
    rng = np.random.default_rng(9)
    for name in ("q_norm", "k_norm"):
        if name in attn:
            attn[name] = np.asarray(J.jnp.asarray(
                1.0 + 0.3 * rng.standard_normal(attn[name].shape),
                J.jnp.bfloat16))
    batches = [b for _, b in zip(range(2), SyntheticLM(
        cfg.vocab_size, 2, SEQ, seed=2, structured=True))]
    with J.jax.set_mesh(J.mesh):
        (jloss, _), jgrads = J.jax.jit(J.jax.value_and_grad(
            jmodel.loss_fn, has_aux=True))(
            params, {k: J.jnp.asarray(v) for k, v in batches[0].items()})
    want = _reference_steps(
        J, jmodel, params, batches,
        J.opt.AdamWConfig(lr=J.opt.warmup_cosine(PEAK, WARMUP, TOTAL)))
    group = next(g for g in (3, 2, 1) if cfg.n_layers % g == 0)
    sess = Session(device="cpu")
    plan = sess.plan(cfg, batch=2, seq=SEQ, comms="off",
                     model_kwargs={"remat": f"group:{group}"},
                     adamw=topt.AdamWConfig(
                         lr=topt.warmup_cosine(PEAK, WARMUP, TOTAL)))
    assert plan.model.remat == f"group:{group}"
    tparams = {k: v.requires_grad_(True) for k, v in from_jax(params).items()}
    loss, _ = plan.model.loss_fn(
        tparams, {k: torch.from_numpy(v).long()
                  for k, v in batches[0].items()})
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=8e-6)
    grads = dict(zip(tparams, torch.autograd.grad(loss,
                                                  list(tparams.values()))))
    jflat = _leaf_grads(J, jgrads)
    assert set(grads) == set(jflat)
    for name, g in grads.items():
        _close(g, jflat[name])
    sess.init_state(plan, params=from_jax(params))
    p0 = _leaf_grads(J, params)
    lrs = []
    for b, w in zip(batches, want):
        m = {k: float(v) for k, v in sess.step(plan, b).items()}
        lrs.append(m["lr"])
        got = {k: v.detach().float().numpy()
               for k, v in sess.state["train_state"]["params"].items()}
        _steps_agree(m, got, w, p0, lrs)


def test_adamw_apply_matches_reference(J):
    """One AdamW step on the same params and gradients (fp32 gradients,
    norm above the clip), then a second on new gradients."""
    _, params, _ = _models(J, SCALED)
    rng = np.random.default_rng(5)
    jflat = _leaf_grads(J, params)
    adamw = topt.AdamWConfig(lr=topt.warmup_cosine(PEAK, WARMUP, TOTAL))
    jadamw = J.opt.AdamWConfig(lr=J.opt.warmup_cosine(PEAK, WARMUP, TOTAL))
    tparams = from_jax(params)
    state = topt.init_state(tparams, adamw)
    assert state["mu"]["embed"].data_ptr() != state["nu"]["embed"].data_ptr()
    jmodel, _, _ = _models(J, SCALED)
    with J.jax.set_mesh(J.mesh):
        jstate = J.opt.init_state(params, jmodel.param_specs(), J.mesh)
    jparams = params
    for step in range(2):
        g = {k: (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
             for k, v in jflat.items()}
        _, _, stats = topt.apply(adamw, state,
                                 {k: torch.from_numpy(v) for k, v in
                                  g.items()}, tparams)
        with J.jax.set_mesh(J.mesh):
            jparams, jstate, jstats = J.jax.jit(
                lambda st, gr: J.opt.apply(jadamw, st, gr,
                                           jmodel.param_specs(), J.mesh))(
                jstate, from_nested(J, g, params))
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(stats[k]), float(jstats[k]),
                                       rtol=1e-6)
        assert int(state["step"]) == int(jstate["step"]) == step + 1
        for slot in ("mu", "nu", "master"):
            want = _leaf_grads(J, jstate[slot])
            for k, v in state[slot].items():
                np.testing.assert_allclose(v.numpy(), want[k], rtol=1e-6,
                                           atol=1e-6 * np.abs(want[k]).max())
        want = _leaf_grads(J, jparams)
        for k, v in tparams.items():
            # the bf16 rounding of fp32 masters that agree (to 1e-6 of the
            # largest): equal, or one ulp apart where a master sits on a
            # rounding boundary
            got = v.float().numpy()
            assert torch.equal(v, state["master"][k].to(v.dtype)), k
            np.testing.assert_allclose(got, want[k], rtol=2.0 ** -7,
                                       atol=1e-6 * np.abs(want[k]).max())
            assert (got != want[k]).mean() < 1e-3, k


def from_nested(J, flat, like):
    """A flat dict of numpy arrays as the nested tree ``like``."""
    paths = J.jax.tree_util.tree_flatten_with_path(like)
    leaves = [J.jnp.asarray(flat[".".join(k.key for k in p)])
              for p, _ in paths[0]]
    return J.jax.tree_util.tree_unflatten(paths[1], leaves)


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

def _reference_steps(J, jmodel, params, batches, adamw):
    """The reference's gspmd step on a one-device mesh: (metrics, params)
    after each step, as numpy."""
    out = []
    with J.jax.set_mesh(J.mesh):
        step = J.jax.jit(J.dispatch(jmodel, J.mesh, adamw=adamw,
                                    num_microbatches=1, path="gspmd"))
        state = {"params": params,
                 "opt": J.opt.init_state(params, jmodel.param_specs(),
                                         J.mesh)}
        for b in batches:
            state, m = step(state, {k: J.jnp.asarray(v)
                                    for k, v in b.items()})
            out.append(({k: float(v) for k, v in m.items()},
                        _leaf_grads(J, state["params"])))
    return out


def _steps_agree(got_metrics, got_params, want, p0, lrs, wire=None,
                 n_ranks=1, norm_rtol=1e-3):
    """The step tolerance (module docstring), on the updates from ``p0``:
    every weight within 2 * sum(lr) of the reference's (+ one bf16 ulp);
    the updates' difference under 10% of their rms; a weight moved the
    other way than the reference's by more than half an lr on under 0.5%
    of the model.  The int8 wire leaves a weight whose synced gradient
    rounds to zero with its decay only (within lr of the fp32 result),
    so there the moves that stay under half an lr are not counted, and
    the grad norm is that of the quantized gradients (rtol 5e-2).
    ``norm_rtol``: the grad norm's tolerance without a wire."""
    gm, wp = want
    for k in ("loss", "lr"):
        np.testing.assert_allclose(got_metrics[k], gm[k], rtol=1e-3)
    # every metric is a rank mean (the reference's pmean): a rank counts
    # its own share of the tokens
    assert got_metrics["tokens"] * n_ranks == gm["tokens"]
    np.testing.assert_allclose(got_metrics["grad_norm"], gm["grad_norm"],
                               rtol=norm_rtol if wire is None else 5e-2)
    bound = 2 * sum(lrs) * 1.2
    ug, uw = [], []
    for name, w in wp.items():
        d = np.abs(got_params[name] - w)
        assert d.max() <= bound + np.abs(w).max() * 2.0 ** -7, name
        ug.append((got_params[name] - p0[name]).ravel())
        uw.append((w - p0[name]).ravel())
    ug, uw = np.concatenate(ug), np.concatenate(uw)
    half = 0.5 * lrs[-1]
    against = (np.sign(ug) != np.sign(uw)) & (np.abs(uw) > half) \
        & (np.abs(ug) > half)
    assert against.mean() < 5e-3
    if wire is None:
        assert np.linalg.norm(ug - uw) < 0.1 * np.linalg.norm(uw)


def test_one_rank_step_matches_reference_for_three_steps(J):
    jmodel, params, _ = _models(J, SCALED)
    batches = [b for _, b in zip(range(3), SyntheticLM(
        SCALED.vocab_size, 4, SEQ, seed=1, structured=True))]
    want = _reference_steps(
        J, jmodel, params, batches,
        J.opt.AdamWConfig(lr=J.opt.warmup_cosine(PEAK, WARMUP, TOTAL)))
    sess = Session(device="cpu")
    plan = sess.plan("qwen2-0.5b", batch=4, seq=SEQ, scale_down=16,
                     comms="off", adamw=topt.AdamWConfig(
                         lr=topt.warmup_cosine(PEAK, WARMUP, TOTAL)))
    assert plan.path == "gspmd" and plan.num_microbatches == 1
    sess.init_state(plan, params=from_jax(params))
    p0 = _leaf_grads(J, params)
    lrs = []
    for b, w in zip(batches, want):
        m = {k: float(v) for k, v in sess.step(plan, b).items()}
        lrs.append(m["lr"])
        got = {k: v.detach().float().numpy()
               for k, v in sess.state["train_state"]["params"].items()}
        _steps_agree(m, got, w, p0, lrs)
    assert want[-1][0]["loss"] < want[0][0]["loss"]


def test_session_paths():
    sess = Session(device="cpu")
    auto = sess.plan("qwen2-0.5b", batch=2, seq=16, scale_down=16)
    assert auto.path == "gspmd" and auto.comms is None     # no group
    assert set(CAPABILITIES) == {"gspmd", "comms", "pipeline"}
    assert sess.plan("qwen2-0.5b", batch=2, seq=16, scale_down=16,
                     comms="off").path == "gspmd"
    int8 = CommsPlan(schedule="psum", wire_dtype="int8")
    assert sess.plan("qwen2-0.5b", batch=2, seq=16, scale_down=16,
                     comms=int8).comms is int8


def test_default_comms_steps_with_and_without_a_group(tmp_path):
    """``Session``'s lifecycle with the default ``comms="auto"``: with no
    process group it takes the one-rank path; on a gloo group of one it
    takes the comms path (schedule psum, fp32 wire).  A one-rank fp32
    wire sums nothing and the bf16 gradients widen and narrow exactly, so
    both steps give the same params, bitwise."""
    from repro_torch.core.distributed import close_group, init_group
    batch = _batch(SCALED, 2, seed=3)

    def one_step():
        sess = Session(device="cpu")
        plan = sess.plan("qwen2-0.5b", batch=2, seq=SEQ, scale_down=16)
        sess.init_state(plan, seed=0)
        m = sess.step(plan, batch)
        assert all(np.isfinite(float(v)) for v in m.values())
        return plan, sess.state["train_state"]["params"]

    plan0, want = one_step()
    assert plan0.path == "gspmd"
    init_group(f"file://{tmp_path / 'rendezvous'}", rank=0, world_size=1,
               device="cpu")
    try:
        plan1, got = one_step()
    finally:
        close_group()
    assert plan1.path == "comms" and plan1.comms.schedule == "psum"
    assert plan1.comms.resolve(plan1.mesh, 1 << 30) == "psum"
    for k in want:
        assert torch.equal(got[k], want[k]), k


_RANK = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    from repro_torch.api import Session
    from repro_torch.comms.plan import CommsPlan
    from repro_torch.core.distributed import close_group, init_group
    from repro_torch.train import optimizer as opt
    rank, init, src, dst = int(sys.argv[1]), sys.argv[2], sys.argv[3], \\
        sys.argv[4]
    peak, warmup, total, seq, wire = eval(sys.argv[5])
    init_group(init, rank=rank, world_size=2, device="cpu")
    data = np.load(src)
    params = {k[2:]: torch.from_numpy(data[k].copy()).view(torch.bfloat16)
              for k in data.files if k.startswith("p/")}
    batch = {k[2:]: data[k] for k in data.files if k.startswith("b/")}
    sess = Session(device="cpu")
    plan = sess.plan("qwen2-0.5b", batch=4, seq=seq, scale_down=16,
                     comms=CommsPlan(schedule="psum", wire_dtype=wire),
                     adamw=opt.AdamWConfig(
                         lr=opt.warmup_cosine(peak, warmup, total)))
    sess.init_state(plan, params=params)
    m = sess.step(plan, batch)
    out = {k: v.detach().view(torch.int16).numpy()
           for k, v in sess.state["train_state"]["params"].items()}
    np.savez(dst, **out)
    with open(dst + ".json", "w") as f:
        json.dump({k: float(v) for k, v in m.items()}, f)
    close_group()
""")


@pytest.mark.parametrize("wire", [None, "int8"])
def test_two_rank_step_matches_reference(J, tmp_path, wire):
    """Two CPU ranks (gloo) each differentiate 2 of the 4 sequences and
    sync through the wire; both end with the same params, within the step
    tolerance of the reference's one-device step on all 4.  (The int8
    wire moves a weight whose synced gradient rounds to zero by its decay
    only, at most lr from the fp32 result: the same bound.)"""
    import json
    jmodel, params, _ = _models(J, SCALED)
    batch = _batch(SCALED, 4, seed=2)
    want = _reference_steps(
        J, jmodel, params, [batch],
        J.opt.AdamWConfig(lr=J.opt.warmup_cosine(PEAK, WARMUP, TOTAL)))[0]
    src = tmp_path / "in.npz"
    flat = from_jax(params)
    np.savez(src, **{f"p/{k}": v.view(torch.int16).numpy()
                     for k, v in flat.items()},
             **{f"b/{k}": v for k, v in batch.items()})
    init = f"file://{tmp_path / 'rendezvous'}"
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    args = repr((PEAK, WARMUP, TOTAL, SEQ, wire))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), init, str(src),
         str(tmp_path / f"r{r}.npz"), args], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in (0, 1)]
    for p in procs:
        out = p.communicate(timeout=300)[0]
        assert p.returncode == 0, out
    got = [np.load(tmp_path / f"r{r}.npz") for r in (0, 1)]
    for k in flat:
        np.testing.assert_array_equal(got[0][k], got[1][k])   # replicas
    metrics = json.loads((tmp_path / "r0.npz.json").read_text())
    params1 = {k: torch.from_numpy(got[0][k]).view(torch.bfloat16)
               .float().numpy() for k in flat}
    _steps_agree(metrics, params1, want, _leaf_grads(J, params),
                 [metrics["lr"]], wire, n_ranks=2)


# ---------------------------------------------------------------------------
# means by a count: three microbatches, three ranks
# ---------------------------------------------------------------------------

# A linear loss on grid values (multiples of 2^-6 below 2): every gradient,
# every microbatch loss and every sum of them is exact in any order, so the
# only rounding left in a step is its means.  AdamW is swapped for the
# identity on the gradients (both sides), so a step returns the gradients
# it would apply and the metrics it would report.
_MEANS = textwrap.dedent("""
    def loss_fn(params, mb, xp, widen):
        s = xp.sum(mb["x"], axis=0)
        loss = xp.sum(widen(params["w"]) * s) \\
            + xp.sum(params["b"] * xp.sum(s, axis=0))
        return loss, {"loss": loss, "rows": xp.sum(mb["x"][:, 0, 0] * 0 + 1)}
""")

_MEANS_JAX = _MEANS + textwrap.dedent("""
    import sys
    import numpy as np
    import repro  # noqa: F401
    import jax, jax.numpy as jnp
    from repro.core.layout import Layout
    from repro.models.params import ParamSpec
    from repro.train import optimizer, step as S
    from repro.comms.plan import CommsPlan
    src, dst = sys.argv[1], sys.argv[2]
    d = np.load(src)
    params = {"w": jnp.asarray(d["w"]).astype(jnp.bfloat16),
              "b": jnp.asarray(d["b"])}
    batch = {"x": jnp.asarray(d["x"])}
    class Toy:
        def param_specs(self):
            return {"w": ParamSpec((4, 6), Layout((None, None))),
                    "b": ParamSpec((6,), Layout((None,)), jnp.float32)}
        def loss_fn(self, p, mb):
            return loss_fn(p, mb, jnp, lambda a: a.astype(jnp.float32))
    optimizer.apply = lambda cfg, st, grads, *a, **k: (grads, st, {})
    out = {}
    for path, n in (("gspmd", 1), ("comms", 3)):
        mesh = jax.sharding.Mesh(
            np.asarray(jax.devices()[:n]).reshape(n, 1), ("data", "model"),
            axis_types=(jax.sharding.AxisType.Auto,) * 2)
        with jax.set_mesh(mesh):
            fn = (S._gspmd_train_step(Toy(), mesh, None, 3) if path == "gspmd"
                  else S._comms_train_step(Toy(), mesh, None, 3,
                                           CommsPlan(schedule="psum")))
            state, m = jax.jit(fn)({"params": params, "opt": {}}, batch)
        for k, v in state["params"].items():
            out[f"{path}/g/{k}"] = np.asarray(v.astype(jnp.float32))
        for k, v in m.items():
            out[f"{path}/m/{k}"] = np.asarray(v, np.float32)
    np.savez(dst, **out)
""")

_MEANS_RANK = _MEANS + textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    from repro_torch.comms.plan import CommsPlan
    from repro_torch.core.distributed import close_group, init_group
    from repro_torch.train import optimizer, step as S
    rank, init, src, dst = int(sys.argv[1]), sys.argv[2], sys.argv[3], \\
        sys.argv[4]
    init_group(init, rank=rank, world_size=3, device="cpu")
    d = np.load(src)
    params = {"w": torch.from_numpy(d["w"]).bfloat16().requires_grad_(),
              "b": torch.from_numpy(d["b"]).requires_grad_()}
    batch = {"x": torch.from_numpy(d["x"])}
    class Toy:
        def loss_fn(self, p, mb):
            return loss_fn(p, mb, torch, lambda a: a.float())
    optimizer.apply = lambda cfg, st, grads, params: (grads, st, {})
    out = {}
    for path in ("gspmd", "comms"):
        fn = (S.gspmd_train_step(Toy(), None, 3) if path == "gspmd" else
              S.comms_train_step(Toy(), None, 3, CommsPlan(schedule="psum")))
        state, m = fn({"params": params, "opt": {}}, batch)
        for k, v in state["params"].items():
            out[f"{path}/g/{k}"] = v.float().numpy()
        for k, v in m.items():
            out[f"{path}/m/{k}"] = np.asarray(float(v), np.float32)
    np.savez(dst, **out)
    close_group()
""")


def test_means_over_three_microbatches_and_three_ranks_are_bitwise(
        tmp_path):
    """The gspmd step at ``num_microbatches=3`` (the gradients' mean and
    the metrics' mean over the microbatches) on one device, and the comms
    step at 3 microbatches on 3 gloo ranks (the same, then ``sync_tree``'s
    mean and the metrics' ``pmean`` over the ranks), against the
    reference's steps on 1 and 3 fake devices: bitwise.  1/3 is inexact,
    so a true division rounds a share of these otherwise."""
    rng = np.random.default_rng(17)
    grid = lambda shape: (rng.integers(-63, 64, shape) / 64.0).astype(  # noqa
        np.float32)
    src = tmp_path / "in.npz"
    np.savez(src, w=grid((4, 6)), b=grid((6,)), x=grid((18, 4, 6)))
    jax_out = tmp_path / "jax.npz"
    env = dict(os.environ, OMP_NUM_THREADS="2", JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=3",
               PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    init = f"file://{tmp_path / 'rendezvous'}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _MEANS_JAX, str(src), str(jax_out)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)]
    procs += [subprocess.Popen(
        [sys.executable, "-c", _MEANS_RANK, str(r), init, str(src),
         str(tmp_path / f"r{r}.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(3)]
    for p in procs:
        out = p.communicate(timeout=300)[0]
        assert p.returncode == 0, out[-4000:]
    want = dict(np.load(jax_out))
    for r in range(3):
        got = dict(np.load(tmp_path / f"r{r}.npz"))
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(got[key].view(np.uint32),
                                          want[key].view(np.uint32),
                                          f"rank {r} {key}")
    # the means are inexact here: the gradient is not a multiple of 2^-6
    assert (want["gspmd/g/b"] * 64 % 1 != 0).any()
