"""The moe family (deepseek-moe-16b, dbrx-132b) against the JAX reference
on the CPU, and the GEMM's batched mode that runs its expert banks.

Configs from ``scale_config(..., 64)``: deepseek-moe-16b cut to 2
layers, d_model 64, 4 experts top-2, 2 shared experts; dbrx-132b the same
with GQA 2/1 and no shared experts.  Weights come from the reference's
init through ``from_jax`` (the router fp32), batches from seeded numpy.
JAX runs on the CPU through the model it serves and trains; the port
through its kernels' plain versions.  JAX is imported inside fixtures
only.

Routing is a discrete decision.  The port's router product is the
GEMM's fp32 path, XLA's is its fp32 dot: their sums part by fp32
roundings, and deeper layers' inputs by the bf16 roundings of the
residual, so a (token, layer) top-k set may differ where two
probabilities nearly tie.  Where the sets are compared (a layer on the
same input) they must be equal wherever the reference's margin between
the k-th and (k+1)-th probability exceeds ``MARGIN`` (1e-6: a few fp32
ulps of a probability near 1/4; the sums of 64 products part by a few
ulps of the largest term), and each test prints the smallest margin at
its seed.  Outputs are compared on the tokens whose routes and kept
slots agree.  No seed was chosen to avoid a flip.

Tolerances, as ``tests/test_torch_train.py`` derives them: the layer's
output and logits 2e-2 of each value plus 2e-2 of the largest (the bf16
rule); losses rtol 8e-6 (one forward, fp32 logits) and aux rtol 1e-5
(fp32 means over the tokens, summed in another order); every gradient the
bf16 rule; steps by ``test_torch_train``'s step rule.

On a mesh (4 gloo CPU ranks, the reference on 4 fake devices in a child
process) the port's ``forward_mesh`` and ZeRO-1 step are held against
the reference on the same mesh by ``tests/test_torch_parallel.py``'s
rules: capacity is per batch shard and aux the mean of the shards', so
the (2, 2) loss differs from the (1, 1) one by design.  The pipeline
(GPipe and 1F1B on 2 gloo ranks) is held against the port's single-stage
step on the same microbatches.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import Session  # noqa: E402
from repro_torch.configs import get_config, scale_config  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core import precision  # noqa: E402
from repro_torch.kernels import gemm, ops, ref, roofline  # noqa: E402
from repro_torch.models import Model, layers, moe  # noqa: E402
from repro_torch.models.params import from_jax  # noqa: E402
from repro_torch.serve import ContinuousEngine, Engine, Request  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
DEEPSEEK, DBRX = "deepseek-moe-16b", "dbrx-132b"
TINY = scale_config(get_config(DEEPSEEK), 64)
TINY_DBRX = scale_config(get_config(DBRX), 64)
# capacity 0.5: T * K / E * 0.5 slots, so tokens are dropped
DROPS = dataclasses.replace(TINY, capacity_factor=0.5)
MARGIN = 1e-6
SEQ = 32
PEAK, WARMUP, TOTAL = 3e-3, 2, 10


@pytest.fixture(scope="module")
def J():
    pytest.importorskip("jax")
    import repro  # noqa: F401  (installs the JAX compat shims)
    import jax
    import jax.numpy as jnp
    from repro.api.session import dispatch_train_step
    from repro.configs import base as jbase
    from repro.core import precision as jprecision
    from repro.core.planner import plan_for
    from repro.launch.mesh import make_mesh
    from repro.models import Model as JModel
    from repro.models import moe as jmoe
    from repro.serve import ContinuousEngine as JContinuous
    from repro.serve import Engine as JEngine
    from repro.serve import Request as JRequest
    from repro.serve.engine import _make_prefill_fn
    from repro.train import optimizer as jopt
    return SimpleNamespace(
        jax=jax, jnp=jnp, dispatch=dispatch_train_step, base=jbase,
        precision=jprecision, plan_for=plan_for, JModel=JModel, moe=jmoe,
        JEngine=JEngine, JContinuous=JContinuous, JRequest=JRequest,
        prefill_fn=_make_prefill_fn, opt=jopt,
        mesh=make_mesh((1, 1), ("data", "model")))


def _jcfg(J, cfg):
    return dataclasses.replace(J.base.get_config(cfg.name),
                               **dataclasses.asdict(cfg))


def _models(J, cfg, seed=0):
    """(JAX model, JAX params as numpy, port model, port params) on one
    set of weights."""
    jcfg = _jcfg(J, cfg)
    with J.jax.set_mesh(J.mesh):
        jmodel = J.JModel(jcfg, J.mesh, J.plan_for(jcfg, J.mesh))
        params = J.jax.tree.map(np.asarray,
                                jmodel.init(J.jax.random.PRNGKey(seed)))
    return jmodel, params, Model(cfg, device="cpu"), from_jax(params)


def _leaf_grads(J, tree):
    return {".".join(k.key for k in path): np.asarray(v, np.float32)
            for path, v in J.jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close(got, want, rtol=2e-2, frac=2e-2, what=""):
    got = got.float().detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=frac * float(np.abs(want).max()),
                               err_msg=what)


def _batch(cfg, rows, seed=0, seq=SEQ):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (rows, seq + 1))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


# ---------------------------------------------------------------------------
# the configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [DEEPSEEK, DBRX])
def test_moe_configs_match_reference_field_by_field(J, arch):
    """The two config modules, copied from the reference's and registered
    as it registers them."""
    want, got = J.base.get_config(arch), get_config(arch)
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert (got.padded_vocab, got.d_head, got.d_shared_ff,
            got.param_count(), got.active_param_count()) == \
        (want.padded_vocab, want.d_head, want.d_shared_ff,
         want.param_count(), want.active_param_count())
    for down in (1, 2, 8, 64):
        assert dataclasses.asdict(scale_config(got, down)) == \
            dataclasses.asdict(J.base.scale_config(want, down))
    assert got is tbase._REGISTRY[arch]
    src = (ROOT / "src/repro/configs" / f"{arch.replace('-', '_')}.py")
    dst = (ROOT / "src/repro_torch/configs"
           / f"{arch.replace('-', '_')}.py")
    assert src.read_text() == dst.read_text()


def test_spec_parameter_counts_are_the_configs():
    """deepseek-moe-16b's specs hold its 16,879,568,896 parameters (the
    config's count: the router and the norms included), the router
    fp32."""
    specs = Model(get_config(DEEPSEEK), device="cpu").param_specs()
    assert sum(math.prod(s.shape) for s in specs.values()) == \
        get_config(DEEPSEEK).param_count() == 16_879_568_896
    assert specs["layers.moe.router"].dtype == torch.float32
    assert specs["layers.moe.w_gate"].shape == (28, 64, 2048, 1408)


# ---------------------------------------------------------------------------
# the GEMM's batched mode (plain version and autograd) and the einsum
# ---------------------------------------------------------------------------

def _bf16(seed, shape, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to(torch.bfloat16)


@pytest.mark.parametrize("e,m,k,n", [(4, 8, 64, 32), (3, 15, 130, 66),
                                     (2, 1, 16, 8)])
def test_batched_matmul_is_the_2d_product_per_expert_bitwise(e, m, k, n):
    """The plain batched product and both backward products (autograd on
    the transposed views) are the 2-D ones on each expert, bit for bit,
    in fp32 and bf16 outputs."""
    a, b = _bf16(1, (e, m, k)), _bf16(2, (e, k, n), 0.1)
    for out in (torch.float32, torch.bfloat16):
        got = gemm.matmul(a, b, out)
        assert got.shape == (e, m, n) and got.dtype == out
        want = torch.stack([gemm.matmul(a[i], b[i], out) for i in range(e)])
        assert torch.equal(got, want)
    dc = torch.randn((e, m, n), generator=torch.Generator().manual_seed(3))
    la, lb = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    da, db = torch.autograd.grad(gemm.matmul(la, lb, torch.float32),
                                 (la, lb), dc)
    for i in range(e):
        xa = a[i].clone().requires_grad_(True)
        xb = b[i].clone().requires_grad_(True)
        ga, gb = torch.autograd.grad(gemm.matmul(xa, xb, torch.float32),
                                     (xa, xb), dc[i])
        assert torch.equal(da[i], ga) and torch.equal(db[i], gb), i
    assert da.dtype == db.dtype == torch.bfloat16


def test_batched_matmul_refuses_what_does_not_chain():
    with pytest.raises(ValueError, match="do not chain"):
        gemm.matmul(_bf16(0, (2, 3, 4)), _bf16(1, (3, 4, 5)))
    with pytest.raises(ValueError, match="do not chain"):
        gemm.matmul(_bf16(0, (2, 3, 4)), _bf16(1, (4, 5)))


def test_batched_matmul_cost_and_shape_function():
    """The dry run's cost of a batched launch is E times the 2-D one, and
    its shape function allocates the split's per-expert scratch."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    assert roofline.matmul_cost(8, 2048, 1408, batch=64) == tuple(
        64 * v for v in roofline.matmul_cost(8, 2048, 1408))
    pl = gemm.plan(8, 2048, 1408)
    assert pl.split > 1
    roofline.DRY.reset()
    with FakeTensorMode():
        a = torch.empty((64, 8, 2048), dtype=torch.bfloat16)
        b = torch.empty((64, 2048, 1408), dtype=torch.bfloat16)
        out = gemm._product(a, b, torch.float32)
    assert tuple(out.shape) == (64, 8, 1408)
    assert roofline.DRY.calls["matmul"] == 1
    assert roofline.DRY.bytes["matmul"] == roofline.matmul_cost(
        8, 2048, 1408, batch=64)[0]
    roofline.DRY.reset()


def test_einsum_takes_a_batch_index_as_one_batched_product(monkeypatch):
    """``ecd,edf->ecf`` and ``ecf,efd->ecd`` are one ``ops.matmul`` call
    on 3-D operands, bitwise the 2-D einsum per expert; the specs taken
    before are one 2-D call as before; a batch index the output drops is
    refused."""
    seen, real = [], ops.matmul

    def rec(a, b, out_dtype=None):
        seen.append((tuple(a.shape), tuple(b.shape)))
        return real(a, b, out_dtype)
    monkeypatch.setattr(ops, "matmul", rec)
    x, w = _bf16(4, (4, 6, 16)), _bf16(5, (4, 16, 8), 0.1)
    got = precision.einsum("ecd,edf->ecf", x, w)
    assert seen == [((4, 6, 16), (4, 16, 8))]
    seen.clear()
    want = torch.stack([precision.einsum("cd,df->cf", x[i], w[i])
                        for i in range(4)])
    assert torch.equal(got, want) and len(seen) == 4
    seen.clear()
    y = precision.einsum("ecf,efd->ecd", got.to(torch.bfloat16),
                         _bf16(6, (4, 8, 16)))
    assert y.shape == (4, 6, 16) and seen == [((4, 6, 8), (4, 8, 16))]
    seen.clear()
    precision.einsum("bsd,dhk->bshk", _bf16(7, (2, 3, 16)),
                     _bf16(8, (16, 2, 4)))
    assert seen == [((6, 16), (16, 8))]
    with pytest.raises(ValueError, match="trailing/leading"):
        precision.einsum("ecd,edf->cf", x, w)


# ---------------------------------------------------------------------------
# the layer on one device against the reference's
# ---------------------------------------------------------------------------

def _layer_params(J, cfg, seed, router_scale=0.5, tie=False):
    """One moe layer's params (bf16 banks, fp32 router) as numpy; with
    ``tie``, router columns 1 and 2 equal, so experts 1 and 2 tie on
    every token."""
    rng = np.random.default_rng(seed)
    D, E, Fe, Fs = (cfg.d_model, cfg.n_experts, cfg.d_ff_expert,
                    cfg.d_shared_ff)

    def bf(shape, s):
        return np.asarray(J.jnp.asarray(
            rng.standard_normal(shape).astype(np.float32) * s, J.jnp.bfloat16))
    p = {"router": (rng.standard_normal((D, E)) * router_scale
                    ).astype(np.float32),
         "w_gate": bf((E, D, Fe), 0.1), "w_in": bf((E, D, Fe), 0.1),
         "w_out": bf((E, Fe, D), 0.1)}
    if tie:
        p["router"][:, 2] = p["router"][:, 1]
    if cfg.n_shared_experts:
        p.update(shared_gate=bf((D, Fs), 0.1), shared_in=bf((D, Fs), 0.1),
                 shared_out=bf((Fs, D), 0.1))
    return p


def _reference_routes(J, x, p, cfg):
    """The reference's routing of tokens ``x`` (T, D), as its layer
    computes it (the fp32 router product, softmax, ``jax.lax.top_k``)
    and its capacity ranking: (idx (T, K), kept (T, K) with E where
    dropped, margin (T,))."""
    jnp = J.jnp
    T = x.shape[0]
    E, K = cfg.n_experts, cfg.top_k
    probs = J.jax.nn.softmax(jnp.asarray(x, jnp.float32) @ p["router"], -1)
    _, idx = J.jax.lax.top_k(probs, K)
    top = np.sort(np.asarray(probs), -1)[:, ::-1]
    margin = top[:, K - 1] - top[:, K]
    flat = idx.reshape(-1)
    pos = jnp.cumsum(J.jax.nn.one_hot(flat, E, dtype=jnp.int32), 0) - 1
    rank = jnp.take_along_axis(pos, flat[:, None], 1)[:, 0]
    cap = moe.capacity(cfg, T)
    kept = np.where(np.asarray(rank) < cap, np.asarray(flat), E)
    return np.asarray(idx), kept.reshape(T, K), margin


def _routes_agree(got, want_idx, want_kept, want_margin, what):
    """Tokens whose top-k sets and kept experts agree; a difference only
    under ``MARGIN``.  Prints the smallest margin."""
    same = ((np.sort(got["idx"].numpy(), -1) == np.sort(want_idx, -1))
            .all(-1)
            & (np.sort(got["kept"].numpy(), -1) == np.sort(want_kept, -1))
            .all(-1))
    print(f"{what}: {int((~same).sum())} of {len(same)} routes differ; the "
          f"reference's smallest top-k margin {float(want_margin.min()):.3g}")
    assert (want_margin[~same] < MARGIN).all(), what
    return same


@pytest.mark.parametrize("case", ["tiny", "drops", "tie", "dbrx"])
def test_moe_forward_matches_reference(J, case):
    """The layer on one device against the reference's on a (1, 1) mesh:
    routes and kept slots (``drops`` forces dropped tokens at capacity
    factor 0.5; ``tie`` makes experts 1 and 2 tie on every token, where
    both take the lower index first), the output on the tokens whose
    routes agree, the aux loss."""
    cfg = {"tiny": TINY, "drops": DROPS, "tie": TINY,
           "dbrx": TINY_DBRX}[case]
    jcfg = _jcfg(J, cfg)
    p = _layer_params(J, cfg, seed=3, tie=case == "tie")
    x = np.asarray(J.jnp.asarray(np.random.default_rng(4).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32), J.jnp.bfloat16))
    with J.jax.set_mesh(J.mesh):
        jy, jaux = J.moe.forward(
            J.jnp.asarray(x), {k: J.jnp.asarray(v) for k, v in p.items()},
            jcfg, J.plan_for(jcfg, J.mesh), J.mesh,
            policy=J.precision.MIXED)
    tp = from_jax(p)
    with moe.record_routes() as routes:
        y, aux = moe.forward(from_jax({"x": x})["x"], tp, cfg)
    assert len(routes) == 1
    idx, kept, margin = _reference_routes(J, x.reshape(-1, cfg.d_model), p,
                                          cfg)
    same = _routes_agree(routes[0], idx, kept, margin, f"moe {case}")
    dropped = int((kept == cfg.n_experts).sum())
    if case == "drops":
        assert dropped > 0
    if case == "tie":
        top = idx[:, :2]
        both = (top == 1).any(-1) & (top == 2).any(-1)
        one = (top == 1).any(-1) ^ (top == 2).any(-1)
        # where only one of the tied pair is chosen, it is expert 1
        assert not ((top == 2).any(-1) & one).any() and both.any() | one.any()
        assert torch.equal(routes[0]["idx"], torch.from_numpy(idx))
    y = y.reshape(-1, cfg.d_model)
    want = np.asarray(jy.astype(J.jnp.float32)).reshape(-1, cfg.d_model)
    _close(y[torch.from_numpy(same)], want[same], what=f"moe {case} y")
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_sort_free_ranking_keeps_the_references_slots_under_drops(J):
    """At capacity factor 0.5 the kept (token, k) slots are the
    reference's, token order first: the cumsum ranking and the sentinel
    row, with every dropped copy's output zero."""
    cfg = DROPS
    p = _layer_params(J, cfg, seed=11)
    x = _bf16(12, (40, cfg.d_model))
    with moe.record_routes() as routes:
        moe._local(x, from_jax(p), cfg, moe.capacity(cfg, 40), 0,
                   precision.MIXED)
    idx, kept, _ = _reference_routes(
        J, x.float().numpy().astype(np.float32), p, cfg)
    assert torch.equal(routes[0]["idx"], torch.from_numpy(idx))
    assert torch.equal(routes[0]["kept"], torch.from_numpy(kept))
    assert (kept == cfg.n_experts).any()
    # each expert keeps exactly min(load, cap) copies
    cap = moe.capacity(cfg, 40)
    for e in range(cfg.n_experts):
        load = int((idx == e).sum())
        assert int((kept == e).sum()) == min(load, cap)


def test_forced_routes_dispatch_on_the_given_experts():
    """``moe.force_routes``: a run forced onto its own routes gives its
    bits; a run with a perturbed router forced onto the first's routes
    dispatches and keeps as the first did, its gates its own
    probabilities there, and records its own top k (differing from the
    forced ones only at near ties)."""
    cfg = DROPS
    rng = np.random.default_rng(13)
    p = {k: v for k, v in moe_specs_params(cfg, rng).items()}
    x = _bf16(14, (1, 40, cfg.d_model))
    with moe.record_routes() as first:
        y, aux = moe.forward(x, p, cfg)
    with moe.record_routes() as again, moe.force_routes(
            [r["idx"] for r in first]):
        y2, aux2 = moe.forward(x, p, cfg)
    assert torch.equal(y, y2) and torch.equal(aux, aux2)
    assert torch.equal(again[0]["kept"], first[0]["kept"])
    q = dict(p, router=p["router"] + 1e-3 * torch.randn(
        p["router"].shape, generator=torch.Generator().manual_seed(15)))
    with moe.record_routes() as own:
        moe.forward(x, q, cfg)
    with moe.record_routes() as forced, moe.force_routes(
            [r["idx"] for r in first]):
        moe.forward(x, q, cfg)
    assert torch.equal(forced[0]["kept"], first[0]["kept"])
    assert torch.equal(forced[0]["idx"], own[0]["idx"])
    differ = (forced[0]["idx"] != first[0]["idx"]).any(-1)
    assert (forced[0]["margin"][differ] < 5e-3).all()


def moe_specs_params(cfg, rng):
    """One layer's params drawn from ``rng`` at the model's scales."""
    out = {}
    for name, spec in moe.moe_specs(cfg).items():
        v = torch.from_numpy(rng.standard_normal(spec.shape).astype(
            np.float32)) * (0.5 if name == "router" else spec.scale * 5)
        out[name] = v.to(spec.dtype)
    return out


# ---------------------------------------------------------------------------
# the model: loss, aux, gradients, remat, serving# ---------------------------------------------------------------------------
# the model: loss, aux, gradients, remat, serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models(J):
    return _models(J, TINY)


def test_loss_aux_and_every_gradient_match_reference(J, models):
    """2 layers under ``remat="full"``: loss (the lm loss plus
    ``router_aux_coef * aux / n_layers``), aux and every leaf's gradient
    against ``jax.value_and_grad`` of the reference's ``loss_fn``; the
    port's routes printed with their smallest margin."""
    jmodel, params, tmodel, _ = models
    batch = _batch(TINY, 2)
    with J.jax.set_mesh(J.mesh):
        (jloss, jm), jgrads = J.jax.jit(J.jax.value_and_grad(
            jmodel.loss_fn, has_aux=True))(
            params, {k: J.jnp.asarray(v) for k, v in batch.items()})
    tparams = {k: v.requires_grad_(True) for k, v in from_jax(params).items()}
    with moe.record_routes() as routes:
        loss, metrics = tmodel.loss_fn(
            tparams, {k: torch.from_numpy(v).long()
                      for k, v in batch.items()})
    print("smallest top-k margin over the forward's routes: "
          f"{min(float(r['margin'].min()) for r in routes):.3g}")
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=8e-6)
    np.testing.assert_allclose(float(metrics["aux"].detach()),
                               float(jm["aux"]), rtol=1e-5)
    assert float(metrics["aux"]) > 0
    grads = dict(zip(tparams, torch.autograd.grad(loss,
                                                  list(tparams.values()))))
    want = _leaf_grads(J, jgrads)
    assert set(grads) == set(want)
    for name, g in grads.items():
        assert g.dtype == tparams[name].dtype, name
        _close(g, want[name], what=name)


def test_from_jax_carries_the_moe_leaves_bit_for_bit(J, models):
    """The reference's params as the port's: every moe leaf under its
    dotted name with the spec's shape, the router fp32, the banks and the
    shared experts bf16, each bit for bit."""
    _, params, tmodel, tparams = models
    specs = tmodel.param_specs()
    assert set(tparams) == set(specs)
    for name, spec in specs.items():
        assert tparams[name].dtype == spec.dtype, name
        assert tuple(tparams[name].shape) == spec.shape, name
    leaves = params["layers"]["moe"]
    assert tparams["layers.moe.router"].dtype == torch.float32
    for leaf, want in leaves.items():
        got = tparams[f"layers.moe.{leaf}"]
        bits = (got.view(torch.int16) if got.dtype == torch.bfloat16
                else got.view(torch.int32)).numpy()
        assert np.array_equal(bits, np.asarray(want).view(bits.dtype)), leaf


def test_remat_recompute_routes_as_the_forward(models):
    """Under ``remat="full"`` the backward's recompute routes every token
    as the forward did (the same sets, kept slots and margins, bitwise),
    and the gradients are those without remat, bitwise; two runs give the
    same bits."""
    _, _, _, params = models
    batch = {k: torch.from_numpy(v).long()
             for k, v in _batch(TINY, 2, seed=5).items()}
    out = {}
    for remat in ("full", "none", "full"):
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in params.items()}
        with moe.record_routes() as routes:
            loss, _ = Model(TINY, device="cpu", remat=remat).loss_fn(p, batch)
            g = torch.autograd.grad(loss, list(p.values()))
        out.setdefault(remat, []).append((g, routes))
    g_full, r_full = out["full"][0]
    L = TINY.n_layers
    assert len(r_full) == 2 * L
    # the backward recomputes the layers last first
    for a, b in zip(r_full[:L], reversed(r_full[L:])):
        for key in ("idx", "kept", "margin"):
            assert torch.equal(a[key], b[key])
    for g_other, _ in (out["none"][0], out["full"][1]):
        assert all(torch.equal(x, y) for x, y in zip(g_full, g_other))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_prefill_and_decode_match_reference(J, models, paged):
    """A 20-token prompt, then 3 decode steps: the dense cache's one-slot
    prefill and decode step, or a paged prefill chunk and paged decode
    steps, against the reference's same steps, logits at the bf16
    rule."""
    jmodel, params, tmodel, tparams = models
    P, steps, T = 20, 3, 32
    toks = np.random.default_rng(6).integers(0, TINY.vocab_size,
                                             (1, P + steps))
    jnp = J.jnp
    with J.jax.set_mesh(J.mesh):
        if paged:
            jcache = jmodel.init_paged_cache(1, T, page_size=8)
            jl, jcache = jmodel.prefill_chunk_paged(
                params, jcache, jnp.asarray(toks[:, :P], jnp.int32),
                jcache["table"][0], jnp.asarray(0, jnp.int32))
            want = [np.asarray(jl[0, -1], np.float32)]
            for s in range(steps):
                jl, jcache = jmodel.decode_step_paged(
                    params, jcache, jnp.asarray(toks[:, P + s:P + s + 1],
                                                jnp.int32),
                    jnp.asarray([P + s], jnp.int32))
                want.append(np.asarray(jl[0, 0], np.float32))
        else:
            jcache = jmodel.init_cache(1, T)
            pre = J.jax.jit(J.prefill_fn(jmodel))
            jl, jcache = pre(params, jcache, jnp.asarray(toks[:, :P],
                                                         jnp.int32),
                             jnp.asarray(0, jnp.int32))
            want = [np.asarray(jl[0], np.float32)]
            for s in range(steps):
                jl, jcache = jmodel.decode_step(
                    params, jcache, jnp.asarray(toks[:, P + s:P + s + 1],
                                                jnp.int32),
                    jnp.asarray([P + s], jnp.int32))
                want.append(np.asarray(jl[0, 0], np.float32))
    tt = torch.from_numpy(toks).long()
    with torch.no_grad(), moe.record_routes() as routes:
        if paged:
            cache = tmodel.init_paged_cache(1, T, page_size=8)
            lg, cache = tmodel.prefill_chunk_paged(
                tparams, cache, tt[:, :P], cache["table"][0], 0)
            got = [lg[0, -1]]
            for s in range(steps):
                lg, cache = tmodel.decode_step_paged(
                    tparams, cache, tt[:, P + s:P + s + 1],
                    torch.tensor([P + s]))
                got.append(lg[0, 0])
        else:
            cache = tmodel.init_cache(1, T)
            lg, cache = tmodel.prefill(tparams, tt[:, :P], cache=cache,
                                       slot=0)
            got = [lg[0, -1]]
            for s in range(steps):
                lg, cache = tmodel.decode_step(
                    tparams, cache, tt[:, P + s:P + s + 1],
                    torch.tensor([P + s]))
                got.append(lg[0, 0])
    print("smallest top-k margin over the port's routes: "
          f"{min(float(r['margin'].min()) for r in routes):.3g}")
    _close(torch.stack(got), np.stack(want), what="logits")


def test_moe_serves_on_pages():
    """moe's uniform full-attention layers take the paged cache (the
    reference's ``paged_supported`` covers moe)."""
    assert Model(TINY, device="cpu").paged_supported()
    assert Model(TINY_DBRX, device="cpu").paged_supported()


ENGINE_PROMPTS = (5, 12, 20, 9)
ENGINE_NEW = 6


def _engine_prompts():
    rng = np.random.default_rng(2)
    return [rng.integers(0, TINY.vocab_size, n).astype(np.int32)
            for n in ENGINE_PROMPTS]


@pytest.mark.parametrize("kind", ["dense", "paged", "continuous"])
def test_engine_tokens_match_the_same_reference_engine(J, models, kind):
    """Each engine's greedy streams against the same engine of the
    reference on the same weights (capacity is per call, so each engine
    is held against its own kind, never against another)."""
    jmodel, params, tmodel, tparams = models
    kw = dict(batch_slots=2, max_seq=40)
    if kind != "dense":
        kw.update(page_size=8, prefill_chunk=8)
    if kind == "paged":
        kw["paged"] = True
    jcls = J.JContinuous if kind == "continuous" else J.JEngine
    tcls = ContinuousEngine if kind == "continuous" else Engine
    with J.jax.set_mesh(J.mesh):
        eng = jcls(jmodel, params, **kw)
        for rid, p in enumerate(_engine_prompts()):
            eng.submit(J.JRequest(rid=rid, prompt=p,
                                  max_new_tokens=ENGINE_NEW))
        want = {r.rid: list(r.out) for r in eng.run()}
    eng = tcls(tmodel, tparams, **kw)
    for rid, p in enumerate(_engine_prompts()):
        eng.submit(Request(rid=rid, prompt=p, max_new_tokens=ENGINE_NEW))
    got = {r.rid: list(r.out) for r in eng.run()}
    assert got == want


def _reference_steps(J, jmodel, params, batches, adamw):
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


def test_three_session_steps_match_reference(J, models):
    """``Session.plan/step`` for three steps against the reference's
    gspmd step from the same weights: losses, aux, learning rates and
    grad norms, and the params after each step by
    ``test_torch_train``'s step rule."""
    from test_torch_train import _steps_agree
    jmodel, params, _, _ = models
    batches = [_batch(TINY, 2, seed=20 + t) for t in range(3)]
    want = _reference_steps(
        J, jmodel, params, batches,
        J.opt.AdamWConfig(lr=J.opt.warmup_cosine(PEAK, WARMUP, TOTAL)))
    sess = Session(device="cpu")
    plan = sess.plan(TINY, batch=2, seq=SEQ, comms="off",
                     adamw=topt.AdamWConfig(
                         lr=topt.warmup_cosine(PEAK, WARMUP, TOTAL)))
    assert plan.path == "gspmd"
    sess.init_state(plan, params=from_jax(params))
    p0 = _leaf_grads(J, params)
    lrs = []
    for b, w in zip(batches, want):
        m = {k: float(v) for k, v in sess.step(plan, b).items()}
        lrs.append(m["lr"])
        np.testing.assert_allclose(m["aux"], w[0]["aux"], rtol=1e-3)
        got = {k: v.detach().float().numpy()
               for k, v in sess.state["train_state"]["params"].items()}
        _steps_agree(m, got, w, p0, lrs)


def test_train_cli_losses_match_the_references(J, tmp_path, monkeypatch):
    """``launch.train --arch deepseek-moe-16b --scale-down 64`` against
    the reference's CLI from its step-0 state (``test_torch_launch``'s
    arrangement: the reference writes the state, the port resumes it):
    losses at the step rule.  The first step's loss is one forward's, but
    its tokens route at near ties: the router's input, the rms norm of the
    embedding, parts by fp32 roundings that round a few bf16 elements the
    other way (XLA's rsqrt), and a (token, layer) top-k set at a margin
    near 1e-4 may flip and move that token's loss (at this seed the aux
    loss moves by 2e-4 relative and the loss by 2.1e-5, the margins over
    1.5e-4; one layer alone at another seed 2.0e-5): rtol 5e-5."""
    from repro.launch import train as jtrain

    from repro_torch.launch import train as ttrain
    from test_torch_launch import _one_worker
    _one_worker(jtrain, monkeypatch)
    _one_worker(ttrain, monkeypatch)
    kw = dict(batch=2, seq=32, scale_down=64, comms="off")
    ck = str(tmp_path / "ck")
    assert jtrain.run(DEEPSEEK, steps=0, ckpt_dir=ck, **kw) == []
    want = jtrain.run(DEEPSEEK, steps=3, log_every=1, **kw)
    got = ttrain.run(DEEPSEEK, steps=3, ckpt_dir=ck, resume=True,
                     device="cpu", log_every=1, **kw)
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-3)
    np.testing.assert_allclose(got[0], want[0], rtol=5e-5)
    losses = ttrain.run(DBRX, steps=2, device="cpu", **kw)
    assert len(losses) == 2 and all(np.isfinite(losses))


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

def test_moe_train_cells_are_not_skipped():
    from repro_torch.launch import dryrun
    for arch in (DEEPSEEK, DBRX):
        assert dryrun.skip_reason(arch, "train_4k") is None
        assert "item 13" in dryrun.skip_reason(arch, "decode_32k")


def test_moe_train_4k_traces_on_the_production_mesh(tmp_path, capsys):
    """deepseek-moe-16b's ``train_4k``, scaled down 4, on 16 x 16 (16
    experts: one a rank of the model axis): the step traced, the batched
    GEMM's shape function called, the collectives of ``forward_mesh``
    recorded."""
    from repro_torch.launch import dryrun
    res = dryrun.run_cell(DEEPSEEK, "train_4k", multi_pod=False,
                          scale_down=4)
    assert res["memory"]["peak_bytes"] > 0
    assert res["cost"]["kernel_calls"]["matmul"] > 0
    assert res["collectives"]
    json.dumps(res)


# ---------------------------------------------------------------------------
# the card (skipped here)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("e,m,k,n", [(64, 8, 2048, 1408), (64, 15, 1408, 2048),
                                     (16, 40, 6144, 1024), (3, 5, 130, 66)])
def test_batched_gemm_kernel_is_the_2d_kernel_per_expert(cuda, e, m, k, n):
    """One launch for the bank: against the plain version at the bf16
    tolerance, each expert's slice bitwise the 2-D kernel, run to run
    bitwise, and the backward products on the transposed views bitwise
    the 2-D kernel's per expert."""
    a, b = _bf16(1, (e, m, k)).to(cuda), _bf16(2, (e, k, n), 0.05).to(cuda)
    before = gemm.launches, gemm.batched_launches
    got = gemm.matmul(a, b, torch.float32)
    assert (gemm.launches - before[0], gemm.batched_launches - before[1]) \
        == (1, 1)
    torch.testing.assert_close(got, ref.matmul(a, b, torch.float32),
                               rtol=3e-2, atol=2e-2)
    assert torch.equal(got, gemm.matmul(a, b, torch.float32))
    dc = _bf16(3, (e, m, n)).to(cuda)
    da = gemm.matmul(dc, b.mT, torch.bfloat16)
    db = gemm.matmul(a.mT, dc, torch.bfloat16)
    for i in range(e):
        assert torch.equal(got[i], gemm.matmul(a[i], b[i], torch.float32))
        assert torch.equal(da[i], gemm.matmul(dc[i], b[i].t(),
                                              torch.bfloat16))
        assert torch.equal(db[i], gemm.matmul(a[i].t(), dc[i],
                                              torch.bfloat16))


# ---------------------------------------------------------------------------
# a (data, model) mesh: 4 gloo ranks against the reference on 4 devices
# ---------------------------------------------------------------------------

MESH_FIELDS = {f: getattr(TINY, f) for f in (
    "n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
    "vocab_size", "n_experts", "top_k", "d_ff_expert")}


def _mesh_cases():
    import test_torch_parallel as P
    return [
        # head-TP attention, the sequence-parallel residual: the bf16
        # gather, the banks' reduce-scatter, the shared experts' fp32
        # reduce-scatter
        P._case("moe_sp_2x2", DEEPSEEK, MESH_FIELDS, (2, 2)),
        # SP attention (2 heads on 4 ranks) and the replicated FFN
        # (the shared experts whole on each rank, on its sequence shard)
        P._case("moe_sp_1x4", DEEPSEEK, MESH_FIELDS, (1, 4)),
        # the replicated residual: copy_ad, the banks' bf16 psum, the
        # GSPMD-style shared experts
        P._case("moe_replicated_2x2", DEEPSEEK, MESH_FIELDS, (2, 2),
                plan_kw=dict(seq_parallel_residual=False)),
    ]


def _mesh_inputs(cases):
    """Global params per case config (numpy-seeded, the reference's init
    rule, bf16 values but the fp32 router) and two batches, keyed as
    ``tests/test_torch_parallel.py``'s child scripts read them."""
    import test_torch_parallel as P
    rng = np.random.default_rng(5)
    data = {}
    for c in cases:
        tag = P._cfg_tag(c["arch"], c["fields"])
        if any(k.startswith(f"p/{tag}/") for k in data):
            continue
        for name, spec in Model(P._cfg(c), device="cpu").param_specs().items():
            v = (np.ones(spec.shape, np.float32) if spec.init == "ones"
                 else rng.standard_normal(spec.shape).astype(np.float32)
                 * np.float32(spec.scale))
            data[f"p/{tag}/{name}"] = (
                v if spec.dtype == torch.float32 else torch.from_numpy(v)
                .to(torch.bfloat16).float().numpy())
    for t in range(P.STEPS):
        tok = rng.integers(0, TINY.vocab_size, (P.BATCH, P.SEQ)
                           ).astype(np.int32)
        lab = np.roll(tok, -1, axis=1)
        lab[:, -1] = -1
        data[f"b{t}/tokens"], data[f"b{t}/labels"] = tok, lab
    return data


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """The cases on both sides, started together: ``test_torch_parallel``'s
    reference child, one a case (4 fake devices: the forward,
    ``value_and_grad`` of ``loss_fn``, two gspmd ZeRO-1 steps) and its
    port ranks' per-case
    loop (4 gloo CPU ranks: the same through the mesh model and
    ``Session``), on this file's cases and inputs."""
    pytest.importorskip("jax")
    import test_torch_parallel as P
    cases = _mesh_cases()
    inputs = _mesh_inputs(cases)
    tmp = tmp_path_factory.mktemp("moe_mesh")
    np.savez(tmp / "in.npz", **inputs)
    (tmp / "cases.json").write_text(json.dumps(cases))
    jax_procs = []
    for i, c in enumerate(cases):             # one child a case, at once
        (tmp / f"case{i}.json").write_text(json.dumps([c]))
        jax_procs.append(subprocess.Popen(
            [sys.executable, "-c", P._JAX_SIDE, str(tmp / "in.npz"),
             str(tmp / f"jax{i}.npz"), str(tmp / f"case{i}.json")],
            env=P._env(XLA_FLAGS="--xla_force_host_platform_device_count=4"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    # the port ranks' per-case loop, without the dense-only checks after it
    rank_src = P._PORT_RANK.split("# 2 rows on 4 data ranks")[0] \
        + "np.savez(dst, **out)\nclose_group()\n"
    init = f"file://{tmp / 'rendezvous'}"
    ranks = [subprocess.Popen(
        [sys.executable, "-c", rank_src, str(tmp / "in.npz"), str(r), init,
         str(tmp / f"t{r}.npz"), str(tmp / "cases.json")],
        env=P._env(OMP_NUM_THREADS="1"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(P.RANKS)]
    outs = [p.communicate(timeout=600)[0] for p in ranks]
    for p, out in zip(ranks, outs):
        assert p.returncode == 0, out[-3000:]
    ref = {}
    for i, p in enumerate(jax_procs):
        jout = p.communicate(timeout=600)[0]
        assert p.returncode == 0, jout[-3000:]
        ref.update(np.load(tmp / f"jax{i}.npz"))
    port = {}
    for r in range(P.RANKS):
        port.update(np.load(tmp / f"t{r}.npz"))
    return SimpleNamespace(port=port, ref=ref,
                           cases={c["id"]: c for c in cases}, inputs=inputs)


MESH_IDS = ["moe_sp_2x2", "moe_sp_1x4", "moe_replicated_2x2"]


@pytest.mark.parametrize("cid", MESH_IDS)
def test_mesh_forward_loss_and_gradients_match_reference(mesh_runs, cid):
    """``forward_mesh`` in the model on the mesh: each rank's block of the
    logits, its loss (the lm loss plus the aux term, aux the mean of the
    batch shards'), and every leaf's gradient synced onto its ZeRO block
    (the router's summed over the model and batch axes, the banks' over
    the batch axes) against the reference's on the same mesh, by
    ``test_torch_parallel``'s rules."""
    import test_torch_parallel as P
    from repro_torch.core.layout import Layout
    port, ref, case = mesh_runs.port, mesh_runs.ref, mesh_runs.cases[cid]
    shape = tuple(case["shape"])
    lay = Layout(("data" if P._rows_split(case) else None, None, "model"))
    _, zero = P._layouts(case)
    for r in range(P.RANKS):
        P._rule(port[f"{cid}/logits|{r}"],
                P._block(ref[f"{cid}/logits"], lay, shape, r),
                np.abs(ref[f"{cid}/logits"]).max(), what=f"rank {r}")
        np.testing.assert_allclose(port[f"{cid}/loss|{r}"],
                                   ref[f"{cid}/loss"], rtol=1e-4)
        for name, z in zero.items():
            P._rule(port[f"{cid}/grad/{name}|{r}"],
                    P._block(ref[f"{cid}/grad/{name}"], z, shape, r),
                    np.abs(ref[f"{cid}/grad/{name}"]).max(),
                    what=f"{name} rank {r}")
    assert any("moe.router" in k for k in zero)


@pytest.mark.parametrize("cid", MESH_IDS)
def test_mesh_zero1_steps_match_reference(mesh_runs, cid):
    """Two ZeRO-1 AdamW steps through ``Session`` on the mesh: losses,
    aux, learning rates and grad norms, then the params and moments
    after the steps, by ``test_torch_parallel``'s step rule."""
    import test_torch_parallel as P
    port, ref, case = mesh_runs.port, mesh_runs.ref, mesh_runs.cases[cid]
    shape = tuple(case["shape"])
    want = json.loads(str(ref[f"{cid}/metrics"]))
    for r in range(P.RANKS):
        got = json.loads(str(port[f"{cid}/metrics|{r}"]))
        for g, w in zip(got, want):
            for k in ("loss", "aux", "lr", "tokens"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-3,
                                           err_msg=f"{k} rank {r}")
            np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                       rtol=2.0 ** -9, err_msg=f"rank {r}")
    storage, zero = P._layouts(case)
    tag = P._cfg_tag(case["arch"], case["fields"])
    lrs = [m["lr"] for m in json.loads(str(port[f"{cid}/metrics|0"]))]
    bound = 2 * sum(lrs) * 1.2
    ug, uw, moments = [], [], {}
    for name, s in storage.items():
        for r in range(P.RANKS):
            got = port[f"{cid}/params/{name}|{r}"]
            want_p = P._block(ref[f"{cid}/params/{name}"], s, shape, r)
            start = P._block(mesh_runs.inputs[f"p/{tag}/{name}"], s, shape,
                             r)
            d = np.abs(got - want_p)
            assert d.max() <= bound + np.abs(want_p).max() * 2.0 ** -7, name
            ug.append((got - start).ravel())
            uw.append((want_p - start).ravel())
            for slot in ("mu", "nu"):
                g = port[f"{cid}/{slot}/{name}|{r}"]
                w = P._block(ref[f"{cid}/{slot}/{name}"], zero[name], shape,
                             r)
                sq = moments.setdefault(slot, [0.0, 0.0])
                sq[0] += float(((g - w) ** 2).sum())
                sq[1] += float((w ** 2).sum())
    for slot, (dd, ww) in moments.items():
        assert dd < (5e-2) ** 2 * ww, (slot, (dd / ww) ** 0.5)
    ug, uw = np.concatenate(ug), np.concatenate(uw)
    half = 0.5 * lrs[-1]
    against = (np.sign(ug) != np.sign(uw)) & (np.abs(uw) > half) \
        & (np.abs(ug) > half)
    assert against.mean() < 5e-3
    assert np.linalg.norm(ug - uw) < 0.1 * np.linalg.norm(uw)


# ---------------------------------------------------------------------------
# the pipeline: GPipe and 1F1B against the single-stage step
# ---------------------------------------------------------------------------

_PIPE_RANKS = r"""
import json, sys, torch
from repro_torch.api import Session
from repro_torch.core import distributed as D
from repro_torch.models import layers as L
sys.path.insert(0, sys.argv[5])
import test_torch_pipeline as P
import test_torch_moe as T
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
    plan = sess.plan(T.TINY, batch=P.B, seq=P.SEQ, comms="off",
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
    """GPipe and 1F1B on 2 gloo CPU ranks (pp = 2, one layer a stage),
    ``test_torch_pipeline``'s batch, 2 microbatches and 2 steps, and the
    port's single-stage step on the same microbatches."""
    import test_torch_pipeline as P
    tmp = tmp_path_factory.mktemp("moe_pipe")
    params = Model(TINY, device="cpu").init(0)
    torch.save(params, tmp / "params.pt")
    out = str(tmp / "rank{}.json")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _PIPE_RANKS, str(r), "2",
         f"file://{tmp / 'rdv'}", out, str(ROOT / "tests"),
         str(tmp / "params.pt")],
        env=P._env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    single = P._single_stage(TINY, params, P.MB)
    logs = [p.communicate(timeout=600)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-6000:]
    ranks = [json.loads(Path(out.format(r)).read_text()) for r in range(2)]
    return SimpleNamespace(ranks=ranks, single=single)


@pytest.mark.parametrize("sched", ["gpipe", "1f1b"])
def test_pipeline_step_matches_the_single_stage_step(pipe_runs, sched):
    """Every step-1 microbatch lm loss bitwise the single-stage step's
    (1F1B's backward-slot recompute the same bits as its forward slot);
    the step's loss (the lm mean plus ``router_aux_coef * aux /
    n_layers``) and aux (the stages' sum, the microbatches' mean) within
    1e-6 relative; the grad norm within 2^-9; the second step too within
    the step rule."""
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
        for k in ("loss", "aux"):
            assert math.isclose(got[k], want[k], rel_tol=1e-6), k
        assert got["aux"] > 0
        assert math.isclose(got["grad_norm"], want["grad_norm"],
                            rel_tol=2.0 ** -9)
        got2 = P._metrics(res[sched], 1)
        np.testing.assert_allclose(got2["loss"], want2["loss"], rtol=1e-3)
