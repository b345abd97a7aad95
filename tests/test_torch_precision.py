"""The ``FULL`` and ``HALF_STORAGE`` policies at the model level, against
the JAX reference's ``Model(cfg, policy=...)``.

qwen2-0.5b cut to 2 layers (``scale_config(..., 16)``), the reference's
init through ``from_jax``, a ``SyntheticLM`` batch: the forward's logits,
``lm_loss`` and every parameter gradient under each policy.  Both policies
compute every projection on fp32 operands (the GEMM kernel's fp32 path on
the card) while the weights stay bf16; attention still takes bf16 q, k
and v (the projections return the hidden's dtype, as the reference's
``attention.py:83`` does, after the embedding's bf16 cast,
``transformer.py:218``), so neither policy needs an fp32 flash backward.

Tolerances (``tests/test_torch_train.py``'s and ``test_torch_model.py``'s
rules): the loss rtol 8e-6; the logits, computed from the bf16 residual
stream (where a rounding may fall the other way), and the gradients,
stored in bf16: 2e-2 of each value plus 2e-2 of the largest (the repo's
bf16 rule).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, scale_config  # noqa: E402
from repro_torch.core import precision  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.params import from_jax  # noqa: E402

CFG = scale_config(get_config("qwen2-0.5b"), 16)
SEQ = 64


@pytest.fixture(scope="module")
def J():
    pytest.importorskip("jax")
    import repro  # noqa: F401  (installs the JAX compat shims)
    import jax
    import jax.numpy as jnp
    from repro.configs.base import get_config as jget_config
    from repro.core import precision as jprecision
    from repro.core.planner import plan_for
    from repro.launch.mesh import make_mesh
    from repro.models import Model as JModel
    mesh = make_mesh((1, 1), ("data", "model"))
    jcfg = dataclasses.replace(jget_config(CFG.name),
                               **dataclasses.asdict(CFG))
    with jax.set_mesh(mesh):
        plan = plan_for(jcfg, mesh)
        params = jax.tree.map(np.asarray, JModel(jcfg, mesh, plan).init(
            jax.random.PRNGKey(0)))
    return dict(jax=jax, jnp=jnp, mesh=mesh, cfg=jcfg, plan=plan,
                params=params, JModel=JModel, precision=jprecision)


def _leaf_grads(jax, tree):
    return {".".join(k.key for k in path): np.asarray(v, np.float32)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close(got, want, rtol, frac):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=frac * float(np.abs(want).max()))


@pytest.mark.parametrize("name", ["FULL", "HALF_STORAGE"])
def test_forward_loss_and_gradients_match_reference(J, name):
    jax, jnp = J["jax"], J["jnp"]
    jmodel = J["JModel"](J["cfg"], J["mesh"], J["plan"],
                         policy=getattr(J["precision"], name))
    tmodel = Model(CFG, device="cpu", policy=getattr(precision, name))
    batch = next(iter(SyntheticLM(CFG.vocab_size, 2, SEQ, seed=0,
                                  structured=True)))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with jax.set_mesh(J["mesh"]):
        jlogits = jax.jit(lambda p, t: jmodel.forward(p, t)[0])(
            J["params"], jb["tokens"])
        (jloss, _), jgrads = jax.jit(jax.value_and_grad(
            jmodel.loss_fn, has_aux=True))(J["params"], jb)
    tparams = {k: v.requires_grad_(True)
               for k, v in from_jax(J["params"]).items()}
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    with torch.no_grad():
        logits = tmodel.forward(tparams, tb["tokens"])[0]
    assert logits.dtype == torch.float32
    _close(logits, jlogits, rtol=2e-2, frac=2e-2)
    loss, _ = tmodel.loss_fn(tparams, tb)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=8e-6)
    grads = dict(zip(tparams, torch.autograd.grad(loss,
                                                  list(tparams.values()))))
    want = _leaf_grads(jax, jgrads)
    assert set(grads) == set(want)
    for leaf, g in grads.items():
        assert g.dtype == tparams[leaf].dtype, leaf
        _close(g, want[leaf], rtol=2e-2, frac=2e-2)


def test_policies_feed_attention_bf16_and_the_gemm_fp32(monkeypatch):
    """Under both policies every GEMM operand is fp32 and every attention
    input bf16 (the flash kernel's bf16 path, forward and backward)."""
    from repro_torch.kernels import ops
    seen = {"matmul": set(), "attention": set()}
    real_mm, real_attn = ops.matmul, ops.attention

    def mm(a, b, out_dtype=None):
        seen["matmul"].add((a.dtype, b.dtype, out_dtype))
        return real_mm(a, b, out_dtype)

    def attn(q, k, v, **kw):
        seen["attention"].add(q.dtype)
        return real_attn(q, k, v, **kw)

    monkeypatch.setattr(ops, "matmul", mm)
    monkeypatch.setattr(ops, "attention", attn)
    batch = next(iter(SyntheticLM(CFG.vocab_size, 1, 16, seed=1)))
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    for name in ("FULL", "HALF_STORAGE"):
        model = Model(CFG, device="cpu", policy=getattr(precision, name))
        params = {k: v.requires_grad_(True) for k, v in model.init(0).items()}
        loss, _ = model.loss_fn(params, tb)
        torch.autograd.grad(loss, list(params.values()))
    assert seen["matmul"] == {(torch.float32, torch.float32, torch.float32)}
    assert seen["attention"] == {torch.bfloat16}
