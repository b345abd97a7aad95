"""The port's AlexNet (``models/convnet.py``) against the JAX reference's.

``scale_down=8`` (conv channels 12, 32, 48, 48, 32; fc 512), 100 classes,
a batch of 8 NHWC images at 64² and 67².  Weights are numpy-seeded (bf16
values; the conv biases small and nonzero, so their use shows), carried
into the port by ``from_jax`` (HWIO conv weights as they are) and into
the reference as bf16 arrays.  The reference runs in one subprocess on 4
fake CPU devices, at (1,1) and (2,2) (``jax.value_and_grad`` of its
``loss_fn`` and its ``forward``, jitted); the port at (1,1) here and at
(2,2) as 4 gloo ranks, all started together.  At (2,2) each rank's
logits rows and gradient blocks are held against the reference's global
arrays at the rank's coordinates.

Tolerances, derived:

- Loss: fp32 ``logsumexp - gold`` of logits that agree to a few bf16
  roundings: rtol 1e-5 (measured 6.5e-7 at (1,1)).
- Logits: 2e-2 of the largest and rtol 2e-2 (the parallel tests' rule;
  measured 0.26% and 0.36% of the largest at 64² and 67²).
- Gradients: the conv's fp32 sums run in another order than XLA's, so
  about 2% of the bf16 activations round one ulp the other way, and a
  ReLU input within that ulp of zero passes or stops a whole row's
  gradient.  So the repo's bf16 rule (2e-2 of each value plus 2e-2 of
  the leaf's largest) holds for all but 0.5% of each leaf's elements
  (measured: none outside at 64², 0.16% of ``fc1_w`` at 67²), and each
  leaf is within 5e-2 relative rms (phase 6's card-against-CPU rule;
  measured up to 2.7%, ``conv2_b`` at 67²).

At 64² conv0's SAME pad is 3 rows above and 4 below (XLA's rule, which
``F.conv2d``'s symmetric padding cannot express); 67² pads 4 and 4 and
pools conv0's 17 rows to 8, conv1's 8 to 3, the last 3 to 1.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.distributed import Mesh  # noqa: E402
from repro_torch.core.planner import ParallelPlan  # noqa: E402
from repro_torch.models import Model, convnet  # noqa: E402
from repro_torch.models.params import from_jax  # noqa: E402

from test_torch_kernels import _config_matches_reference  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
SIZES, CLASSES, DOWN, BATCH, RANKS = (64, 67), 100, 8, 8, 4
SHAPES = ((1, 1), (2, 2))
PLAN = ParallelPlan(batch_axes=("data",), tp_axis="model", attn_mode="none",
                    fsdp=False, seq_parallel_residual=False)
GRAD_RULE, GRAD_OUTSIDE, GRAD_RMS = 2e-2, 5e-3, 5e-2


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _inputs():
    """Per image size: the global params (bf16 values as fp32), the
    images (bf16 values) and the labels."""
    rng = np.random.default_rng(0)
    data = {}
    for size in SIZES:
        specs = convnet.param_specs(PLAN, None, n_classes=CLASSES,
                                    scale_down=DOWN)
        meta = specs.pop("_meta")
        flat = int(np.prod(convnet.feature_shape(size, meta["c_last"])))
        shapes = {k: s.shape for k, s in specs.items()}
        shapes.update(fc1_w=(flat, meta["fc"]), fc2_w=(meta["fc"],) * 2,
                      fc3_w=(meta["fc"], CLASSES))
        for name, shape in shapes.items():
            std = 0.05 if name.startswith("conv") and name.endswith("_w") \
                else 0.02
            data[f"{size}/p/{name}"] = _bf16(
                rng.standard_normal(shape).astype(np.float32) * std)
        data[f"{size}/images"] = _bf16(rng.standard_normal(
            (BATCH, size, size, 3)).astype(np.float32))
        data[f"{size}/labels"] = rng.integers(0, CLASSES, BATCH).astype(
            np.int32)
    return data


_COMMON = """
import json, sys
import numpy as np
data = dict(np.load(sys.argv[1]))
SIZES = %r
def params_of(size):
    pre = f"{size}/p/"
    return {k[len(pre):]: v for k, v in data.items() if k.startswith(pre)}
""" % (SIZES,)

_JAX_SIDE = _COMMON + textwrap.dedent("""
    import repro  # noqa: F401  (installs the JAX compat shims)
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.core.planner import ParallelPlan
    from repro.models import convnet
    plan = ParallelPlan(batch_axes=("data",), tp_axis="model",
                        attn_mode="none", fsdp=False,
                        seq_parallel_residual=False)
    SPECS = {"fc1_w": P(None, "model"), "fc2_w": P("model", None)}
    out = {}
    for shape in ((1, 1), (2, 2)):
        n = shape[0] * shape[1]
        mesh = jax.make_mesh(shape, ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2,
                             devices=jax.devices()[:n])
        tag = f"{shape[0]}x{shape[1]}"
        with jax.set_mesh(mesh):
            for size in SIZES:
                params = {k: jax.device_put(
                    jnp.asarray(v, jnp.bfloat16),
                    NamedSharding(mesh, SPECS.get(k, P())))
                    for k, v in params_of(size).items()}
                imgs = jax.device_put(
                    jnp.asarray(data[f"{size}/images"], jnp.bfloat16),
                    NamedSharding(mesh, P("data")))
                labels = jax.device_put(jnp.asarray(data[f"{size}/labels"]),
                                        NamedSharding(mesh, P("data")))
                loss, grads = jax.jit(jax.value_and_grad(
                    lambda p: convnet.loss_fn(p, imgs, labels, plan)))(params)
                logits = jax.jit(lambda p: convnet.forward(p, imgs, plan))(
                    params)
                key = f"{tag}/{size}"
                out[key + "/loss"] = np.asarray(loss, np.float32)
                out[key + "/logits"] = np.asarray(logits, np.float32)
                for k, v in grads.items():
                    out[key + "/grad/" + k] = np.asarray(v, np.float32)
    np.savez(sys.argv[2], **out)
""")

_PORT_RANK = _COMMON + textwrap.dedent("""
    import torch
    import torch.distributed as dist
    from repro_torch.core import distributed as D
    from repro_torch.core.distributed import Mesh, close_group, init_group
    from repro_torch.core.planner import ParallelPlan
    from repro_torch.models import convnet
    from repro_torch.models.params import from_jax
    rank, init, dst = int(sys.argv[2]), sys.argv[3], sys.argv[4]
    init_group(init, rank=rank, world_size=4, device="cpu")
    plan = ParallelPlan(batch_axes=("data",), tp_axis="model",
                        attn_mode="none", fsdp=False,
                        seq_parallel_residual=False)
    mesh = Mesh((2, 2), ("data", "model"), dist.group.WORLD)
    out = {}
    for size in SIZES:
        params = {k: v.to(torch.bfloat16) for k, v in from_jax(
            params_of(size), mesh=mesh,
            layouts=convnet.param_layouts(plan)).items()}
        imgs = torch.from_numpy(data[f"{size}/images"]).to(torch.bfloat16)
        labels = torch.from_numpy(data[f"{size}/labels"])
        with torch.no_grad():
            logits = convnet.forward(params, imgs, plan, mesh=mesh)
        D.WIRE.reset()
        loss, grads = convnet.value_and_grad(params, imgs, labels, plan,
                                             mesh=mesh)
        key = f"{size}"
        out[f"{key}/wire|{rank}"] = np.array(json.dumps(
            dict(got=dict(D.WIRE.bytes), want=convnet.wire_bytes(
                params, imgs.shape[0], plan, mesh))))
        out[f"{key}/logits|{rank}"] = logits.float().numpy()
        out[f"{key}/loss|{rank}"] = loss.float().numpy()
        for k, g in grads.items():
            out[f"{key}/grad/{k}|{rank}"] = g.float().numpy()
            out[f"{key}/dtype/{k}|{rank}"] = np.array(str(g.dtype))
    np.savez(dst, **out)
    close_group()
""")


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), **extra)
    env.setdefault("JAX_PLATFORMS", "cpu")
    return env


_INPUTS = _inputs()


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The reference at (1,1) and (2,2) and the port's 4 ranks at (2,2),
    started together: (port, reference)."""
    pytest.importorskip("jax")
    tmp = tmp_path_factory.mktemp("convnet")
    np.savez(tmp / "in.npz", **_INPUTS)
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_SIDE, str(tmp / "in.npz"),
         str(tmp / "jax.npz")],
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    init = f"file://{tmp / 'rendezvous'}"
    ranks = [subprocess.Popen(
        [sys.executable, "-c", _PORT_RANK, str(tmp / "in.npz"), str(r), init,
         str(tmp / f"t{r}.npz")],
        env=_env(OMP_NUM_THREADS="1"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(RANKS)]
    for p in ranks:
        out = p.communicate(timeout=600)[0]
        assert p.returncode == 0, out[-3000:]
    out = jax_proc.communicate(timeout=600)[0]
    assert jax_proc.returncode == 0, out[-3000:]
    port = {}
    for r in range(RANKS):
        port.update(np.load(tmp / f"t{r}.npz"))
    return port, dict(np.load(tmp / "jax.npz"))


def _global_params(size):
    pre = f"{size}/p/"
    return {k[len(pre):]: v for k, v in _INPUTS.items()
            if k.startswith(pre)}


def _one_rank(size):
    """The port at (1,1): logits, loss and gradients."""
    params = {k: v.to(torch.bfloat16)
              for k, v in from_jax(_global_params(size)).items()}
    imgs = torch.from_numpy(_INPUTS[f"{size}/images"]).to(torch.bfloat16)
    labels = torch.from_numpy(_INPUTS[f"{size}/labels"])
    with torch.no_grad():
        logits = convnet.forward(params, imgs, PLAN)
    loss, grads = convnet.value_and_grad(params, imgs, labels, PLAN)
    return logits, loss, grads


def _logits_close(got, want):
    np.testing.assert_allclose(got, want, rtol=2e-2,
                               atol=2e-2 * float(np.abs(want).max()))


def _grad_close(got, want, what):
    assert got.shape == want.shape, what
    err = np.abs(got - want)
    outside = err > GRAD_RULE * (np.abs(want) + np.abs(want).max())
    rms = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert outside.mean() <= GRAD_OUTSIDE, (what, outside.mean())
    assert rms <= GRAD_RMS, (what, rms)


def _coords(shape, r):
    return SimpleNamespace(
        shape=dict(zip(("data", "model"), shape)),
        coords=dict(zip(("data", "model"),
                        (int(i) for i in np.unravel_index(r, shape)))))


# ---------------------------------------------------------------------------
# the config and the layer's shapes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def J():
    pytest.importorskip("jax")
    import repro  # noqa: F401  (installs the JAX compat shims)
    from repro.configs import base
    return SimpleNamespace(base=base)


def test_alexnet_config_matches_reference_field_by_field(J):
    _config_matches_reference(J, "alexnet")
    assert "alexnet" not in J.base.ARCH_IDS


def test_same_pad_is_xlas_and_the_flatten_is_9216_at_224():
    assert convnet.same_pad(224, 11, 4) == (3, 4)
    assert convnet.same_pad(64, 11, 4) == (3, 4)
    assert convnet.same_pad(67, 11, 4) == (4, 4)
    assert convnet.same_pad(27, 5, 1) == (2, 2)
    assert convnet.feature_shape(224, 256) == (6, 6, 256)


def test_full_width_init_has_the_networks_62m_parameters():
    """224², 1,000 classes, fc 4,096: 3,747,200 in the conv stack and
    58,621,952 in the FC head, which has no biases."""
    params = convnet.init(0, None, None, device="cpu")
    conv = sum(v.numel() for k, v in params.items() if k.startswith("conv"))
    fc = sum(v.numel() for k, v in params.items() if k.startswith("fc"))
    assert (conv, fc) == (3_747_200, 58_621_952)
    assert tuple(params["fc1_w"].shape) == (9216, 4096)
    assert tuple(params["conv0_w"].shape) == (11, 11, 3, 96)
    assert all(v.dtype == torch.bfloat16 for v in params.values())


def test_the_model_refuses_the_conv_family_naming_the_convnet():
    with pytest.raises(NotImplementedError, match="models/convnet.py"):
        Model(get_config("alexnet"), device="cpu")


def test_mesh_init_keeps_the_one_rank_weights_blocks():
    """The FC head's blocks on a (2,2) mesh's positions are the one-rank
    weights' blocks (every leaf drawn whole from the seed)."""
    kw = dict(img_size=64, n_classes=CLASSES, scale_down=DOWN, device="cpu")
    whole = convnet.init(3, PLAN, None, **kw)
    lays = convnet.param_layouts(PLAN)
    for r in range(4):
        mesh = Mesh((2, 2), ("data", "model"))
        mesh.coords = _coords((2, 2), r).coords
        blocks = convnet.init(3, PLAN, mesh, **kw)
        assert blocks.keys() == whole.keys()
        for k, v in whole.items():
            assert torch.equal(blocks[k], lays[k].block(v, mesh)), k
        assert tuple(blocks["fc1_w"].shape) == (32, 256)
        assert tuple(blocks["fc2_w"].shape) == (256, 512)
        assert torch.equal(blocks["fc3_w"], whole["fc3_w"])


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", SIZES)
def test_one_rank_matches_reference(both, size):
    _, ref = both
    logits, loss, grads = _one_rank(size)
    key = f"1x1/{size}"
    np.testing.assert_allclose(float(loss), float(ref[key + "/loss"]),
                               rtol=1e-5)
    _logits_close(logits.float().numpy(), ref[key + "/logits"])
    assert logits.dtype == torch.float32 and loss.dtype == torch.float32
    for k, g in grads.items():
        assert g.dtype == torch.bfloat16, k
        _grad_close(g.float().numpy(), ref[f"{key}/grad/{k}"], k)


@pytest.mark.parametrize("size", SIZES)
def test_two_by_two_mesh_matches_reference_block_by_block(both, size):
    """Every rank's logits rows, loss and gradient blocks at (2,2)
    against the reference's global arrays on its own (2,2) mesh."""
    port, ref = both
    key = f"2x2/{size}"
    lays = convnet.param_layouts(PLAN)
    for r in range(RANKS):
        at = _coords((2, 2), r)
        mesh = Mesh((2, 2), ("data", "model"))
        mesh.coords = at.coords
        rows = BATCH // 2
        want = ref[key + "/logits"][at.coords["data"] * rows:
                                    (at.coords["data"] + 1) * rows]
        _logits_close(port[f"{size}/logits|{r}"], want)
        np.testing.assert_allclose(float(port[f"{size}/loss|{r}"]),
                                   float(ref[key + "/loss"]), rtol=1e-5)
        for k, lay in lays.items():
            want = lay.block(torch.from_numpy(ref[f"{key}/grad/{k}"]),
                             mesh).numpy()
            _grad_close(port[f"{size}/grad/{k}|{r}"], want, (r, k))
            assert str(port[f"{size}/dtype/{k}|{r}"]) == "torch.bfloat16"
    # every rank holds the same loss, bit for bit
    assert len({port[f"{size}/loss|{r}"].tobytes()
                for r in range(RANKS)}) == 1


@pytest.mark.parametrize("size", SIZES)
def test_two_by_two_wire_bytes_match_the_layouts_estimate(both, size):
    """The collectives each rank received, by kind, equal
    ``convnet.wire_bytes``: fc2's fp32 partial sums and fc1's bf16 input
    gradient over ``model``, the loss and every leaf's gradient over
    ``data``."""
    port, _ = both
    for r in range(RANKS):
        w = json.loads(str(port[f"{size}/wire|{r}"]))
        assert w["got"] == w["want"], (r, w)
