"""The port's int8 kernels' plain versions and its compressed
data-parallel SGD step against the JAX reference.

- ``quantize_compress``, ``quantize_int8_per_channel`` and
  ``matmul_dequant`` (the plain versions the wrappers run on the CPU)
  against ``jax.jit`` of the reference's oracles and the Pallas kernels in
  interpret mode, at the reference test's sizes
  (``tests/test_fused_kernels.py``);
- ``train.compression``'s quantizers against the jitted reference's on the
  same ``(g, err)``, and the error-feedback identity;
- ``compressed_psum`` and ``build_dp_sgd_step`` on 2 gloo CPU ranks (two
  processes) against the reference's inside ``shard_map`` on 2 fake CPU
  devices (a subprocess started with ``XLA_FLAGS``): the reference
  example's regression (``examples/compressed_dp.py``) for 20 steps per
  scheme;
- one step of the 2-layer ``scale_config(qwen2, 16)`` model on 2 ranks
  against the reference's own functions composed in the step's order on
  one device.  The reference's ``build_dp_sgd_step`` cannot take the
  qwen2 loss on JAX 0.9: the model's ``embed_shard_map``
  (``models/layers.py:319``) nests a ``shard_map`` in the step's.

Tolerances, derived:

- int8: bitwise, since the port rounds as the jitted reference does (the
  scale as one fma, the new error ``fma(-q, scale, v)``); eager JAX rounds
  both otherwise, so the comparisons are with ``jax.jit``.
- onebit: the scale is a mean of |v| summed in another order: rtol 1e-6
  on the outputs.
- matmul_dequant: the reference test's, fp32 2e-5 and bf16 2e-2.
- The regression's 20 steps: the same fp32 expressions, but XLA contracts
  ``momentum * v - lr * g`` and the residuals into fmas and sums the
  products and the loss in another order, and under onebit and int8 a
  value that sits on a sign or rounding boundary moves by one scale step.
  Final weights within 1e-4 of the largest, losses rtol 1e-4 (measured:
  weights 1.9e-7, 2.5e-7 and 2.8e-5 of the largest for none, onebit and
  int8, losses within 7e-7).
- The qwen2 step: the gradients' tolerance of ``tests/test_torch_train.py``
  (2e-2 of each value plus 2e-2 of the leaf's largest: the port's GEMM
  backward rounds its cotangent to bf16 where JAX does not); the error
  state within 2e-2 of the rank's largest local gradient (an int8 value
  that rounds the other way moves the residual by one scale, 1/127 of
  it); under onebit, elements whose gradient is within the tolerance of
  zero may take the other sign (held to that step instead); the bf16 params within one bf16 ulp plus lr times the
  gradients' absolute tolerance (a zero-initialized bias moves by lr * g
  alone).

JAX is imported only inside fixtures and the subprocess; inputs come from
seeded numpy.
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

from repro_torch.configs import get_config, scale_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models.params import from_jax  # noqa: E402
from repro_torch.train import compression  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
SCALED = scale_config(get_config("qwen2-0.5b"), 16)
SCHEMES = ["none", "onebit", "int8"]
LR, STEPS = 0.05, 20
QWEN_LR, SEQ = 1e-2, 64
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture(scope="module")
def J():
    pytest.importorskip("jax")
    import repro  # noqa: F401  (installs the JAX compat shims)
    import jax
    import jax.numpy as jnp
    from repro.kernels import fused, gemm
    from repro.kernels import ref as jref
    from repro.train import compression as jcomp
    return SimpleNamespace(jax=jax, jnp=jnp, fused=fused, gemm=gemm,
                           ref=jref, comp=jcomp,
                           dt={"float32": jnp.float32,
                               "bfloat16": jnp.bfloat16})


def _pair(J, x, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``
    (bf16 rounded once, on the JAX side, and carried bit for bit)."""
    j = J.jnp.asarray(x).astype(J.dt[dtype])
    if dtype == "bfloat16":
        bits = np.asarray(j).view(np.uint16).copy()
        return j, torch.from_numpy(bits).view(torch.bfloat16)
    return j, torch.from_numpy(np.asarray(j).copy())


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _same(got: torch.Tensor, want) -> None:
    """Bitwise equality of a tensor and an array (fp32 compared as bits)."""
    want = np.asarray(want)
    g = got.numpy()
    assert g.dtype == want.dtype and g.shape == want.shape
    if g.dtype == np.float32:
        g, want = g.view(np.uint32), want.view(np.uint32)
    np.testing.assert_array_equal(g, want)


# ---------------------------------------------------------------------------
# quantize_compress, per-channel int8, matmul_dequant
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [4096, 5000, 123, 1])
def test_quantize_compress_plain_is_bitwise_the_reference(J, n, dtype):
    xj, xt = _pair(J, _normal(n, (n,)), dtype)
    q, s = ops.quantize_compress(xt)
    assert q.dtype == torch.int8 and q.shape == (n,)
    assert s.dtype == torch.float32 and s.shape == ()
    for qw, sw in (J.jax.jit(J.ref.quantize_compress)(xj),
                   J.fused.quantize_compress(xj, interpret=True)):
        _same(q, qw)
        _same(s, sw)


def test_quantize_compress_multidim_and_zero_inputs(J):
    xj, xt = _pair(J, _normal(3, (7, 33, 5)), "float32")
    q, s = ops.quantize_compress(xt)
    qw, sw = J.jax.jit(J.ref.quantize_compress)(xj)
    assert q.shape == (7, 33, 5)
    _same(q, qw)
    _same(s, sw)
    # an all-zero input: the scale is fl32(1e-12) and every q is 0
    q, s = ops.quantize_compress(torch.zeros(4097))
    qw, sw = J.jax.jit(J.ref.quantize_compress)(J.jnp.zeros(4097))
    assert not q.any() and float(s) == float(np.float32(1e-12))
    _same(q, qw)
    _same(s, sw)


def test_quantize_int8_per_channel_is_bitwise_the_reference(J):
    """The jitted reference computes the vector of scales with the same
    fused multiply-add as the scalar one, and divides each column by its
    scale with a true division."""
    w = _normal(8, (96, 300))
    w *= np.exp(np.random.default_rng(9).uniform(-12, 4, 300)).astype(
        np.float32)
    q, s = ops.quantize_int8_per_channel(torch.from_numpy(w))
    qw, sw = J.jax.jit(J.ref.quantize_int8_per_channel)(J.jnp.asarray(w))
    assert s.shape == (300,)
    _same(q, qw)
    _same(s, sw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mkn", [(8, 256, 128), (32, 128, 256),
                                 (5, 300, 77), (130, 257, 129)])
def test_matmul_dequant_plain_matches_the_reference(J, mkn, dtype):
    """At the reference test's shapes and tolerances; the Pallas kernel in
    interpret mode too where its tiles divide the shape (the reference's
    ops layer pads the ragged ones; the port's kernel masks them)."""
    m, k, n = mkn
    aj, at = _pair(J, _normal(1, (m, k)), dtype)
    bq, bs = ops.quantize_int8_per_channel(torch.from_numpy(_normal(2, (k,
                                                                        n))))
    bqj, bsj = J.jnp.asarray(bq.numpy()), J.jnp.asarray(bs.numpy())
    got = ops.matmul_dequant(at, bq, bs, torch.float32)
    assert got.shape == (m, n) and got.dtype == torch.float32
    wants = [J.ref.matmul_dequant(aj, bqj, bsj, J.jnp.float32)]
    if k % 128 == 0 and n % 128 == 0:
        wants.append(J.gemm.matmul_dequant(
            aj, bqj, bsj, bm=min(8, m), bn=128, bk=128,
            out_dtype=J.jnp.float32, interpret=True))
    for want in wants:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **TOL[dtype])
    # the default output type is the activations'
    assert ops.matmul_dequant(at, bq, bs).dtype == at.dtype


# ---------------------------------------------------------------------------
# the quantizers with error feedback
# ---------------------------------------------------------------------------

def _g_err(seed, n=5000):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal(n) * 1e-2).astype(np.float32),
            (rng.standard_normal(n) * 1e-4).astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1])
def test_quantizers_match_the_jitted_reference(J, seed):
    g, e = _g_err(seed, 1 << 16)
    dq, ne = compression.quantize_int8(torch.from_numpy(g),
                                       torch.from_numpy(e))
    dqw, new = J.jax.jit(J.comp.quantize_int8)(J.jnp.asarray(g),
                                               J.jnp.asarray(e))
    _same(dq, dqw)
    _same(ne, new)
    # the unfused v - deq rounds differently on some elements: the check
    # can tell the two apart
    v = torch.from_numpy(g) + torch.from_numpy(e)
    assert ((v - dq).numpy() != np.asarray(new)).any()
    q, ne = compression.quantize_onebit(torch.from_numpy(g),
                                        torch.from_numpy(e))
    qw, new = J.jax.jit(J.comp.quantize_onebit)(J.jnp.asarray(g),
                                                J.jnp.asarray(e))
    np.testing.assert_allclose(q.numpy(), np.asarray(qw), rtol=1e-6)
    np.testing.assert_allclose(ne.numpy(), np.asarray(new), rtol=1e-6,
                               atol=1e-6 * float(np.abs(qw).max()))


def _ef_case(J, n, dtype, kind="normal"):
    """(g, err) as JAX arrays and torch tensors: g of ``dtype`` (bf16
    carried bit for bit), err fp32 at 1e-2 of g's scale.  ``zero``: both
    all zeros.  ``ties``: v = g + err is 127 * 2^-10 at one element (the
    scale is exactly 2^-10) and an exact .5 multiple of 2^-10 at every
    even one, split between g and an err of whole multiples of 2^-10, so
    round-half-to-even decides after the add."""
    rng = np.random.default_rng(n)
    g = (rng.standard_normal(n) * 1e-3).astype(np.float32)
    e = (rng.standard_normal(n) * 1e-5).astype(np.float32)
    if kind == "zero":
        g[:], e[:] = 0, 0
    if kind == "ties":
        # |k - j| <= 126.5: 8 significant bits, exact in bf16 too
        k = rng.integers(-124, 124, n) + 0.5
        j = rng.integers(-3, 4, n)
        even = np.arange(n) % 2 == 0
        g = np.where(even, (k - j) * 2.0 ** -10, g * 0.1).astype(np.float32)
        e = np.where(even, j * 2.0 ** -10, e).astype(np.float32)
        g[n // 2], e[n // 2] = 127 * 2.0 ** -10, 0.0
    gj, gt = _pair(J, g, dtype)
    ej, et = _pair(J, e, "float32")
    return gj, gt, ej, et


def _check_ef(J, gj, gt, ej, et):
    """``ref.quantize_compress_ef`` and ``compression.quantize_int8``
    bitwise against the jitted reference quantizer, the scale against the
    jitted reference's ``quantize_compress`` of v; returns the scale."""
    g0, e0 = gt.clone(), et.clone()
    deq, ne, s = ref.quantize_compress_ef(gt, et)
    dqw, new = J.jax.jit(J.comp.quantize_int8)(gj, ej)
    _, sw = J.jax.jit(J.ref.quantize_compress)(gj.astype(J.jnp.float32) + ej)
    assert deq.shape == ne.shape == gt.shape and s.shape == ()
    _same(deq, dqw)
    _same(s, sw)
    if gt.numel() == 1:
        # XLA's CPU compiler leaves a one-element subtract unfused, so
        # there the jitted reference rounds v - deq twice; the port keeps
        # the fma it forms at every other length, held here to an fma
        # computed independently (exact in float64, rounded once)
        v = np.asarray(gj.astype(J.jnp.float32) + ej)
        sv = np.float32(sw)
        q = np.round(v / sv).astype(np.float64)
        np.testing.assert_array_equal(np.asarray(new), v - np.asarray(dqw))
        new = (v.astype(np.float64) - q * np.float64(sv)).astype(np.float32)
    _same(ne, new)
    dq2, ne2 = compression.quantize_int8(gt, et)
    _same(dq2, dqw)
    _same(ne2, new)
    assert torch.equal(gt, g0) and torch.equal(et, e0)   # inputs untouched
    return float(s)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 123, 5000, 65536])
def test_quantize_compress_ef_is_bitwise_the_jitted_reference(J, n, dtype):
    """The error-feedback form's plain version and the rewired int8
    quantizer give the jitted reference quantizer's deq and new error
    bitwise (its residual is the fma ``fma(-q, scale, v)``; at n = 1 see
    ``_check_ef``), for bf16 and fp32 gradients."""
    _check_ef(J, *_ef_case(J, n, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["zero", "ties"])
def test_quantize_compress_ef_zero_and_ties(J, kind, dtype):
    gj, gt, ej, et = _ef_case(J, 4097, dtype, kind)
    s = _check_ef(J, gj, gt, ej, et)
    if kind == "zero":
        assert s == float(np.float32(1e-12))
        assert not compression.quantize_int8(gt, et)[0].any()
    else:
        assert s == 2.0 ** -10


@pytest.mark.parametrize("scheme", ["onebit", "int8"])
@pytest.mark.parametrize("seed", [3, 4, 5])
def test_error_feedback_identity(scheme, seed):
    """q + err_new == g + err_old (``tests/test_properties.py``'s property
    and tolerance, on numpy draws for three seeds)."""
    g, e = _g_err(seed, 64)
    g, e = g * 100, e * 1000              # N(0, 1) and N(0, 0.1)
    quant = getattr(compression, f"quantize_{scheme}")
    q, err_new = quant(torch.from_numpy(g), torch.from_numpy(e))
    np.testing.assert_allclose((q + err_new).numpy(), g + e, rtol=1e-5,
                               atol=1e-6)


def test_wire_bytes_and_unknown_schemes():
    params = {"a": torch.zeros(10, 4, dtype=torch.bfloat16),
              "b": torch.zeros(24)}
    assert compression.wire_bytes(params, "none") == {"physical": 176.0,
                                                      "modeled": 256.0}
    assert compression.wire_bytes(params, "int8") == {"physical": 256.0,
                                                      "modeled": 64.0}
    assert compression.wire_bytes(params, "onebit")["modeled"] == 8.0
    with pytest.raises(ValueError, match="unknown scheme"):
        compression.build_dp_sgd_step(lambda p, b: 0.0, scheme="fp8")


# ---------------------------------------------------------------------------
# two ranks against two fake devices
# ---------------------------------------------------------------------------

_JAX_SIDE = textwrap.dedent("""
    import sys
    import numpy as np
    import repro  # noqa: F401
    import jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.train import compression as C
    src, dst, lr, steps = sys.argv[1], sys.argv[2], float(sys.argv[3]), \\
        int(sys.argv[4])
    d = np.load(src)
    mesh = jax.make_mesh((2,), ("data",))
    out = {}
    g = {"w": jnp.asarray(d["g/w"].view(jnp.bfloat16)),
         "b": jnp.asarray(d["g/b"])}
    e = {"w": jnp.asarray(d["e/w"]), "b": jnp.asarray(d["e/b"])}
    for scheme in ("none", "onebit", "int8"):
        def body(g, e):
            g, e = jax.tree.map(lambda a: a[0], (g, e))
            r, ne = C.compressed_psum(g, e, "data", scheme)
            return jax.tree.map(lambda a: a[None], (r, ne))
        r, ne = jax.jit(jax.shard_map(
            body, mesh=mesh, in_specs=(P("data"), P("data")),
            out_specs=P("data"), check_vma=False))(g, e)
        for rank in (0, 1):
            for k in ("w", "b"):
                out[f"psum/{scheme}/{rank}/r/{k}"] = \\
                    np.asarray(r[k].astype(jnp.float32))[rank]
                out[f"psum/{scheme}/{rank}/e/{k}"] = np.asarray(ne[k])[rank]
    X, Y = jnp.asarray(d["X"]), jnp.asarray(d["Y"])

    def loss_fn(params, batch):
        x, y = batch
        return jnp.mean((x @ params["w"] - y) ** 2)

    for scheme in ("none", "onebit", "int8"):
        params = {"w": jnp.zeros(d["W_true"].shape)}
        vel = jax.tree.map(jnp.zeros_like, params)
        err = C.init_error_state(params)
        step = C.build_dp_sgd_step(loss_fn, mesh, scheme=scheme, lr=lr)
        losses = []
        with jax.set_mesh(mesh):
            for i in range(steps):
                params, vel, err = step(params, vel, err, (X, Y))
                losses.append(float(loss_fn(params, (X, Y))))
        out[f"reg/{scheme}/w"] = np.asarray(params["w"])
        out[f"reg/{scheme}/losses"] = np.asarray(losses)
    np.savez(dst, **out)
""")

_TORCH_RANK = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    from repro_torch.configs import get_config, scale_config
    from repro_torch.core.distributed import close_group, init_group
    from repro_torch.models import Model
    from repro_torch.train import compression as C
    rank, init, src, dst = int(sys.argv[1]), sys.argv[2], sys.argv[3], \\
        sys.argv[4]
    lr, steps, qlr = float(sys.argv[5]), int(sys.argv[6]), float(sys.argv[7])
    init_group(init, rank=rank, world_size=2, device="cpu")
    d = np.load(src)
    out = {}
    for scheme in ("none", "onebit", "int8"):
        g = {"w": torch.from_numpy(d["g/w"][rank].copy()).view(
                 torch.bfloat16),
             "b": torch.from_numpy(d["g/b"][rank].copy())}
        e = {k: torch.from_numpy(d[f"e/{k}"][rank].copy()) for k in g}
        r, ne = C.compressed_psum(g, e, None, scheme)
        for k in ("w", "b"):
            out[f"psum/{scheme}/{rank}/r/{k}"] = r[k].float().numpy()
            out[f"psum/{scheme}/{rank}/e/{k}"] = ne[k].numpy()
    X, Y = torch.from_numpy(d["X"]), torch.from_numpy(d["Y"])

    def loss_fn(params, batch):
        x, y = batch
        return torch.mean((x @ params["w"] - y) ** 2)

    for scheme in ("none", "onebit", "int8"):
        params = {"w": torch.zeros(d["W_true"].shape, requires_grad=True)}
        vel = {k: torch.zeros_like(p) for k, p in params.items()}
        err = C.init_error_state(params)
        step = C.build_dp_sgd_step(loss_fn, scheme=scheme, lr=lr)
        losses = []
        for i in range(steps):
            step(params, vel, err, (X, Y))
            with torch.no_grad():
                losses.append(float(loss_fn(params, (X, Y))))
        out[f"reg/{scheme}/w"] = params["w"].detach().numpy()
        out[f"reg/{scheme}/losses"] = np.asarray(losses)
    model = Model(scale_config(get_config("qwen2-0.5b"), 16), device="cpu")
    batch = {k[2:]: torch.from_numpy(d[k]).long() for k in d.files
             if k.startswith("b/")}
    for scheme in ("none", "onebit", "int8"):
        params = {k[2:]: torch.from_numpy(d[k].copy()).view(torch.bfloat16)
                  .requires_grad_(True) for k in d.files
                  if k.startswith("p/")}
        vel = {k: torch.zeros_like(p) for k, p in params.items()}
        err = C.init_error_state(params)
        step = C.build_dp_sgd_step(lambda p, b: model.loss_fn(p, b)[0],
                                   scheme=scheme, lr=qlr)
        res = step(params, vel, err, batch)
        for k in params:
            out[f"qwen/{scheme}/{rank}/g/{k}"] = res["grads"][k].float().numpy()
            out[f"qwen/{scheme}/{rank}/e/{k}"] = err[k].numpy()
            out[f"qwen/{scheme}/{rank}/p/{k}"] = \\
                params[k].detach().float().numpy()
            out[f"qwen/{scheme}/{rank}/v/{k}"] = vel[k].float().numpy()
            out[f"qwen/{scheme}/{rank}/vdtype/{k}"] = np.asarray(
                str(vel[k].dtype))
    np.savez(dst, **out)
    close_group()
""")


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), **extra)
    env.setdefault("JAX_PLATFORMS", "cpu")
    return env


def _qwen2_inputs(J):
    """The reference's init of the 2-layer qwen2 (numpy leaves) and a
    4-sequence batch."""
    import repro.configs.base as jbase
    from repro.core.planner import plan_for
    from repro.data import pipeline
    from repro.launch.mesh import make_mesh
    from repro.models import Model as JModel
    jcfg = dataclasses.replace(jbase.get_config(SCALED.name),
                               **dataclasses.asdict(SCALED))
    mesh = make_mesh((1, 1), ("data", "model"))
    with J.jax.set_mesh(mesh):
        jmodel = JModel(jcfg, mesh, plan_for(jcfg, mesh))
        params = J.jax.tree.map(np.asarray,
                                jmodel.init(J.jax.random.PRNGKey(0)))
    batch = next(iter(pipeline.SyntheticLM(SCALED.vocab_size, 4, SEQ, seed=2,
                                           structured=True)))
    return jmodel, mesh, params, batch


@pytest.fixture(scope="module")
def two_ranks(J, tmp_path_factory):
    """One run of both sides: the reference on 2 fake devices and the
    port's 2 gloo ranks, started together; returns their outputs and the
    inputs."""
    tmp = tmp_path_factory.mktemp("dp")
    rng = np.random.default_rng(11)
    w_true = (rng.standard_normal((128, 64)) * 0.3).astype(np.float32)
    X = rng.standard_normal((64, 128)).astype(np.float32)
    gw = (rng.standard_normal((2, 33, 70)) * 1e-2).astype(np.float32)
    jmodel, mesh, params, batch = _qwen2_inputs(J)
    inputs = {
        "W_true": w_true, "X": X, "Y": X @ w_true,
        "g/w": np.asarray(J.jnp.asarray(gw).astype(J.jnp.bfloat16)).view(
            np.uint16),
        "g/b": (rng.standard_normal((2, 257)) * 1e-2).astype(np.float32),
        "e/w": (rng.standard_normal((2, 33, 70)) * 1e-4).astype(np.float32),
        "e/b": (rng.standard_normal((2, 257)) * 1e-4).astype(np.float32),
        **{f"b/{k}": v for k, v in batch.items()},
        **{f"p/{k}": v.view(torch.int16).numpy()
           for k, v in from_jax(params).items()}}
    src = tmp / "in.npz"
    np.savez(src, **inputs)
    jax_out, init = tmp / "jax.npz", f"file://{tmp / 'rendezvous'}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _JAX_SIDE, str(src), str(jax_out), str(LR),
         str(STEPS)],
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=2"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)]
    procs += [subprocess.Popen(
        [sys.executable, "-c", _TORCH_RANK, str(r), init, str(src),
         str(tmp / f"t{r}.npz"), str(LR), str(STEPS), str(QWEN_LR)],
        env=_env(OMP_NUM_THREADS="2"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in (0, 1)]
    for p in procs:
        out = p.communicate(timeout=300)[0]
        assert p.returncode == 0, out[-4000:]
    got = [dict(np.load(tmp / f"t{r}.npz")) for r in (0, 1)]
    return SimpleNamespace(want=dict(np.load(jax_out)), got=got,
                           inputs=inputs, jmodel=jmodel, mesh=mesh,
                           params=params, batch=batch)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_compressed_psum_on_two_ranks_matches_the_reference(two_ranks,
                                                            scheme):
    """A bf16 and an fp32 leaf with a nonzero error state: int8 and none
    bitwise (none's bf16 mean included), onebit within rtol 1e-6."""
    for r in (0, 1):
        for key in (f"psum/{scheme}/{r}/r/w", f"psum/{scheme}/{r}/r/b",
                    f"psum/{scheme}/{r}/e/w", f"psum/{scheme}/{r}/e/b"):
            got, want = two_ranks.got[r][key], two_ranks.want[key]
            if scheme == "onebit":
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6
                                           * float(np.abs(want).max()))
            else:
                np.testing.assert_array_equal(got.view(np.uint32),
                                              want.view(np.uint32), key)
    for key in (f"psum/{scheme}/0/r/w", f"psum/{scheme}/0/r/b"):
        np.testing.assert_array_equal(two_ranks.got[0][key],
                                      two_ranks.got[1][key.replace("/0/",
                                                                   "/1/")])


# ---------------------------------------------------------------------------
# three ranks against three fake devices: compressed_psum alone
# ---------------------------------------------------------------------------

_JAX_PSUM = textwrap.dedent("""
    import sys
    import numpy as np
    import repro  # noqa: F401
    import jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.train import compression as C
    src, dst, n = sys.argv[1], sys.argv[2], int(sys.argv[3])
    d = np.load(src)
    mesh = jax.make_mesh((n,), ("data",))
    out = {}
    for case in ("rand", "grid"):
        g = {"w": jnp.asarray(d[f"{case}/g/w"].view(jnp.bfloat16)),
             "b": jnp.asarray(d[f"{case}/g/b"])}
        e = {k: jnp.asarray(d[f"{case}/e/{k}"]) for k in g}
        for scheme in ("none", "onebit", "int8"):
            def body(g, e):
                g, e = jax.tree.map(lambda a: a[0], (g, e))
                r, ne = C.compressed_psum(g, e, "data", scheme)
                return jax.tree.map(lambda a: a[None], (r, ne))
            r, ne = jax.jit(jax.shard_map(
                body, mesh=mesh, in_specs=(P("data"), P("data")),
                out_specs=P("data"), check_vma=False))(g, e)
            for rank in range(n):
                for k in ("w", "b"):
                    out[f"{case}/{scheme}/{rank}/r/{k}"] = \\
                        np.asarray(r[k].astype(jnp.float32))[rank]
                    out[f"{case}/{scheme}/{rank}/e/{k}"] = \\
                        np.asarray(ne[k])[rank]
    np.savez(dst, **out)
""")

_TORCH_PSUM = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    from repro_torch.core.distributed import close_group, init_group
    from repro_torch.train import compression as C
    rank, init, src, dst, n = int(sys.argv[1]), sys.argv[2], sys.argv[3], \\
        sys.argv[4], int(sys.argv[5])
    init_group(init, rank=rank, world_size=n, device="cpu")
    d = np.load(src)
    out = {}
    for case in ("rand", "grid"):
        for scheme in ("none", "onebit", "int8"):
            g = {"w": torch.from_numpy(d[f"{case}/g/w"][rank].copy()).view(
                     torch.bfloat16),
                 "b": torch.from_numpy(d[f"{case}/g/b"][rank].copy())}
            e = {k: torch.from_numpy(d[f"{case}/e/{k}"][rank].copy())
                 for k in g}
            r, ne = C.compressed_psum(g, e, None, scheme)
            for k in ("w", "b"):
                out[f"{case}/{scheme}/{rank}/r/{k}"] = r[k].float().numpy()
                out[f"{case}/{scheme}/{rank}/e/{k}"] = ne[k].numpy()
    np.savez(dst, **out)
    close_group()
""")


@pytest.fixture(scope="module")
def three_ranks(J, tmp_path_factory):
    """``compressed_psum`` of a bf16 and an fp32 leaf with a nonzero error
    state: the reference on 3 fake devices and the port on 3 gloo ranks,
    started together.  Two input sets: ``rand`` (normal values) and
    ``grid`` (multiples of 2^-8 below 1, whose sums of |v| are exact in
    any order, so onebit's mean |v| is the same number on both sides)."""
    n, tmp = 3, tmp_path_factory.mktemp("dp3")
    rng = np.random.default_rng(13)
    bf16 = lambda a: np.asarray(J.jnp.asarray(a).astype(  # noqa: E731
        J.jnp.bfloat16)).view(np.uint16)
    grid = lambda shape, top: (rng.integers(  # noqa: E731
        -top, top + 1, (n,) + shape) / 256.0).astype(np.float32)
    inputs = {
        "rand/g/w": bf16(rng.standard_normal((n, 33, 70)) * 1e-2),
        "rand/g/b": (rng.standard_normal((n, 257)) * 1e-2).astype(
            np.float32),
        "rand/e/w": (rng.standard_normal((n, 33, 70)) * 1e-4).astype(
            np.float32),
        "rand/e/b": (rng.standard_normal((n, 257)) * 1e-4).astype(
            np.float32),
        "grid/g/w": bf16(grid((33, 70), 200)), "grid/g/b": grid((257,), 200),
        "grid/e/w": grid((33, 70), 8), "grid/e/b": grid((257,), 8)}
    src = tmp / "in.npz"
    np.savez(src, **inputs)
    jax_out, init = tmp / "jax.npz", f"file://{tmp / 'rendezvous'}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _JAX_PSUM, str(src), str(jax_out), str(n)],
        env=_env(XLA_FLAGS=f"--xla_force_host_platform_device_count={n}"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)]
    procs += [subprocess.Popen(
        [sys.executable, "-c", _TORCH_PSUM, str(r), init, str(src),
         str(tmp / f"t{r}.npz"), str(n)],
        env=_env(OMP_NUM_THREADS="2"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(n)]
    for p in procs:
        out = p.communicate(timeout=300)[0]
        assert p.returncode == 0, out[-4000:]
    got = {}
    for r in range(n):
        got.update(np.load(tmp / f"t{r}.npz"))
    return SimpleNamespace(n=n, got=got, want=dict(np.load(jax_out)))


@pytest.mark.parametrize("scheme", SCHEMES)
def test_compressed_psum_on_three_ranks_is_bitwise_the_reference(
        three_ranks, scheme):
    """At 3 ranks the mean's 1/3 is inexact and the sum's order shows: the
    reduced values and new errors bitwise on every rank (onebit on the
    ``grid`` inputs, whose mean |v| has one value in any order)."""
    cases = ("grid",) if scheme == "onebit" else ("rand", "grid")
    for case in cases:
        for r in range(three_ranks.n):
            for part in ("r/w", "r/b", "e/w", "e/b"):
                key = f"{case}/{scheme}/{r}/{part}"
                np.testing.assert_array_equal(
                    three_ranks.got[key].view(np.uint32),
                    three_ranks.want[key].view(np.uint32), key)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_dp_sgd_regression_matches_the_reference(two_ranks, scheme):
    """The reference example's regression, 20 steps from zero weights on
    2 ranks against 2 fake devices; the replicas bitwise equal."""
    got0, got1, want = (two_ranks.got[0], two_ranks.got[1], two_ranks.want)
    np.testing.assert_array_equal(got0[f"reg/{scheme}/w"],
                                  got1[f"reg/{scheme}/w"])
    w = want[f"reg/{scheme}/w"]
    np.testing.assert_allclose(got0[f"reg/{scheme}/w"], w, rtol=0,
                               atol=1e-4 * float(np.abs(w).max()))
    np.testing.assert_allclose(got0[f"reg/{scheme}/losses"],
                               want[f"reg/{scheme}/losses"], rtol=1e-4)
    losses = want[f"reg/{scheme}/losses"]
    assert losses[-1] < 0.5 * losses[0]


def _reference_qwen2_step(J, two_ranks, scheme):
    """The reference's functions composed in ``build_dp_sgd_step``'s order
    on one device: each rank's gradient of its 2 sequences
    (``jax.grad`` of the model's loss), the scheme's quantizer, the mean of
    the two ranks (a sum, then a divide by 2, as ``pmean``), then
    ``vel = momentum * 0 - lr * g`` and ``p + vel``."""
    jnp, jax = J.jnp, J.jax
    params, batch = two_ranks.params, two_ranks.batch
    grad = jax.jit(jax.grad(lambda p, b: two_ranks.jmodel.loss_fn(p, b)[0]))
    gs = []
    with jax.set_mesh(two_ranks.mesh):
        for r in (0, 1):
            gs.append(grad(params, {k: jnp.asarray(v[2 * r:2 * r + 2])
                                    for k, v in batch.items()}))
    flat = [{".".join(k.key for k in path): leaf for path, leaf in
             jax.tree_util.tree_flatten_with_path(g)[0]} for g in gs]
    p0 = {".".join(k.key for k in path): leaf for path, leaf in
          jax.tree_util.tree_flatten_with_path(params)[0]}
    out = {"g": {}, "e": [{}, {}], "p": {}, "flip": {}, "near0": {},
           "vmax": [{}, {}]}
    for name in flat[0]:
        if scheme == "none":
            qs = [flat[0][name], flat[1][name]]
        else:
            quant = jax.jit(getattr(J.comp, f"quantize_{scheme}"))
            res = [quant(flat[r][name], jnp.zeros(flat[r][name].shape))
                   for r in (0, 1)]
            qs = [q for q, _ in res]
            for r in (0, 1):
                out["e"][r][name] = np.asarray(res[r][1])
                out["vmax"][r][name] = float(jnp.abs(flat[r][name]).max())
            # onebit: |q| is the rank's scale; a sign that differs moves
            # the mean by it, and can differ where a rank's gradient is
            # within the gradients' tolerance of zero
            out["flip"][name] = float(sum(jnp.abs(q).max() for q in qs))
            out["near0"][name] = np.logical_or(*[
                np.abs(np.asarray(flat[r][name], np.float32))
                <= 2e-2 * out["vmax"][r][name] for r in (0, 1)])
        g = (qs[0] + qs[1]) / 2
        vel = 0.9 * jnp.zeros_like(p0[name]) - QWEN_LR * g
        out["g"][name] = np.asarray(g.astype(jnp.float32))
        out["p"][name] = np.asarray((p0[name] + vel.astype(p0[name].dtype))
                                    .astype(jnp.float32))
        out["vdtype"] = str(vel.dtype)
    return out


def _close(got, want, rtol, atol, flip=0.0, loose=None, what=""):
    """``got`` within ``atol + rtol |want|`` of ``want``, except that on
    the elements of ``loose`` it may instead sit up to ``flip`` away."""
    d = np.abs(got - want)
    bad = d > atol + rtol * np.abs(want)
    if loose is not None:
        assert (d[bad & loose] <= atol + flip * (1 + 1e-6)).all(), what
        bad &= ~loose
    assert not bad.any(), (f"{what}: {bad.sum()} elements off, max "
                           f"{d[bad].max():.3g}")


@pytest.mark.parametrize("scheme", SCHEMES)
def test_qwen2_dp_sgd_step_on_two_ranks_matches_the_reference(J, two_ranks,
                                                              scheme):
    """Synced gradients, error state and params after one step.  Under
    onebit a gradient element within the tolerance of zero on a rank can
    take the other sign there, which moves the mean by that rank's scale
    (the error by twice it, the param by lr times it): those elements
    are held to that step instead (a leaf whose exact gradient is zero,
    as the key bias's, is all such elements)."""
    want = _reference_qwen2_step(J, two_ranks, scheme)
    got = two_ranks.got
    for name, w in want["g"].items():
        atol = 2e-2 * float(np.abs(w).max())
        flip, loose = want["flip"].get(name, 0.0), want["near0"].get(name)
        for r in (0, 1):
            _close(got[r][f"qwen/{scheme}/{r}/g/{name}"], w, 2e-2, atol,
                   flip, loose, f"grad {name}")
            # replicas: params and velocity bitwise equal
            for slot in ("p", "v"):
                np.testing.assert_array_equal(
                    got[r][f"qwen/{scheme}/{r}/{slot}/{name}"],
                    got[0][f"qwen/{scheme}/0/{slot}/{name}"])
            if scheme != "none":
                _close(got[r][f"qwen/{scheme}/{r}/e/{name}"],
                       want["e"][r][name], 0.0,
                       2e-2 * want["vmax"][r][name], 2 * flip, loose,
                       f"err {name}")
            _close(got[r][f"qwen/{scheme}/{r}/p/{name}"], want["p"][name],
                   2.0 ** -7, QWEN_LR * atol, QWEN_LR * flip, loose,
                   f"param {name}")
        # the velocity's dtype follows the reference's promotion
        assert str(got[0][f"qwen/{scheme}/0/vdtype/{name}"]) == \
            {"bfloat16": "torch.bfloat16", "float32": "torch.float32"}[
                want["vdtype"]]
