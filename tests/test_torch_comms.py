"""The port's gradient wire against the JAX reference's.

- the int8 quantize: the plain version, ``repro.kernels.ref`` and the
  Pallas kernel in interpret mode, bitwise, on ties and ragged lengths;
- the bucket plan and the fused pack's absmaxes, equal to the reference's
  for the same tree (and qwen2-0.5b's nine buckets at full width);
- ``sync_tree`` on 2 gloo ranks (two CPU processes) against the
  reference's ``sync_tree`` under ``jax.shard_map`` on 2 fake CPU devices
  (a subprocess started with ``XLA_FLAGS``), bitwise, for the fp32, bf16
  and int8 wires.

JAX is imported only inside fixtures and the subprocess; inputs come from
seeded numpy.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.comms import bucketer  # noqa: E402
from repro_torch.comms.plan import CommsPlan  # noqa: E402
from repro_torch.configs import get_config, scale_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import Model  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")


@pytest.fixture(scope="module")
def J():
    pytest.importorskip("jax")
    import repro  # noqa: F401  (installs the JAX compat shims)
    import jax
    import jax.numpy as jnp
    from repro.comms import bucketer as jbucketer
    from repro.kernels import fused
    from repro.kernels import ref as jref
    return SimpleNamespace(jax=jax, jnp=jnp, bucketer=jbucketer,
                           fused=fused, ref=jref)


def _bits(x):
    return np.asarray(x).view(np.uint8)


# ---------------------------------------------------------------------------
# quantize_int8
# ---------------------------------------------------------------------------

def _quantize_case(seed, n, kind):
    """An fp32 bucket and its scale.  ``normal``: the wire's scale,
    absmax / 127 + 1e-12; ``ties``: every other element an exact .5
    multiple of a power-of-two scale, so round-half-to-even decides;
    ``clip``: a scale small enough that the largest values clip at 127."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * 3e-3).astype(np.float32)
    scale = np.float32(np.abs(x).max() / np.float32(127.0) + np.float32(1e-12))
    if kind == "ties":
        scale = np.float32(2.0 ** -10)
        k = rng.integers(-127, 127, n).astype(np.float32) + 0.5
        x[::2] = (k * scale)[::2]
    if kind == "clip":
        scale = np.float32(scale / 2)
    return x, scale


@pytest.mark.parametrize("n,kind", [
    (4096, "normal"), (4096 * 3 + 77, "normal"), (5, "ties"),
    (12_345, "ties"), (1000, "clip"), (1, "normal")])
def test_quantize_int8_plain_is_bitwise_the_reference(J, n, kind):
    x, scale = _quantize_case(n, n, kind)
    got = ops.quantize_int8(torch.from_numpy(x), torch.tensor(scale))
    assert got.dtype == torch.int8 and got.shape == (n,)
    want_ref = J.ref.quantize_int8(J.jnp.asarray(x), J.jnp.asarray(scale))
    want_pallas = J.fused.quantize_int8(J.jnp.asarray(x),
                                        J.jnp.asarray(scale), interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_ref))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_pallas))
    q = got.numpy().astype(np.int32)
    if kind == "ties":          # half to even, never half away from zero
        assert (np.abs(q[::2]) % 2 == 0).all()
    if kind == "clip":
        assert np.abs(q).max() == 127


def test_quantize_int8_of_a_zero_bucket(J):
    x = np.zeros(4096 + 3, np.float32)
    scale = np.float32(np.float32(0.0) / np.float32(127.0) + np.float32(1e-12))
    got = ops.quantize_int8(torch.from_numpy(x), torch.tensor(scale))
    assert (got == 0).all()
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(J.ref.quantize_int8(J.jnp.asarray(x),
                                                    J.jnp.asarray(scale))))


# ---------------------------------------------------------------------------
# the bucket plan
# ---------------------------------------------------------------------------

def _reference_plan(J, tree, bucket_bytes):
    return J.bucketer.plan_buckets(tree, bucket_bytes)


def _same_plan(plan, jplan):
    assert plan.shapes == jplan.shapes
    assert [(s.bucket, s.offset, s.size) for s in plan.slots] == \
        [(s.bucket, s.offset, s.size) for s in jplan.slots]
    assert plan.bucket_sizes == jplan.bucket_sizes


def _nested(flat):
    out = {}
    for name, val in flat.items():
        *path, leaf = name.split(".")
        d = out
        for key in path:
            d = d.setdefault(key, {})
        d[leaf] = val
    return out


def test_qwen2_bucket_plan_at_full_width_is_the_reference_plan(J):
    """The nine buckets of qwen2-0.5b at the default 32 MiB, from the
    reference's parameter shapes and from the port's, leaf order
    included (the port's dict is in spec insertion order)."""
    from repro.launch.mesh import make_mesh
    from repro.models import Model as JModel
    from repro.configs.base import get_config as jget_config
    mesh = make_mesh((1, 1), ("data", "model"))
    with J.jax.set_mesh(mesh):
        sds = JModel(jget_config("qwen2-0.5b"), mesh).param_sds()
    jplan = _reference_plan(J, sds, bucketer.DEFAULT_BUCKET_BYTES)
    specs = Model(get_config("qwen2-0.5b"), device="cpu").param_specs()
    meta = {n: torch.empty(s.shape, dtype=s.dtype, device="meta")
            for n, s in specs.items()}
    assert list(meta)[:2] == ["embed", "unembed"]       # not the tree order
    plan = bucketer.plan_buckets(meta)
    _same_plan(plan, jplan)
    assert plan.bucket_sizes == (136_134_656, 2_781_056, 19_267_584,
                                 19_267_584, 2_795_520, 104_595_456,
                                 104_595_456, 104_595_456, 136_134_656)
    assert sum(plan.bucket_sizes) == 630_167_424


def _grad_tree(seed, scale_down=16, dtype=torch.bfloat16):
    """A gradient-shaped flat dict of the scaled qwen2 (bf16 leaves)."""
    cfg = scale_config(get_config("qwen2-0.5b"), scale_down)
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in Model(cfg, device="cpu").param_specs().items():
        x = rng.standard_normal(spec.shape).astype(np.float32)
        x *= 10.0 ** rng.uniform(-4, -1)          # leaves of unlike sizes
        out[name] = torch.from_numpy(x).to(dtype)
    return out


def _to_jax(J, flat):
    return _nested({k: J.jnp.asarray(v.float().numpy()).astype(
        J.jnp.bfloat16 if v.dtype == torch.bfloat16 else J.jnp.float32)
        for k, v in flat.items()})


@pytest.mark.parametrize("bucket_bytes", [64 * 1024, 1 << 20])
def test_bucket_plan_and_fused_absmaxes_match_the_reference(J, bucket_bytes):
    tree = _grad_tree(0)
    jtree = _to_jax(J, tree)
    plan = bucketer.plan_buckets(tree, bucket_bytes)
    jplan = _reference_plan(J, jtree, bucket_bytes)
    _same_plan(plan, jplan)
    assert plan.num_buckets > 2
    buckets, absmaxes = bucketer.flatten_buckets_fused(plan, tree, "int8")
    jb, jabs = J.bucketer.flatten_buckets_fused(jplan, jtree, "int8")
    for b, am, jbk, jam in zip(buckets, absmaxes, jb, jabs):
        np.testing.assert_array_equal(_bits(b.numpy()), _bits(jbk))
        assert am.dtype == torch.float32 and float(am) == float(jam)
        assert float(am) == float(b.abs().max())
    back = bucketer.unflatten_buckets(plan, bucketer.flatten_buckets(
        plan, tree))
    assert all(torch.equal(back[k], tree[k]) for k in tree)


# ---------------------------------------------------------------------------
# sync_tree on two ranks
# ---------------------------------------------------------------------------

# (schedule, wire, bucket_bytes, fused): ``fused`` is the reference's pack
# path; the port always packs a narrowing wire fused, and its result equals
# the reference's unfused one too.
WIRES = [("psum", None, 64 * 1024, "auto"), ("psum", "bf16", 64 * 1024, "on"),
         ("psum", "int8", 64 * 1024, "on"), ("psum", "int8", 1 << 20, "off")]

_JAX_SIDE = textwrap.dedent("""
    import sys
    import numpy as np
    import repro  # noqa: F401
    import jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.comms.plan import CommsPlan, sync_tree
    src, dst = sys.argv[1], sys.argv[2]
    wires = eval(sys.argv[3])
    data = np.load(src)
    names = sorted({k.split("/", 1)[1] for k in data.files})
    def nested(flat):
        out = {}
        for name, val in flat.items():
            *path, leaf = name.split(".")
            d = out
            for key in path:
                d = d.setdefault(key, {})
            d[leaf] = val
        return out
    stacked = nested({n: jnp.stack([
        jnp.asarray(data[f"{r}/{n}"].view(jnp.bfloat16)) for r in (0, 1)])
        for n in names})
    mesh = jax.make_mesh((2,), ("data",))
    out = {}
    for i, (sched, wire, bb, fused) in enumerate(wires):
        plan = CommsPlan(schedule=sched, wire_dtype=wire, bucket_bytes=bb,
                         fused=fused)
        body = lambda t: sync_tree(
            jax.tree.map(lambda a: a.reshape(a.shape[1:]), t), plan, mesh,
            ("data",))
        body2 = lambda t: jax.tree.map(lambda a: a.reshape((1,) + a.shape),
                                       body(t))
        res = jax.jit(jax.shard_map(body2, mesh=mesh, in_specs=P("data"),
                                    out_specs=P("data")))(stacked)
        flat = jax.tree_util.tree_flatten_with_path(res)[0]
        for path, leaf in flat:
            name = ".".join(k.key for k in path)
            for r in (0, 1):
                out[f"{i}/{r}/{name}"] = np.asarray(leaf)[r].view(np.uint16)
    np.savez(dst, **out)
""")

_TORCH_RANK = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    from repro_torch.comms.plan import CommsPlan, sync_tree
    from repro_torch.core.distributed import close_group, init_group
    rank, init, src, dst = int(sys.argv[1]), sys.argv[2], sys.argv[3], \\
        sys.argv[4]
    wires = eval(sys.argv[5])
    init_group(init, rank=rank, world_size=2, device="cpu")
    data = np.load(src)
    grads = {k.split("/", 1)[1]: torch.from_numpy(data[k].copy()).view(
        torch.bfloat16) for k in data.files if k.startswith(f"{rank}/")}
    out = {}
    for i, (sched, wire, bb, _) in enumerate(wires):
        plan = CommsPlan(schedule=sched, wire_dtype=wire, bucket_bytes=bb)
        res = sync_tree(grads, plan)
        for name, leaf in res.items():
            out[f"{i}/{rank}/{name}"] = leaf.view(torch.int16).numpy() \\
                .view(np.uint16)
    np.savez(dst, **out)
    close_group()
""")


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), **extra)
    env.setdefault("JAX_PLATFORMS", "cpu")
    return env


def run_ranks(script, tmp_path, args, n=2, timeout=240):
    """Run ``script`` as ``n`` CPU ranks of one gloo group (a ``file://``
    rendezvous in ``tmp_path``), each with ``rank init *args``; raise with
    their output if one fails."""
    init = f"file://{tmp_path / 'rendezvous'}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(r), init, *args(r)],
        env=_env(OMP_NUM_THREADS="2"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(n)]
    outs = [p.communicate(timeout=timeout)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    return outs


def test_sync_tree_on_two_gloo_ranks_is_bitwise_the_reference(tmp_path):
    trees = [_grad_tree(10 + r) for r in (0, 1)]
    src = tmp_path / "grads.npz"
    np.savez(src, **{f"{r}/{k}": v.view(torch.int16).numpy().view(np.uint16)
                     for r in (0, 1) for k, v in trees[r].items()})
    wires = repr(WIRES)
    jax_out = tmp_path / "jax.npz"
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_SIDE, str(src), str(jax_out), wires],
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=2"),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    run_ranks(_TORCH_RANK, tmp_path,
              lambda r: [str(src), str(tmp_path / f"t{r}.npz"), wires])
    want = np.load(jax_out)
    got = {}
    for r in (0, 1):
        got.update(np.load(tmp_path / f"t{r}.npz"))
    assert set(got) == set(want.files)
    for i, wire in enumerate(WIRES):
        for name in trees[0]:
            g0, g1 = got[f"{i}/0/{name}"], got[f"{i}/1/{name}"]
            np.testing.assert_array_equal(g0, g1)         # replicas agree
            np.testing.assert_array_equal(g0, want[f"{i}/0/{name}"],
                                          err_msg=f"{wire} {name}")
    # the wire moved something: the int8 result is not the fp32 one
    assert any((got[f"2/0/{n}"] != got[f"0/0/{n}"]).any() for n in trees[0])


def test_comms_plan_resolution():
    assert CommsPlan().resolve(1) == "psum"
    with pytest.raises(NotImplementedError, match="queue 1, item 8"):
        CommsPlan().resolve(2)
    assert CommsPlan(schedule="psum").resolve(8) == "psum"
    from repro_torch.comms import schedules
    x = torch.zeros(3)
    with pytest.raises(NotImplementedError, match="queue 1, item 8"):
        schedules.all_reduce(x, None, "ring")
