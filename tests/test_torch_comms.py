"""The port's gradient wire against the JAX reference's.

- the int8 quantize: the plain version, ``repro.kernels.ref`` and the
  Pallas kernel in interpret mode, bitwise, on ties and ragged lengths;
- the bucket plan and the fused pack's absmaxes, equal to the reference's
  for the same tree (and qwen2-0.5b's nine buckets at full width);
- ``sync_tree`` on 2 gloo ranks (two CPU processes) against the
  reference's ``sync_tree`` under ``jax.shard_map`` on 2 fake CPU devices
  (a subprocess started with ``XLA_FLAGS``), bitwise, for the fp32, bf16
  and int8 wires;
- the int8 wire's scale against the reference's jitted one (XLA fuses
  ``absmax / 127 + 1e-12`` into one fma) over a sweep of absmax values,
  and a two-rank int8 ``sync_tree`` whose bucket has a scale that IEEE
  division and a separate add would round differently.

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
# ``auto`` resolves through the topology cost model on both sides: ``tree``
# at 2 ranks and at 3 (whose tree is the psum fallback).
WIRES = [("psum", None, 64 * 1024, "auto"), ("psum", "bf16", 64 * 1024, "on"),
         ("psum", "int8", 64 * 1024, "on"), ("psum", "int8", 1 << 20, "off"),
         ("auto", None, 64 * 1024, "auto"), ("auto", "bf16", 64 * 1024, "on"),
         ("auto", "int8", 64 * 1024, "on")]

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
    def load(a):          # bf16 travels as uint16 bits, fp32 as it is
        return jnp.asarray(a.view(jnp.bfloat16) if a.dtype == np.uint16
                           else a)
    def bits(a):
        return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)
    ranks = range(int(sys.argv[4]))
    stacked = nested({n: jnp.stack([load(data[f"{r}/{n}"]) for r in ranks])
                      for n in names})
    mesh = jax.make_mesh((len(ranks),), ("data",))
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
            for r in ranks:
                out[f"{i}/{r}/{name}"] = bits(np.asarray(leaf)[r])
    np.savez(dst, **out)
""")

_TORCH_RANK = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    from repro_torch.comms.plan import CommsPlan, sync_tree
    from repro_torch.core.distributed import close_group, init_group
    from repro_torch.launch.mesh import make_host_mesh
    rank, init, src, dst = int(sys.argv[1]), sys.argv[2], sys.argv[3], \\
        sys.argv[4]
    wires, world = eval(sys.argv[5]), int(sys.argv[6])
    init_group(init, rank=rank, world_size=world, device="cpu")
    data = np.load(src)
    def load(a):          # bf16 travels as uint16 bits, fp32 as it is
        t = torch.from_numpy(a.copy())
        return t.view(torch.bfloat16) if a.dtype == np.uint16 else t
    def bits(t):
        if t.element_size() == 2:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.view(torch.int32).numpy().view(np.uint32)
    grads = {k.split("/", 1)[1]: load(data[k]) for k in data.files
             if k.startswith(f"{rank}/")}
    out = {}
    for i, (sched, wire, bb, _) in enumerate(wires):
        plan = CommsPlan(schedule=sched, wire_dtype=wire, bucket_bytes=bb)
        res = sync_tree(grads, plan, make_host_mesh(), ("data",))
        for name, leaf in res.items():
            out[f"{i}/{rank}/{name}"] = bits(leaf)
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


def _bits_np(t: torch.Tensor) -> np.ndarray:
    if t.element_size() == 2:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.view(torch.int32).numpy().view(np.uint32)


def _sync_both_sides(tmp_path, trees, wires):
    """``sync_tree`` of the ranks' ``trees`` (one per rank) for each of
    ``wires``: the port's on ``len(trees)`` gloo ranks and the reference's
    on as many fake devices, as ``(got, want)`` dicts of bit patterns
    keyed ``wire/rank/leaf``; the port's replicas are checked equal."""
    n = len(trees)
    src = tmp_path / "grads.npz"
    np.savez(src, **{f"{r}/{k}": _bits_np(v) if v.dtype == torch.bfloat16
                     else v.numpy() for r in range(n)
                     for k, v in trees[r].items()})
    jax_out = tmp_path / "jax.npz"
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_SIDE, str(src), str(jax_out),
         repr(wires), str(n)],
        env=_env(XLA_FLAGS=f"--xla_force_host_platform_device_count={n}"),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    run_ranks(_TORCH_RANK, tmp_path,
              lambda r: [str(src), str(tmp_path / f"t{r}.npz"), repr(wires),
                         str(n)], n=n)
    want = dict(np.load(jax_out))
    got = {}
    for r in range(n):
        got.update(np.load(tmp_path / f"t{r}.npz"))
    assert set(got) == set(want)
    for i in range(len(wires)):
        for name in trees[0]:
            for r in range(1, n):
                np.testing.assert_array_equal(got[f"{i}/0/{name}"],
                                              got[f"{i}/{r}/{name}"])
    return got, want


def test_sync_tree_on_two_gloo_ranks_is_bitwise_the_reference(tmp_path):
    trees = [_grad_tree(10 + r) for r in (0, 1)]
    got, want = _sync_both_sides(tmp_path, trees, WIRES)
    for i, wire in enumerate(WIRES):
        for name in trees[0]:
            np.testing.assert_array_equal(got[f"{i}/0/{name}"],
                                          want[f"{i}/0/{name}"],
                                          err_msg=f"{wire} {name}")
    # the wire moved something: the int8 result is not the fp32 one
    assert any((got[f"2/0/{n}"] != got[f"0/0/{n}"]).any() for n in trees[0])


def test_sync_tree_on_three_gloo_ranks_is_bitwise_the_reference(tmp_path):
    """Three ranks, where the mean's 1/3 is inexact: the reference's
    ``b / n`` compiles to a multiply by fl32(1/3), and its all-reduce adds
    the ranks in order (a bf16 bucket in fp32), so each wire's mean must
    round as those do, on every rank."""
    # bf16 leaves, and fp32 ones, which keep the mean's own rounding
    for seed, dtype in ((20, torch.bfloat16), (30, torch.float32)):
        trees = [_grad_tree(seed + r, dtype=dtype) for r in range(3)]
        work = tmp_path / str(dtype).split(".")[1]    # a fresh rendezvous
        work.mkdir()
        got, want = _sync_both_sides(work, trees, WIRES)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key],
                                          err_msg=f"{dtype} {key}")


def _ieee_scale(absmax: torch.Tensor) -> torch.Tensor:
    """absmax / 127 + 1e-12 with IEEE division and a separate add: what
    the reference computes eagerly, and not under ``jit``."""
    return absmax / torch.full_like(absmax, 127.0) + 1e-12


def test_int8_scale_is_the_references_jitted_scale(J):
    """2,048 absmax values from 1e-8 to 1e3 through the reference's
    expression inside a jitted ``shard_map`` (as ``sync_tree`` runs it),
    bitwise; the IEEE rounding differs on a share of them, so the sweep
    can tell the two apart."""
    from jax.sharding import PartitionSpec as P
    mesh = J.jax.make_mesh((1,), ("data",))
    amax = np.geomspace(1e-8, 1e3, 2048).astype(np.float32)
    jitted = J.jax.jit(J.jax.shard_map(
        lambda a: J.jax.lax.pmax(a, "data") / 127.0 + 1e-12, mesh=mesh,
        in_specs=P(), out_specs=P()))
    want = np.asarray(jitted(J.jnp.asarray(amax)))
    got = ref.int8_scale(torch.from_numpy(amax))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    assert (_ieee_scale(torch.from_numpy(amax)).numpy() != want).sum() > 100


def test_sync_tree_int8_with_a_disagreeing_scale_is_bitwise_the_reference(
        tmp_path):
    """fp32 leaves whose group absmax has a scale that IEEE division
    rounds one ulp away from the jitted fma: every dequantized value then
    depends on which, so the wire must take the reference's."""
    cand = np.geomspace(1e-3, 1.0, 512).astype(np.float32)
    fma = (cand.astype(np.float64) * float(np.float32(1 / 127))
           + float(np.float32(1e-12))).astype(np.float32)
    ieee = _ieee_scale(torch.from_numpy(cand)).numpy()
    amax = torch.tensor(cand[fma != ieee][0])
    rng = np.random.default_rng(7)
    trees = []
    for r in (0, 1):
        w = rng.uniform(-1, 1, (33, 70)).astype(np.float32) * float(amax)
        b = rng.uniform(-1, 1, 257).astype(np.float32) * float(amax) / 2
        if r == 0:
            w[5, 9] = -float(amax)       # the group absmax, negative
        trees.append({"w": torch.from_numpy(w), "b": torch.from_numpy(b)})
    wires = [("psum", "int8", 1 << 20, "on"), ("psum", "int8", 1 << 20,
                                               "off")]
    got, want = _sync_both_sides(tmp_path, trees, wires)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # with the IEEE scale the sums would come out otherwise
    scale = _ieee_scale(amax)
    q = sum(torch.clamp(torch.round(t["w"] / scale), -127, 127)
            for t in trees)
    ieee = (q * scale).numpy().view(np.uint32)
    assert (ieee != got["0/0/w"]).mean() > 0.5


_SUM_RANK = textwrap.dedent("""
    import sys
    import torch
    import torch.distributed as dist
    from repro_torch.comms import schedules
    from repro_torch.core.distributed import close_group, init_group
    rank, init = int(sys.argv[1]), sys.argv[2]
    init_group(init, rank=rank, world_size=2, device="cpu")
    g = torch.Generator().manual_seed(rank)
    for dtype in (torch.float32, torch.bfloat16):
        x = (torch.randn(4099, generator=g) * 1e3).to(dtype)
        ring = x.clone()
        dist.all_reduce(ring)
        ordered, got = schedules.ordered_sum(x), schedules.group_reduce(x)
        assert torch.equal(ordered, ring), dtype
        assert torch.equal(got, ring) and got.data_ptr() != x.data_ptr()
    close_group()
""")


def test_two_rank_backend_sum_is_bitwise_the_ordered_sum(tmp_path):
    """At two ranks ``schedules.group_reduce`` keeps the backend's sum: two
    addends commute, so it gives the rank-ordered sum's bits (a bf16 sum
    too: one fp32 add rounded once), and returns a new tensor."""
    run_ranks(_SUM_RANK, tmp_path, lambda r: [])


def test_comms_plan_resolution():
    """``auto`` resolves through the topology cost model at the bucket's
    size, to the reference's choices for a 32 MiB bucket: ``psum`` on one
    rank (every score 0), ``tree`` on a (data=2, model=1) mesh, ``psum``
    at 4 (``psum``, ``ring`` and ``rsag`` tie: the first key) and
    ``hier`` on (pod=2, data=2) with ``data`` the fast axis; a named
    schedule resolves to itself.  An unknown schedule raises."""
    from repro_torch.core.distributed import Mesh
    big = 1 << 30
    assert CommsPlan().resolve(Mesh((1, 1), ("data", "model")), big) \
        == "psum"
    assert CommsPlan().resolve(Mesh((2, 1), ("data", "model")), big) \
        == "tree"
    assert CommsPlan().resolve(Mesh((4, 1), ("data", "model")), big) \
        == "psum"
    assert CommsPlan(intra_axis="data").resolve(
        Mesh((2, 2), ("pod", "data")), big) == "hier"
    assert CommsPlan(schedule="ring").resolve(
        Mesh((4, 1), ("data", "model")), 8) == "ring"
    from repro_torch.comms import schedules
    x = torch.zeros(3)
    with pytest.raises(ValueError, match="unknown schedule"):
        schedules.all_reduce(x, Mesh((1, 2), ("data", "model")),
                             ("data",), "butterfly")
