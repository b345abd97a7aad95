"""The port's all-reduce schedules (``comms/schedules.py``) against the
reference's, on the same per-rank inputs.

The port runs as 4 CPU ranks of one gloo group (3 for the tree's psum
fallback), each as a ``python -c`` subprocess with a ``file://``
rendezvous in ``tmp_path``; the reference runs in two subprocesses with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``, every case in a
fully manual ``shard_map`` (as ``tests/test_comms.py`` runs its
schedules), all at once.  Rank r and device r sit at
``np.unravel_index(r, shape)`` on both sides.

Covered: ``psum``, ``ring``, ``rsag`` and ``tree`` over the 4-rank
``model`` line of a (1, 4) mesh and ``hier`` over (data, model) of a
(2, 2) mesh with ``intra_axis="model"``, fp32 and bf16 at an odd size
(padding) and at 64 Ki elements; the tree at 3 ranks (its psum
fallback) and over the 2-rank ``model`` lines of (2, 2) (the backend's
all-reduce; the bf16 wire's widened add an all-gather), fp32, bf16 and
both wires; the bf16 and int8 wires through every schedule; ``psum``
over both axes of (2, 2) (one sum over the whole group); ``sync_tree``
with ``schedule="auto"`` over a (pod, data) mesh, which both sides
resolve to ``hier``.  Every result is held bitwise to the reference's,
every rank's the same bits, and within ``tests/test_comms.py``'s
tolerances of the float64 sum.  The bytes each rank receives
(``distributed.WIRE``) equal ``topology.allreduce_design``'s wire bytes
for ``ring``, ``rsag`` and ``tree`` at a size the line divides, and the
two-level decomposition for ``hier``, and for the 2-rank tree on the
fp32 and bf16 wires; ``psum`` at 4 ranks gathers the line's tensors
((n - 1) of them), which the model does not describe.

JAX is imported only in the subprocesses; inputs come from seeded numpy.
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

from repro_torch.comms import topology  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")

ODD, BIG = 1001, 65536
SCHEDS = ("psum", "ring", "rsag", "tree")


def _cases():
    """key -> (mesh shape, mesh axes, reduce axes, schedule, wire, dtype,
    size, intra_axis)."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        for size in (ODD, BIG):
            for s in SCHEDS:
                out[f"{s}-{dtype}-{size}"] = (
                    (1, 4), ("data", "model"), ("model",), s, None, dtype,
                    size, "model")
            out[f"hier-{dtype}-{size}"] = (
                (2, 2), ("data", "model"), ("data", "model"), "hier", None,
                dtype, size, "model")
        out[f"psum2-{dtype}"] = ((2, 2), ("data", "model"),
                                 ("data", "model"), "psum", None, dtype,
                                 ODD, "model")
    for wire in ("bf16", "int8"):
        for s in SCHEDS:
            out[f"{s}-{wire}"] = ((1, 4), ("data", "model"), ("model",), s,
                                  wire, "float32", ODD, "model")
        out[f"hier-{wire}"] = ((2, 2), ("data", "model"), ("data", "model"),
                               "hier", wire, "float32", ODD, "model")
    for dtype in ("float32", "bfloat16"):
        out[f"tree3-{dtype}"] = ((1, 3), ("data", "model"), ("model",),
                                 "tree", None, dtype, ODD, "model")
        out[f"tree2-{dtype}"] = ((2, 2), ("data", "model"), ("model",),
                                 "tree", None, dtype, ODD, "model")
    for wire in ("bf16", "int8"):
        out[f"tree2-{wire}"] = ((2, 2), ("data", "model"), ("model",),
                                "tree", wire, "float32", ODD, "model")
    return out


CASES = _cases()
#: (wire, bucket_bytes) of the ``sync_tree`` cases over (pod, data)
SYNC = [(None, 64 * 1024), ("bf16", 64 * 1024), ("int8", 64 * 1024)]


def _inputs():
    """npz arrays ``{key}|{rank}``: fp32 values, bf16 as uint16 bits."""
    out = {}
    for i, (key, c) in enumerate(sorted(CASES.items())):
        shape, dtype, size = c[0], c[5], c[6]
        rng = np.random.default_rng(100 + i)
        for r in range(int(np.prod(shape))):
            x = rng.standard_normal(size).astype(np.float32)
            x *= 10.0 ** rng.uniform(-2, 2)          # ranks of unlike scale
            t = torch.from_numpy(x)
            out[f"{key}|{r}"] = (t.to(torch.bfloat16).view(torch.int16)
                                 .numpy().view(np.uint16)
                                 if dtype == "bfloat16" else x)
    rng = np.random.default_rng(7)
    for r in range(4):
        for leaf, n in (("a", 3001), ("b", 7000), ("c", 17)):
            x = rng.standard_normal(n).astype(np.float32)
            out[f"sync|{r}|{leaf}"] = x * 10.0 ** rng.uniform(-3, 0)
    return out


_JAX_SIDE = textwrap.dedent("""
    import json, sys
    import numpy as np
    import repro  # noqa: F401
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.comms import compressed, schedules
    from repro.comms.plan import CommsPlan, sync_tree
    src, dst, keys, sync = (sys.argv[1], sys.argv[2], json.loads(sys.argv[3]),
                            json.loads(sys.argv[4]))
    cases = json.loads(sys.argv[5])
    data = np.load(src)
    def bits(a):
        a = np.asarray(a)
        return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)
    out, resolved = {}, {}
    for key in keys:
        shape, names, axes, sched, wire, dtype, size, intra = cases[key]
        n = int(np.prod(shape))
        mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), tuple(names))
        x = np.stack([data[f"{key}|{r}"] for r in range(n)])
        x = jnp.asarray(x.view(jnp.bfloat16) if dtype == "bfloat16" else x)
        def body(lx, sched=sched, wire=wire, axes=tuple(axes), intra=intra):
            lx = lx.reshape(lx.shape[1:])
            if wire is None:
                y = schedules.all_reduce(lx, axes, sched, intra)
            else:
                y = compressed.wire_all_reduce(lx, axes, sched, wire, intra)
            return y.reshape((1,) + y.shape)
        spec = P(tuple(names))
        y = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(spec,),
                                  out_specs=spec, check_vma=False))(x)
        for r in range(n):
            out[f"{key}|{r}"] = bits(np.asarray(y)[r])
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("pod", "data"))
    spec = P(("pod", "data"))
    for i, (wire, bb) in enumerate(sync):
        plan = CommsPlan(schedule="auto", wire_dtype=wire, bucket_bytes=bb,
                         intra_axis="data", fused="on" if wire else "auto")
        tree = {k: jnp.stack([data[f"sync|{r}|{k}"] for r in range(4)])
                for k in ("a", "b", "c")}
        nbytes = sum(4 * v.shape[1] for v in tree.values())
        resolved[str(i)] = plan.resolve(mesh, nbytes)
        def body(t, plan=plan):
            t = {k: v.reshape(v.shape[1:]) for k, v in t.items()}
            s = sync_tree(t, plan, mesh, ("pod", "data"))
            return {k: v.reshape((1,) + v.shape) for k, v in s.items()}
        res = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(spec,),
                                    out_specs=spec, check_vma=False))(tree)
        for k, v in res.items():
            for r in range(4):
                out[f"sync{i}|{r}|{k}"] = bits(np.asarray(v)[r])
    np.savez(dst, **out)
    print("RESOLVED", json.dumps(resolved))
""")

_TORCH_RANK = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    from repro_torch.comms import compressed, schedules
    from repro_torch.comms.plan import CommsPlan, sync_tree
    from repro_torch.core import distributed as dist_mod
    from repro_torch.core.distributed import Mesh, close_group, init_group
    rank, init, src, dst, keys, sync, world = (
        int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4],
        json.loads(sys.argv[5]), json.loads(sys.argv[6]), int(sys.argv[7]))
    cases = json.loads(sys.argv[8])
    init_group(init, rank=rank, world_size=world, device="cpu")
    data = np.load(src)
    def bits(t):
        if t.element_size() == 2:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.view(torch.int32).numpy().view(np.uint32)
    meshes = {}
    out, wire_bytes, resolved = {}, {}, {}
    for key in keys:
        shape, names, axes, sched, wire, dtype, size, intra = cases[key]
        mk = (tuple(shape), tuple(names))
        if mk not in meshes:
            meshes[mk] = Mesh(shape, names, torch.distributed.group.WORLD)
        mesh = meshes[mk]
        a = data[f"{key}|{rank}"]
        x = torch.from_numpy(a.copy())
        if dtype == "bfloat16":
            x = x.view(torch.int16).view(torch.bfloat16)
        dist_mod.WIRE.reset()
        if wire is None:
            y = schedules.all_reduce(x, mesh, tuple(axes), sched, intra)
        else:
            y = compressed.wire_all_reduce(x, mesh, tuple(axes), sched, wire,
                                           intra)
        wire_bytes[key] = dist_mod.WIRE.total()
        assert y.dtype == x.dtype and y.shape == x.shape, key
        out[f"{key}|{rank}"] = bits(y)
    if sync:
        mesh = Mesh((2, 2), ("pod", "data"), torch.distributed.group.WORLD)
        tree = {k: torch.from_numpy(data[f"sync|{rank}|{k}"].copy())
                for k in ("a", "b", "c")}
        for i, (wire, bb) in enumerate(sync):
            plan = CommsPlan(schedule="auto", wire_dtype=wire,
                             bucket_bytes=bb, intra_axis="data")
            resolved[str(i)] = plan.resolve(
                mesh, sum(4 * v.numel() for v in tree.values()))
            res = sync_tree(tree, plan, mesh, ("pod", "data"))
            for k, v in res.items():
                out[f"sync{i}|{rank}|{k}"] = bits(v)
    np.savez(dst, **out)
    with open(dst + ".json", "w") as f:
        json.dump({"wire": wire_bytes, "resolved": resolved}, f)
    close_group()
""")


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), **extra)
    env.setdefault("JAX_PLATFORMS", "cpu")
    return env


def _start_ranks(tmp, name, keys, sync, world, src):
    init = f"file://{tmp / f'rendezvous-{name}'}"
    return [(subprocess.Popen(
        [sys.executable, "-c", _TORCH_RANK, str(r), init, str(src),
         str(tmp / f"{name}{r}.npz"), json.dumps(keys), json.dumps(sync),
         str(world), json.dumps(CASES)],
        env=_env(OMP_NUM_THREADS="1"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True), tmp / f"{name}{r}.npz")
        for r in range(world)]


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(port outputs, reference outputs, port WIRE bytes by case, the
    sync cases' resolved schedules on each side, the inputs)."""
    tmp = tmp_path_factory.mktemp("schedules")
    src = tmp / "inputs.npz"
    inputs = _inputs()
    np.savez(src, **inputs)
    four = sorted(k for k, c in CASES.items() if np.prod(c[0]) == 4)
    three = sorted(k for k, c in CASES.items() if np.prod(c[0]) == 3)
    halves = [four[::2] + three, four[1::2]]
    jax_procs = [(subprocess.Popen(
        [sys.executable, "-c", _JAX_SIDE, str(src), str(tmp / f"jax{i}.npz"),
         json.dumps(keys), json.dumps(SYNC if i == 0 else []),
         json.dumps(CASES)],
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
        tmp / f"jax{i}.npz") for i, keys in enumerate(halves)]
    ranks = (_start_ranks(tmp, "four", four, SYNC, 4, src)
             + _start_ranks(tmp, "three", three, [], 3, src))
    got, wire, resolved = {}, {}, {}
    for p, dst in ranks:
        log = p.communicate(timeout=400)[0]
        assert p.returncode == 0, log[-3000:]
        got.update(np.load(dst))
        side = json.loads(Path(str(dst) + ".json").read_text())
        wire.update(side["wire"])
        resolved.setdefault("port", side["resolved"])
    want = {}
    for p, dst in jax_procs:
        log = p.communicate(timeout=600)[0]
        assert p.returncode == 0, log[-3000:]
        want.update(np.load(dst))
        for line in log.splitlines():
            if line.startswith("RESOLVED") and line.split(" ", 1)[1] != "{}":
                resolved["reference"] = json.loads(line.split(" ", 1)[1])
    return got, want, wire, resolved, inputs


def _line(key, r):
    """The ranks of rank ``r``'s reduce group, in order: those that share
    its coordinates on the axes the case does not reduce."""
    shape, names, axes = CASES[key][:3]
    at = np.unravel_index(r, shape)
    return [q for q in range(int(np.prod(shape)))
            if all(c == at[i] for i, c in
                   enumerate(np.unravel_index(q, shape))
                   if names[i] not in axes)]


def _f32(bits: np.ndarray) -> np.ndarray:
    if bits.dtype == np.uint16:
        return (bits.astype(np.uint32) << 16).view(np.float32)
    return bits.view(np.float32)


@pytest.mark.parametrize("key", sorted(CASES))
def test_schedule_is_bitwise_the_references(both, key):
    """Every rank's result the same bits as the rest of its reduce group,
    and the reference's bits.  The ring adds chunk c from index c around
    the line in the tensor's dtype; the tree adds ``x + partner`` per
    level; rsag and hier sum a piece in rank order (a 16-bit type in
    fp32, rounded once); psum adds the group in rank order."""
    got, want, _, _, _ = both
    shape = CASES[key][0]
    n = int(np.prod(shape))
    for r in range(n):
        first = _line(key, r)[0]
        np.testing.assert_array_equal(got[f"{key}|{r}"],
                                      got[f"{key}|{first}"],
                                      err_msg=f"{key}: rank {r} differs")
        np.testing.assert_array_equal(got[f"{key}|{r}"], want[f"{key}|{r}"],
                                      err_msg=f"{key}: rank {r}")


@pytest.mark.parametrize("key", sorted(CASES))
def test_schedule_is_the_sum_within_the_reference_tests_tolerance(both,
                                                                  key):
    """Within ``tests/test_comms.py``'s tolerances of the float64 sum over
    rank 0's reduce group (fp32 rtol 1e-5, atol 8e-5 scaled by the sum's
    largest value; bf16 2e-2, 0.16; hier twice the atol; the int8 wire
    n * scale / 2 per rank, with the bf16 wire's tolerance for bf16)."""
    got, _, _, _, data = both
    shape, names, axes, sched, wire, dtype, size, _ = CASES[key]
    line = _line(key, 0)
    n = len(line)
    xs = [_f32(data[f"{key}|{r}"]) if dtype == "bfloat16"
          else data[f"{key}|{r}"] for r in line]
    want = np.sum(np.stack(xs).astype(np.float64), 0)
    big = np.abs(want).max()
    y = _f32(got[f"{key}|0"]).astype(np.float64)
    if wire == "int8":
        scale = max(np.abs(x).max() for x in xs) / 127
        atol, rtol = n * scale / 2 + 1e-6 * big, 0
    elif wire == "bf16" or dtype == "bfloat16":
        rtol, atol = 2e-2, 0.16 * big / 8
    else:
        rtol, atol = 1e-5, 8e-5 * big / 8
    if sched == "hier":
        atol *= 2
    np.testing.assert_allclose(y, want, rtol=rtol, atol=atol, err_msg=key)


@pytest.mark.parametrize("sched", ["ring", "rsag", "tree", "hier", "psum",
                                   "tree2-float32", "tree2-bf16"])
def test_wire_bytes_are_the_cost_models(both, sched):
    """``WIRE`` per rank against ``allreduce_design`` at a size the line
    divides (fp32, 64 Ki elements): equal for the modelled dataflows;
    hier is its two phases; psum at 4 ranks gathers (n - 1) tensors.
    The 2-rank tree receives one tensor in the wire's dtype (fp32, and
    bf16 for the bf16 wire, whose widened add gathers bf16), as the
    model's one level does."""
    _, _, wire, _, _ = both
    key = f"{sched}-float32-{BIG}"
    nbytes = 4 * BIG
    if sched.startswith("tree2"):
        key, nbytes = sched, (2 if sched.endswith("bf16") else 4) * ODD
        assert wire[key] == topology.allreduce_design(nbytes, "tree", 2)[1]
        return
    got = wire[key]
    if sched == "hier":
        ni = nn = 2
        want = (2 * nbytes * (ni - 1) / ni
                + 2 * (nbytes / ni) * (nn - 1) / nn)
    elif sched == "psum":
        want = 3 * nbytes
    else:
        want = topology.allreduce_design(nbytes, sched, 4)[1]
    assert got == want, (sched, got, want)


def test_sync_tree_auto_over_pod_and_data_is_the_references(both):
    """``sync_tree`` with ``schedule="auto"`` over (pod, data): both sides
    resolve to ``hier`` through the topology (data the fast axis) and
    give the same bits for the fp32, bf16 and int8 wires; every rank
    the same."""
    got, want, _, resolved, _ = both
    assert resolved["port"] == resolved["reference"]
    assert set(resolved["port"].values()) == {"hier"}
    for i in range(len(SYNC)):
        for leaf in ("a", "b", "c"):
            for r in range(4):
                k = f"sync{i}|{r}|{leaf}"
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
                np.testing.assert_array_equal(got[k], got[f"sync{i}|0|{leaf}"])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the int8 wire's quantize kernel "
                    "has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_schedules_on_the_card_are_their_cpu_runs_bitwise(cuda):
    """``chip_smoke.py``'s phase 11 checks, without its timed sizes: four
    gloo ranks spawned on the card run every schedule (fp32 and bf16
    buckets of an odd size and of 4 MiB, the int8 wire through each), each
    result every rank's same bits and bitwise the same schedule on CPU
    tensors in the same ranks, within the reference test's tolerance of
    the fp64 sum, the ring's one-ulp control differing, the wire bytes
    the cost model's where it models the dataflow; then the memory
    verdict (gemma3-27b refused with nothing allocated)."""
    import importlib
    sys.path.insert(0, str(ROOT))
    try:
        cs = importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(str(ROOT))
    summary, launches = cs.sched_phase(fit=False)
    assert summary["cases"] == len(cs.sched_cases())
    assert launches["quantize_int8"] == 5 * cs.SCHED_RANKS
    assert summary["memory"]["allocated_delta"] == 0
