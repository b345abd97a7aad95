"""The port's distributed linear algebra (``repro_torch.core``) against the
JAX reference's ``repro.core``.

The reference runs in one subprocess on 4 fake CPU devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``), the port as 4
CPU ranks of one gloo group (``python -c`` subprocesses, a ``file://``
rendezvous), both on a (data=2, model=2) mesh, both at once, from a module
fixture, on the same seeded numpy inputs.  Every rank's block is compared
with the reference array's shard on the device at the same coordinates
(rank r and device r both sit at ``np.unravel_index(r, (2, 2))``, pinned
below).  Planning, keys and the layout algebra need no ranks and run here
against the reference's functions on shape-only meshes.

Tolerances, stated per check:

- GEMMs (every algorithm, ``gemm_auto``, DistTensor) under ``FULL``: fp32
  products of the same operands summed in another order, rtol 2e-5 and
  atol 2e-5 (``tests/test_gemm_conformance.py``, K = 64 or 32).
- Relayouts move bits: equal, bitwise, with the cast where the reference
  casts.
- ``add_row_col_sum_matrix``: ``tests/test_primitives.py``'s 1e-5 (fp32
  column sums) and 5e-2 (bf16 column sums), relative and 10x absolute;
  ``conv2d_halo``: its 2e-4.
- Keys: bitwise.  Plans: equal.
"""

import itertools
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

from repro_torch.core import gemm as tgemm  # noqa: E402
from repro_torch.core import rng as trng  # noqa: E402
from repro_torch.core import precision as tprecision  # noqa: E402
from repro_torch.core.distributed import Mesh  # noqa: E402
from repro_torch.core.layout import Layout  # noqa: E402
from repro_torch.core.primitives import local_conv  # noqa: E402
from repro_torch.core.replication import zero_layout_tree  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
SHAPE = (2, 2)                      # (data, model)
RANKS = 4
M, K, N = 32, 64, 48                # tests/test_gemm_conformance.py
SMALL = (16, 32, 16)
LAYOUTS = {"rep": Layout.replicated(2), "row": Layout.row_sharded(2, "model"),
           "col": Layout.col_sharded(2, "model"),
           "b2d": Layout.blocked_2d(("data", "model"))}
OUTS = [None, "rep", "row", "col", "b2d"]
ALGS = ["local", "row_par", "col_par", "inner_psum", "inner_rs", "summa2d"]
CONVS = [(1, 1), (3, 3), (5, 3)]    # tests/test_primitives.py
FP32 = dict(rtol=2e-5, atol=2e-5)


def _cases():
    out = []
    for alg, mkn in itertools.product(ALGS, [(M, K, N), SMALL]):
        out.append(dict(id=f"alg/{alg}/{mkn[0]}", kind="alg", alg=alg,
                        mkn=list(mkn)))
    for la, lb, lo in itertools.product(LAYOUTS, LAYOUTS, OUTS):
        out.append(dict(id=f"auto/{la}/{lb}/{lo}", kind="auto", la=la, lb=lb,
                        lout=lo))
    for src, dst in itertools.product(LAYOUTS, LAYOUTS):
        for xd, od in (("float32", "bfloat16"), ("bfloat16", "float32")):
            out.append(dict(id=f"relayout/{src}/{dst}/{xd}", kind="relayout",
                            src=src, dst=dst, x_dtype=xd, out_dtype=od))
    for det in (True, False):
        out.append(dict(id=f"arcs/{det}", kind="arcs", det=det))
    for kh, kw in CONVS:
        out.append(dict(id=f"conv/{kh}x{kw}", kind="conv", kh=kh, kw=kw))
    out.append(dict(id="dtensor", kind="dtensor"))
    return out


CASES = _cases()


def _inputs():
    rng = np.random.default_rng(0)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    data = {"a": f(M, K), "b": f(K, N), "a16": f(*SMALL[:2]),
            "b16": f(*SMALL[1:]), "x": f(32, 16), "m": f(32, 24),
            "img": f(4, 16, 12, 3)}
    for kh, kw in CONVS:
        data[f"w{kh}x{kw}"] = f(kh, kw, 3, 5) * np.float32(0.2)
    return data


# Both sides save bf16 as uint16 bits; a case's blocks are keyed
# "<case id>|<rank or device id>".
_COMMON = """
import json, sys
import numpy as np
cases = json.loads(open(sys.argv[-1]).read())
ALG_IN = {"local": ("rep", "rep"), "row_par": ("row", "rep"),
          "col_par": ("rep", "col"), "inner_psum": ("col", "row"),
          "inner_rs": ("col", "row"), "summa2d": ("b2d", "b2d")}
def operands(c, data):
    if c["kind"] == "alg":
        return ((data["a"], data["b"]) if c["mkn"][0] == 32
                else (data["a16"], data["b16"]))
    return data["a"], data["b"]
def bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a
"""

_JAX_SIDE = _COMMON + textwrap.dedent("""
    import repro  # noqa: F401  (installs the JAX compat shims)
    import jax, jax.numpy as jnp
    from repro.core import DistTensor, REGISTRY, gemm, precision
    from repro.core.layout import Layout
    from repro.core.opcache import OpCache
    from repro.core.primitives import add_row_col_sum_matrix, conv2d_halo
    from repro.core.redistribute import relayout_explicit
    from repro.launch.mesh import make_mesh
    data = dict(np.load(sys.argv[1]))
    dst = sys.argv[2]
    mesh = make_mesh((2, 2), ("data", "model"))
    L = {"rep": Layout.replicated(2), "row": Layout.row_sharded(2, "model"),
         "col": Layout.col_sharded(2, "model"),
         "b2d": Layout.blocked_2d(("data", "model"))}
    ALGO = {"row_par": gemm.gemm_row_parallel,
            "col_par": gemm.gemm_col_parallel,
            "inner_psum": gemm.gemm_inner_psum,
            "inner_rs": gemm.gemm_inner_rs, "summa2d": gemm.gemm_summa2d}
    out = {"devices": np.vectorize(lambda d: d.id)(mesh.devices)}
    def put(cid, arr):
        for s in arr.addressable_shards:
            out[f"{cid}|{s.device.id}"] = bits(s.data)
    FULL = precision.FULL
    with jax.set_mesh(mesh):
        for c in cases:
            k = c["kind"]
            if k == "alg":
                a, b = (jnp.asarray(v) for v in operands(c, data))
                if c["alg"] == "local":
                    res = precision.matmul(a, b, policy=FULL)
                else:
                    res = ALGO[c["alg"]](a, b, mesh, policy=FULL)
            elif k == "auto":
                a, b = (jnp.asarray(v) for v in operands(c, data))
                lo = None if c["lout"] is None else L[c["lout"]]
                res, _ = gemm.gemm_auto(a, b, L[c["la"]], L[c["lb"]], mesh,
                                        out_layout=lo, policy=FULL)
            elif k == "relayout":
                x = jnp.asarray(data["x"]).astype(getattr(jnp, c["x_dtype"]))
                x = jax.device_put(x, L[c["src"]].sharding(mesh))
                res = relayout_explicit(x, L[c["src"]], L[c["dst"]], mesh,
                                        dtype=getattr(jnp, c["out_dtype"]))
            elif k == "arcs":
                res = add_row_col_sum_matrix(jnp.asarray(data["m"]), 0.5,
                                             0.25, mesh=mesh,
                                             deterministic=c["det"])
            elif k == "conv":
                res = conv2d_halo(jnp.asarray(data["img"]),
                                  jnp.asarray(data[f"w{c['kh']}x{c['kw']}"]),
                                  mesh=mesh)
            elif k == "dtensor":
                A = DistTensor.shard(jnp.asarray(data["a"]), L["row"], mesh,
                                     name="A", policy=FULL)
                B = DistTensor.shard(jnp.asarray(data["b"]), L["rep"], mesh,
                                     name="B", policy=FULL)
                C = A @ B
                put("dtensor/c", C.data)
                res = C.to_global()
                cache = OpCache("test")
                for _ in range(5):
                    gemm.gemm_auto(jnp.asarray(data["a"]),
                                   jnp.asarray(data["b"]), L["rep"], L["rep"],
                                   mesh, policy=FULL, cache=cache)
                st = cache.stats()["gemm_auto"]
                out["dtensor/meta"] = np.array(json.dumps(dict(
                    c_name=C.name, c_layout=repr(C.layout),
                    relayout_name=A.with_layout(L["col"]).name,
                    names=sorted(n for n in ("A", "B", C.name)
                                 if REGISTRY.lookup(n) is not None),
                    compiles=st.compiles, hits=st.hits)))
            put(c["id"], res)
    np.savez(dst, **out)
""")

_PORT_RANK = _COMMON + textwrap.dedent("""
    import torch
    import torch.distributed as dist
    from repro_torch.api import Session
    from repro_torch.core import REGISTRY, DistTensor, gemm, precision
    from repro_torch.core.distributed import WIRE, Mesh, close_group, init_group
    from repro_torch.core.layout import Layout
    from repro_torch.core.opcache import OpCache
    from repro_torch.core.primitives import add_row_col_sum_matrix, conv2d_halo
    from repro_torch.core.redistribute import relayout_explicit
    rank, init = int(sys.argv[1]), sys.argv[2]
    data = {k: torch.from_numpy(v) for k, v in np.load(sys.argv[3]).items()}
    dst = sys.argv[4]
    init_group(init, rank=rank, world_size=4, device="cpu")
    mesh = Mesh((2, 2), ("data", "model"), dist.group.WORLD)
    L = {"rep": Layout.replicated(2), "row": Layout.row_sharded(2, "model"),
         "col": Layout.col_sharded(2, "model"),
         "b2d": Layout.blocked_2d(("data", "model"))}
    ALGO = {"row_par": gemm.gemm_row_parallel,
            "col_par": gemm.gemm_col_parallel,
            "inner_psum": gemm.gemm_inner_psum,
            "inner_rs": gemm.gemm_inner_rs, "summa2d": gemm.gemm_summa2d}
    FULL = precision.FULL
    out = {"coords": np.array([mesh.coords["data"], mesh.coords["model"]])}
    def tobits(t):
        return bits(t.view(torch.int16).numpy() if t.element_size() == 2
                    else t.numpy())
    for c in cases:
        k = c["kind"]
        if k == "alg":
            la, lb = ALG_IN[c["alg"]]
            a, b = (L[n].block(v, mesh)
                    for n, v in zip((la, lb), operands(c, data)))
            if c["alg"] == "local":
                res = precision.matmul(a, b, policy=FULL)
            else:
                res = ALGO[c["alg"]](a, b, mesh, policy=FULL)
        elif k == "auto":
            a, b = operands(c, data)
            lo = None if c["lout"] is None else L[c["lout"]]
            res, _ = gemm.gemm_auto(L[c["la"]].block(a, mesh),
                                    L[c["lb"]].block(b, mesh), L[c["la"]],
                                    L[c["lb"]], mesh, out_layout=lo,
                                    policy=FULL)
        elif k == "relayout":
            x = data["x"].to(getattr(torch, c["x_dtype"]))
            WIRE.reset()
            res = relayout_explicit(L[c["src"]].block(x, mesh), L[c["src"]],
                                    L[c["dst"]], mesh,
                                    dtype=getattr(torch, c["out_dtype"]))
            out[c["id"] + "/wire"] = np.array(sorted(
                str(d) for d in WIRE.dtypes) or ["none"])
        elif k == "arcs":
            res = add_row_col_sum_matrix(L["row"].block(data["m"], mesh), 0.5,
                                         0.25, mesh=mesh,
                                         deterministic=c["det"])
        elif k == "conv":
            img = Layout(("data", "model", None, None)).block(data["img"],
                                                              mesh)
            res = conv2d_halo(img, data[f"w{c['kh']}x{c['kw']}"], mesh=mesh)
        elif k == "dtensor":
            A = DistTensor.shard(data["a"], L["row"], mesh, name="A",
                                 policy=FULL)
            B = DistTensor.shard(data["b"], L["rep"], mesh, name="B",
                                 policy=FULL)
            C = A @ B
            out["dtensor/c|" + str(rank)] = tobits(C.data)
            res = C.to_global()
            cache = OpCache("test")
            for _ in range(5):
                gemm.gemm_auto(data["a"], data["b"], L["rep"], L["rep"], mesh,
                               policy=FULL, cache=cache)
            st = cache.stats()["gemm_auto"]
            out["dtensor/meta"] = np.array(json.dumps(dict(
                c_name=C.name, c_layout=repr(C.layout),
                relayout_name=A.with_layout(L["col"]).name,
                names=sorted(n for n in ("A", "B", C.name)
                             if REGISTRY.lookup(n) is not None),
                compiles=st.compiles, hits=st.hits)))
            # the session's table, not the global one
            sess = Session(device="cpu", group=dist.group.WORLD, mesh=mesh)
            before = len(REGISTRY)
            X = sess.tensor(data["a"].numpy(), L["row"], name="X", policy=FULL)
            Y = sess.tensor(data["b"], name="Y", policy=FULL)
            Z = (X @ Y) + X.with_layout(L["rep"]) @ Y
            out["session/meta"] = np.array(json.dumps(dict(
                names=sorted(sess.tensors.layouts()),
                registry_grew=len(REGISTRY) - before,
                z=[Z.name, repr(Z.layout), list(Z.shape)])))
            out["session/z|" + str(rank)] = tobits(Z.to_global())
        out[c["id"] + "|" + str(rank)] = tobits(res)
    np.savez(dst, **out)
    close_group()
""")


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), **extra)
    env.setdefault("JAX_PLATFORMS", "cpu")
    return env


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """Every case on both sides, started together: (port, reference),
    each a dict of blocks keyed ``<case>|<rank>``."""
    pytest.importorskip("jax")
    tmp = tmp_path_factory.mktemp("linalg")
    np.savez(tmp / "in.npz", **_inputs())
    (tmp / "cases.json").write_text(json.dumps(CASES))
    # the reference compiles a program per case: two children, half each
    jax_procs = []
    for i in range(2):
        (tmp / f"cases{i}.json").write_text(json.dumps(CASES[i::2]))
        jax_procs.append(subprocess.Popen(
            [sys.executable, "-c", _JAX_SIDE, str(tmp / "in.npz"),
             str(tmp / f"jax{i}.npz"), str(tmp / f"cases{i}.json")],
            env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    init = f"file://{tmp / 'rendezvous'}"
    ranks = [subprocess.Popen(
        [sys.executable, "-c", _PORT_RANK, str(r), init, str(tmp / "in.npz"),
         str(tmp / f"t{r}.npz"), str(tmp / "cases.json")],
        env=_env(OMP_NUM_THREADS="1"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(RANKS)]
    outs = [p.communicate(timeout=300)[0] for p in ranks]
    for p, out in zip(ranks, outs):
        assert p.returncode == 0, out[-3000:]
    ref = {}
    for i, p in enumerate(jax_procs):
        jout = p.communicate(timeout=300)[0]
        assert p.returncode == 0, jout[-3000:]
        ref.update(np.load(tmp / f"jax{i}.npz"))
    port = {}
    for r in range(RANKS):
        for k, v in np.load(tmp / f"t{r}.npz").items():
            port[k if "|" in k or k in ("dtensor/meta", "session/meta")
                 else f"{k}@{r}"] = v
    return port, ref


def _pair(both, cid):
    port, ref = both
    for r in range(RANKS):
        got, want = port[f"{cid}|{r}"], ref[f"{cid}|{r}"]
        assert got.shape == want.shape, (cid, r, got.shape, want.shape)
        yield r, got, want


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def test_rank_coordinates_are_the_references_device_order(both):
    """Rank r sits at ``np.unravel_index(r, (2, 2))``, where
    ``jax.make_mesh`` puts fake device r."""
    port, ref = both
    np.testing.assert_array_equal(ref["devices"], np.arange(4).reshape(2, 2))
    np.testing.assert_array_equal(Mesh(SHAPE, ("data", "model")).devices,
                                  ref["devices"])
    for r in range(RANKS):
        assert tuple(port[f"coords@{r}"]) == np.unravel_index(r, SHAPE)


# ---------------------------------------------------------------------------
# GEMM: every algorithm, gemm_auto over every layout pair and out layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("alg", ALGS)
@pytest.mark.parametrize("m", [M, SMALL[0]])
def test_algorithm_blocks_match_reference(both, alg, m):
    for _, got, want in _pair(both, f"alg/{alg}/{m}"):
        np.testing.assert_allclose(got, want, **FP32)


@pytest.mark.parametrize("la,lb", list(itertools.product(LAYOUTS, LAYOUTS)))
def test_gemm_auto_blocks_match_reference(both, la, lb):
    """Every out layout (none, rep, row, col, b2d) of one operand pair:
    each rank's block of C within fp32's rule of the reference's shard."""
    for lo in OUTS:
        for _, got, want in _pair(both, f"auto/{la}/{lb}/{lo}"):
            np.testing.assert_allclose(got, want, **FP32)


def _plan(p):
    f = lambda l: None if l is None else l.dims
    return (p.algorithm, f(p.a_relayout), f(p.b_relayout), f(p.out_layout),
            p.est_bytes)


@pytest.fixture(scope="module")
def J():
    pytest.importorskip("jax")
    import repro  # noqa: F401  (installs the JAX compat shims)
    import jax.numpy as jnp
    from repro.core import gemm, precision, replication, rng
    from repro.core.layout import Layout as JLayout
    return SimpleNamespace(jnp=jnp, gemm=gemm, rng=rng, Layout=JLayout,
                           replication=replication, precision=precision)


@pytest.mark.parametrize("shape", [(2, 4), (2, 2)])
@pytest.mark.parametrize("la,lb", list(itertools.product(LAYOUTS, LAYOUTS)))
def test_plan_gemm_is_the_references(J, shape, la, lb):
    """Algorithm, relayouts, out layout and estimated bytes, for every out
    layout, both dtypes and both conformance shapes, from shape-only
    meshes (the planner reads only the axis sizes)."""
    tmesh = Mesh(shape, ("data", "model"))
    jmesh = SimpleNamespace(shape=dict(zip(("data", "model"), shape)))
    jl = {k: J.Layout(v.dims) for k, v in LAYOUTS.items()}
    for lo, (m, k, n), dt in itertools.product(
            OUTS, [(M, K, N), SMALL], ("float32", "bfloat16")):
        got = tgemm.plan_gemm((m, k), (k, n), getattr(torch, dt),
                              LAYOUTS[la], LAYOUTS[lb], tmesh,
                              None if lo is None else LAYOUTS[lo])
        want = J.gemm.plan_gemm((m, k), (k, n), getattr(J.jnp, dt),
                                jl[la], jl[lb], jmesh,
                                None if lo is None else jl[lo])
        assert _plan(got) == _plan(want), (lo, m, dt)


def test_gemm_auto_dispatch_table_at_2x4():
    """The reference's documented dispatch table
    (``tests/test_gemm_conformance.py``)."""
    mesh = Mesh((2, 4), ("data", "model"))
    for la, lb, lout, alg in [
            ("rep", "rep", None, "local"), ("row", "rep", None, "row_par"),
            ("rep", "col", None, "col_par"), ("col", "row", "rep", "inner_psum"),
            ("col", "row", "row", "inner_rs"), ("col", "row", None, "inner_rs"),
            ("b2d", "b2d", "b2d", "summa2d")]:
        plan = tgemm.plan_gemm((M, K), (K, N), torch.float32, LAYOUTS[la],
                               LAYOUTS[lb], mesh,
                               None if lout is None else LAYOUTS[lout])
        assert plan.algorithm == alg, (la, lb, lout, plan)


# ---------------------------------------------------------------------------
# relayouts: values bitwise, the narrow dtype on the wire
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src,dst", list(itertools.product(LAYOUTS, LAYOUTS)))
def test_relayout_blocks_and_wire_dtype(both, src, dst):
    """fp32 -> bf16 and bf16 -> fp32 between every pair: the blocks are the
    reference's bit for bit, and every collective moved bf16 only
    (narrowed before, widened after; ``tests/test_redistribute_dtype.py``)."""
    port, _ = both
    for xd in ("float32", "bfloat16"):
        cid = f"relayout/{src}/{dst}/{xd}"
        for r, got, want in _pair(both, cid):
            np.testing.assert_array_equal(got, want)
            wire = set(port[f"{cid}/wire@{r}"])
            moves = not (src == dst or src == "rep")
            assert wire == ({"torch.bfloat16"} if moves else {"none"}), \
                (cid, r, wire)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("det", [True, False])
def test_add_row_col_sum_matrix_matches_reference(both, det):
    mm = _inputs()["m"].astype(np.float64)
    want_all = mm + 0.5 * mm.sum(1, keepdims=True) \
        + 0.25 * mm.sum(0, keepdims=True)
    tol = 1e-5 if det else 5e-2
    for r, got, want in _pair(both, f"arcs/{det}"):
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol * 10)
        i = np.unravel_index(r, SHAPE)[1]
        np.testing.assert_allclose(got, want_all[16 * i:16 * (i + 1)],
                                   rtol=tol, atol=tol * 10)


@pytest.mark.parametrize("kh,kw", CONVS)
def test_conv2d_halo_matches_reference(both, kh, kw):
    for _, got, want in _pair(both, f"conv/{kh}x{kw}"):
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_local_conv_is_the_unsharded_conv():
    """One rank's conv of the whole height padded by kh // 2 is the SAME
    conv (no halo, no sharding), against float64."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 9, 7, 3)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 5, 3, 4)).astype(np.float32))
    got = local_conv(torch.nn.functional.pad(x, (0, 0, 0, 0, 1, 1)), w)
    want = torch.nn.functional.conv2d(
        x.double().permute(0, 3, 1, 2), w.double().permute(3, 2, 0, 1),
        padding=(1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)


# ---------------------------------------------------------------------------
# DistTensor, the op cache, the Session's table
# ---------------------------------------------------------------------------

def test_disttensor_api_matches_reference(both):
    """``tests/test_core_gemm.py``'s DistTensor and op-cache checks: a @ b
    (row x replicated) blocks and ``to_global`` within fp32's rule, the
    reference's names, and one plan built for five identical calls."""
    port, ref = both
    for cid in ("dtensor/c", "dtensor"):
        for _, got, want in _pair(both, cid):
            np.testing.assert_allclose(got, want, **FP32)
    got = json.loads(str(port["dtensor/meta"]))
    want = json.loads(str(ref["dtensor/meta"]))
    assert got == want, (got, want)
    assert got["c_name"] == "(A@B)" and got["names"] == ["(A@B)", "A", "B"]
    assert got["relayout_name"] == "A@L[-, model]"
    assert (got["compiles"], got["hits"]) == (1, 4)


def test_session_tensors_land_in_the_sessions_table(both):
    port, _ = both
    meta = json.loads(str(port["session/meta"]))
    assert meta["registry_grew"] == 0
    assert {"X", "Y", "(X@Y)", "X@L[-, -]", "(X@L[-, -]@Y)"} <= set(
        meta["names"])
    assert meta["z"][1:] == ["L[model, -]", [M, N]]
    a, b = (torch.from_numpy(_inputs()[k]).double() for k in "ab")
    for r in range(RANKS):
        np.testing.assert_allclose(port[f"session/z|{r}"],
                                   (2 * (a @ b)).numpy(), **FP32)


def test_one_rank_session_tensor(tmp_path):
    """With no process group the Session's mesh is one rank, (data=1,
    model=1); a product of its tensors is the local product."""
    from repro_torch.api import Session
    from repro_torch.core import REGISTRY
    sess = Session(device="cpu")
    assert dict(sess.mesh.shape) == {"data": 1, "model": 1}
    before = len(REGISTRY)
    a = sess.tensor(np.eye(4, dtype=np.float32), name="I",
                    policy=tprecision.FULL)
    b = sess.tensor(torch.arange(8.0).reshape(4, 2),
                    Layout.row_sharded(2), name="v", policy=tprecision.FULL)
    c = a @ b
    assert c.name == "(I@v)" and "(I@v)" in sess.tensors
    assert len(REGISTRY) == before
    assert torch.equal(c.to_global(), torch.arange(8.0).reshape(4, 2))
    assert float(c.sum()) == 28.0


def test_mesh_builders_and_the_source_layout_rule():
    """The builders' shapes (the reference's ``launch/mesh.py``), a
    production mesh refused without its ranks, and the calls that need a
    block's source layout refusing to guess it; ``OpCache.call`` replays
    the first callable built for a key."""
    from repro_torch.core import OpCache, constrain, relayout
    from repro_torch.launch import mesh as tmesh
    assert tmesh.production_shape() == ((16, 16), ("data", "model"))
    assert tmesh.production_shape(multi_pod=True) == \
        ((2, 16, 16), ("pod", "data", "model"))
    assert tmesh.production_shape(pp=4) == \
        ((64, 4, 1), ("data", "pipe", "model"))
    assert tmesh.production_shape(multi_pod=True, pp=4) == \
        ((2, 64, 4, 1), ("pod", "data", "pipe", "model"))
    with pytest.raises(ValueError, match="pp=3"):
        tmesh.production_shape(pp=3)
    with pytest.raises(ValueError, match="needs a process group"):
        tmesh.make_production_mesh()
    assert dict(tmesh.make_mesh((2, 4), ("data", "model")).shape) == \
        {"data": 2, "model": 4}
    one = tmesh.make_host_mesh()
    assert (dict(one.shape), one.coords) == ({"data": 1, "model": 1},
                                             {"data": 0, "model": 0})
    x = torch.arange(12.0).reshape(3, 4)
    with pytest.raises(ValueError, match="src="):
        constrain(x, Layout.row_sharded(2), one)
    with pytest.raises(ValueError, match="src="):
        relayout(x, Layout.row_sharded(2), one)
    assert torch.equal(constrain(x, Layout.row_sharded(2), one,
                                 src=Layout.replicated(2)), x)
    assert torch.equal(tgemm.sharded_matmul(x, x.t().contiguous(),
                                            Layout.col_sharded(2), one),
                       x @ x.t())
    cache, calls = OpCache("t"), []
    for fn in (lambda v: calls.append(1) or v + 1, lambda v: v - 1):
        assert float(cache.call("inc", fn, torch.zeros(2))[0]) == 1.0
    st = cache.stats()["inc"]
    assert (st.compiles, st.hits, len(calls)) == (1, 1, 2)


# ---------------------------------------------------------------------------
# replication, rng, precision
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,axes", [
    ((2, 2), ("data", "model")), ((2, 4), ("data", "model")),
    ((2, 2, 2), ("pod", "data", "model"))])
def test_zero_layout_tree_on_qwen2_params_is_the_references(J, shape, axes):
    """Every leaf of qwen2-0.5b (full width), replicated and with the
    2-D and 3-D leaves' last dim on ``model``."""
    import jax
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    shapes = {k: tuple(v.shape) for k, v in
              Model(get_config("qwen2-0.5b"), device="cpu").param_specs()
              .items()}
    for tp in (False, True):
        lays = {k: (Layout.col_sharded(len(s), "model") if tp and len(s) >= 2
                    and s[-1] % 4 == 0 else Layout.replicated(len(s)))
                for k, s in shapes.items()}
        tmesh = Mesh(shape, axes)
        jmesh = SimpleNamespace(shape=dict(zip(axes, shape)))
        got = zero_layout_tree(lays, shapes, tmesh)
        want = J.replication.zero_layout_tree(
            {k: J.Layout(v.dims) for k, v in lays.items()},
            {k: jax.ShapeDtypeStruct(s, J.jnp.float32)
             for k, s in shapes.items()}, jmesh)
        assert {k: v.dims for k, v in got.items()} == \
            {k: v.dims for k, v in want.items()}
        assert any(v != lays[k] for k, v in got.items())


def test_derive_keys_are_the_references_bitwise(J):
    for seed in (0, 1, 42, 2**31 - 1, 2**32 + 5, -1):
        path = ("layer", 3, "dropout", 2**32 - 1, "")
        want = np.asarray(J.rng.derive(J.rng.root_key(seed), *path))
        got = trng.derive(trng.root_key(seed), *path)
        assert got.dtype == torch.uint32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            trng.per_step(trng.root_key(seed), 7).numpy(),
            np.asarray(J.rng.per_step(J.rng.root_key(seed), 7)))
    g1 = trng.generator(trng.derive(trng.root_key(0), "x"))
    g2 = trng.generator(trng.derive(trng.root_key(0), "x"))
    assert torch.equal(torch.randn(4, generator=g1),
                       torch.randn(4, generator=g2))


def test_nondeterministic_ops_are_the_references_copy(J):
    assert trng.NONDETERMINISTIC_OPS == J.rng.NONDETERMINISTIC_OPS


def test_policies_are_the_references(J):
    """FULL, MIXED and HALF_STORAGE name the reference's dtypes at every
    boundary, and ``matmul`` gives an ``accum_dtype`` result of
    compute-dtype operands."""
    for name in ("FULL", "MIXED", "HALF_STORAGE"):
        got, want = getattr(tprecision, name), getattr(J.precision, name)
        for f in ("param_dtype", "compute_dtype", "accum_dtype",
                  "master_dtype", "reduce_dtype", "activation_dtype"):
            assert str(getattr(got, f)).removeprefix("torch.") == \
                J.jnp.dtype(getattr(want, f)).name, (name, f)
    rng = np.random.default_rng(1)
    a = rng.standard_normal((3, 5, 16)).astype(np.float32)
    b = rng.standard_normal((16, 8)).astype(np.float32)
    for name in ("FULL", "MIXED", "HALF_STORAGE"):
        got = tprecision.matmul(torch.from_numpy(a), torch.from_numpy(b),
                                getattr(tprecision, name))
        want = J.precision.matmul(J.jnp.asarray(a), J.jnp.asarray(b),
                                  getattr(J.precision, name))
        assert got.dtype == torch.float32 and got.shape == (3, 5, 8)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)
    params = {"w": torch.ones(2, dtype=torch.float32),
              "i": torch.ones(2, dtype=torch.int32)}
    cast = tprecision.MIXED.cast_params(params)
    assert cast["w"].dtype == torch.bfloat16 and cast["i"].dtype == torch.int32
    assert tprecision.HALF_STORAGE.cast_master(cast)["w"].dtype == \
        torch.float32


# ---------------------------------------------------------------------------
# on the card: fp32 stays fp32 with PyTorch's default TF32 flags
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _fp32_rule(got, want, k):
    """The conformance rule (rtol 2e-5, atol 2e-5 at K = 64) with atol
    grown as the outputs' spread, sqrt(K / 64), against a float64
    product: True where it holds everywhere."""
    err = (got.double() - want).abs()
    return not bool((err > 2e-5 * (k / 64) ** 0.5 + 2e-5 * want.abs()).any())


def _conv_err(got, want):
    """Max error past ``tests/test_primitives.py``'s conv rule (rtol and
    atol 2e-4), or 0 where it holds, and the max abs error."""
    err = (got.double() - want).abs()
    return (float((err - 2e-4 - 2e-4 * want.abs()).clamp(min=0).max()),
            float(err.max()))


@pytest.mark.gpu
def test_fp32_conv_and_matmul_take_no_tf32_on_the_card(cuda):
    """``conv2d_halo``'s local conv (AlexNet conv2: 96 -> 256, 5 x 5; unit
    variance outputs) within ``tests/test_primitives.py``'s conv rule
    (2e-4) of the float64 conv, and ``precision.matmul`` under ``FULL``
    (qwen2's MLP up-projection at 2,048 tokens, unit-variance operands)
    within the fp32 rule of the float64 product, with the global TF32
    flags at PyTorch's defaults (cuDNN's allows TF32); ``F.conv2d`` as it
    runs by default must fail the conv rule (a control)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(8, 32, 28, 96, generator=g, device=cuda)
    w = torch.randn(5, 5, 96, 256, generator=g, device=cuda) / (5 * 5 * 96) \
        ** 0.5
    want = torch.nn.functional.conv2d(
        x.double().permute(0, 3, 1, 2), w.double().permute(3, 2, 0, 1),
        padding=(0, 2)).permute(0, 2, 3, 1)
    past, err = _conv_err(local_conv(x, w), want)
    tf32_past, tf32_err = _conv_err(torch.nn.functional.conv2d(
        x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
        padding=(0, 2)).permute(0, 2, 3, 1), want)
    assert past == 0, (err, tf32_err)
    assert tf32_past > 0, (err, tf32_err)
    a = torch.randn(2048, 896, generator=g, device=cuda)
    b = torch.randn(896, 4864, generator=g, device=cuda)
    got = tprecision.matmul(a, b, tprecision.FULL)
    assert got.dtype == torch.float32
    assert _fp32_rule(got, a.double() @ b.double(), 896)
