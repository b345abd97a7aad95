"""The dry run (``Session.dryrun``, ``launch/dryrun.py``) on the CPU.

A dry trace runs the dispatched step for rank 0 on fake tensors over a
process group of torch's ``fake`` backend.  Held here:

- on a (2, 2) mesh, a tiny dense config's traced step counts the same
  bytes and calls per collective in ``WIRE`` as rank 0 of a real 4-rank
  gloo CPU step of the same cell (four ``python -c`` ranks);
- the kernel wrappers' shape functions allocate what the kernels
  allocate (the GEMM's split-K scratch, flash attention's log-sum-exp)
  and record the kernels' counts;
- a scaled-down qwen2 ``train_4k`` dry-runs on the 16x16 production mesh
  with a nonzero traced peak and the JSON keys of the reference's
  artifact;
- mamba2-780m's ``train_4k`` passes on both production meshes (the
  mixer on each rank's SSD heads, the SSD kernels' shape functions);
- serve cells, mamba2's among them, print ``SKIP`` naming ROADMAP item
  13, and ``Session.dryrun`` refuses a serve plan naming item 13;
  ``--pp 3`` (no pipe axis of 3 divides the pod), ``--hlo-out`` and
  ``--comms auto`` are refused;
- qwen2-0.5b's ``train_4k`` at ``--pp 4`` traces the pipeline path's
  first and last stage (a result named ``_pp4``), each rank's
  point-to-point bytes its share of the stage-boundary wire and the rest
  of its wire the layouts' estimate (``chip_smoke.pipe_wire_estimate``);
- a trace leaves ``WIRE``'s counts from before it as they were.

The ``gpu`` test (the shape functions' bytes against the card's
allocations) skips here by its fixture.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import Session  # noqa: E402
from repro_torch.core import dry  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import gemm, roofline  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
CELL = dict(batch=4, seq=32, scale_down=16, comms="off")

_RANK = r"""
import json, sys, torch
from repro_torch.api import Session
from repro_torch.core import distributed as D
from repro_torch.launch.mesh import make_mesh
rank, init, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
cell = json.loads(sys.argv[4])
D.init_group(init, rank=rank, world_size=4, device="cpu")
assert torch.distributed.get_backend() == "gloo"
sess = Session(device="cpu", mesh=make_mesh((2, 2), ("data", "model")))
plan = sess.plan("qwen2-0.5b", **cell)
sess.init_state(plan, seed=0)
g = torch.Generator().manual_seed(0)
batch = {k: torch.randint(0, plan.cfg.vocab_size, (cell["batch"],
                                                   cell["seq"]), generator=g)
         for k in ("tokens", "labels")}
D.WIRE.reset()
sess.step(plan, batch)
if rank == 0:
    with open(out, "w") as f:
        json.dump({"bytes": dict(D.WIRE.bytes),
                   "calls": dict(D.WIRE.calls)}, f)
D.close_group()
"""


def _env():
    return dict(os.environ, PYTHONPATH=SRC + os.pathsep
                + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def test_the_traced_step_counts_the_real_steps_collectives(tmp_path):
    out = tmp_path / "rank0.json"
    init = f"file://{tmp_path / 'rendezvous'}"
    ranks = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), init, str(out),
         json.dumps(CELL)], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(4)]
    with dryrun.fake_world(4):
        sess = Session(device="cpu", mesh=make_mesh((2, 2),
                                                    ("data", "model")))
        plan = sess.plan("qwen2-0.5b", **CELL)
        trace, meta = sess.dryrun(plan)
    for p in ranks:
        log = p.communicate(timeout=300)[0]
        assert p.returncode == 0, log[-3000:]
    real = json.loads(out.read_text())
    assert meta["step"] == "train_step" and meta["path"] == "gspmd"
    assert meta["plan"]["attn_mode"] == "head_tp"
    assert trace.collectives == real["bytes"]
    assert trace.collective_calls == real["calls"]
    assert trace.wire_bytes == sum(real["bytes"].values()) > 0
    L = plan.cfg.n_layers
    # forward, remat and both products of the 7 layer products and the
    # head; flash forward twice (remat) and backward once a layer
    assert trace.kernel_calls == {"matmul": 4 * (7 * L + 1) - 1,
                                  "attention": 2 * L,
                                  "attention_backward": L}
    assert trace.peak_bytes > trace.state_bytes > 0
    assert trace.flops >= sum(trace.kernel_flops.values()) > 0


def test_shape_functions_allocate_what_the_kernels_allocate():
    """A split-K product holds its fp32 scratch beside C; flash's forward
    with autograd holds its log-sum-exp; each records its cost."""
    M, K, N = 8, 896, 4864
    pl = gemm.plan(M, K, N)
    assert pl.split == pl.groups > 1
    with dry.fake_mode():
        a = torch.empty(M, K, dtype=torch.bfloat16)
        b = torch.empty(K, N, dtype=torch.bfloat16)
        with dry.traced((a, b)) as tr:
            c = gemm.matmul(a, b, torch.float32)
        assert tuple(c.shape) == (M, N) and c.dtype == torch.float32
    assert tr.state_bytes == 2 * (M * K + K * N)
    assert tr.peak_bytes == tr.state_bytes + 4 * M * N * (1 + pl.groups)
    assert tr.kernel_calls == {"matmul": 1}
    assert roofline.DRY.bytes["matmul"] == roofline.matmul_cost(M, K, N)[0]
    B, H, S, Dh = 1, 4, 64, 32
    with dry.fake_mode():
        q = torch.empty(B, H, S, Dh, dtype=torch.bfloat16,
                        requires_grad=True)
        k = torch.empty(B, 2, S, Dh, dtype=torch.bfloat16,
                        requires_grad=True)
        with dry.traced((q, k)) as tr:
            o = fa.attention(q, k, k)
            o.sum().backward()
    assert tr.kernel_calls == {"attention": 1, "attention_backward": 1}
    assert tr.kernel_flops["attention"] == roofline.attention_cost(
        q.shape, k.shape, S * (S + 1) // 2)[1]


def test_a_scaled_qwen2_train_4k_dry_runs_on_the_16x16_mesh():
    res = dryrun.run_cell("qwen2-0.5b", "train_4k", multi_pod=False,
                          scale_down=16)
    assert res["mesh"] == "16x16" and res["n_chips"] == 256
    assert res["memory"]["peak_bytes"] > res["memory"]["state_bytes"] > 0
    for key in ("flops", "bytes_accessed"):
        assert res["cost"][key] > 0
    assert set(res["collectives"]) >= {"all_gather", "all_to_all"}
    assert res["collective_wire_bytes"] == sum(
        c["wire_bytes"] for c in res["collectives"].values())
    assert res["n_collectives"] == sum(
        c["count"] for c in res["collectives"].values())
    mm = res["memory_model"]
    assert mm["measured_peak_bytes"] == res["memory"]["peak_bytes"]
    assert mm["predicted_peak_bytes"] > 0 and mm["fits"] is True
    assert res["trace_s"] >= 0 and res["plan"]["attn_mode"] == "sp"
    json.dumps(res)


def test_serve_and_mamba2_cells_skip_naming_their_items(tmp_path, capsys):
    """The serve cells of the families serving on a mesh still waits for
    skip naming item 13 (gemma3's windowed rings, mamba2's long_500k);
    the dense family's, the reference's contract cell qwen2-0.5b
    ``decode_32k`` among them, are traced: a pass line and a JSON with
    the memory model's per-rank K/V beside the traced peak."""
    for arch, shape, item in (("qwen2-0.5b", "decode_32k", None),
                              ("qwen2-0.5b", "prefill_32k", None),
                              ("gemma3-27b", "prefill_32k", "item 13"),
                              ("mamba2-780m", "long_500k", "item 13")):
        dryrun.main(["--arch", arch, "--shape", shape, "--out",
                     str(tmp_path), "--both-meshes"])
        out = capsys.readouterr().out.splitlines()
        tags = [f"{arch}_{shape}_16x16", f"{arch}_{shape}_2x16x16"]
        if item is None:
            assert [ln.split(":")[0] for ln in out
                    if ln.startswith("OK")] == [f"OK   {t}" for t in tags]
            for t in tags:
                res = json.loads((tmp_path / f"{t}.json").read_text())
                mm = res["memory_model"]
                assert res["step"] == {"decode_32k": "serve_step",
                                       "prefill_32k": "prefill_step"}[shape]
                assert mm["kv_cache_bytes"] == res["kv_cache_bytes"] > 0
                assert mm["fits"]
                assert mm["measured_peak_bytes"] == \
                    res["memory"]["peak_bytes"] > mm["kv_cache_bytes"]
                assert res["collectives"]["all_gather"]["count"] > 0
                assert res["memory"]["state_bytes"] > 0
        else:
            assert [ln.split(":")[0] for ln in out[:2]] == [
                f"SKIP {t}" for t in tags]
            assert all(item in ln for ln in out[:2])
        assert out[-1] == "ALL DRY-RUN CELLS PASSED"
    assert sorted(f.name for f in tmp_path.iterdir()) == [
        f"qwen2-0.5b_{shape}_{mesh}.json"
        for shape in ("decode_32k", "prefill_32k")
        for mesh in ("16x16", "2x16x16")]


def test_mamba2_train_4k_passes_on_both_production_meshes(tmp_path, capsys):
    """mamba2-780m's ``train_4k`` at full width and depth on 16 x 16 and
    2 x 16 x 16 (3 SSD heads a rank): the mixer's collectives traced, the
    SSD forward and backward kernels' shape functions called once per
    layer and per recompute, a result written for each mesh."""
    dryrun.main(["--arch", "mamba2-780m", "--shape", "train_4k", "--out",
                 str(tmp_path), "--both-meshes"])
    out = capsys.readouterr().out.splitlines()
    assert not any(ln.startswith("SKIP") for ln in out)
    assert out[-1] == "ALL DRY-RUN CELLS PASSED"
    files = sorted(f.name for f in tmp_path.iterdir())
    assert files == ["mamba2-780m_train_4k_16x16.json",
                     "mamba2-780m_train_4k_2x16x16.json"]
    for name in files:
        res = json.loads((tmp_path / name).read_text())
        assert res["plan"]["attn_mode"] == "none"
        assert res["plan"]["seq_parallel_residual"] is True
        assert {"all_gather", "all_to_all"} <= set(res["collectives"])
        assert res["memory"]["peak_bytes"] > res["memory"]["state_bytes"] > 0


def test_pp4_passes_for_qwen2_train_4k(tmp_path, capsys):
    """``--pp 4`` on the 16x16 pod's chips carved as (64, 4, 1): the
    pipeline path's first and last stage traced, the larger peak
    reported, and each traced rank's ``send_recv`` bytes are the M
    activations (last stage) or cotangents (first) it receives."""
    dryrun.main(["--arch", "qwen2-0.5b", "--shape", "train_4k", "--pp", "4",
                 "--out", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "ALL DRY-RUN CELLS PASSED"
    assert out[-2].startswith("OK   qwen2-0.5b_train_4k_16x16_pp4:")
    files = [f.name for f in tmp_path.iterdir()]
    assert files == ["qwen2-0.5b_train_4k_16x16_pp4.json"]
    res = json.loads((tmp_path / files[0]).read_text())
    assert res["path"] == "pipeline" and res["pp"] == 4
    assert res["mesh"] == "16x16_pp4"
    pipe = res["pipeline"]
    assert pipe["send_recv_bytes"] == {"first": pipe["send_recv_expected"],
                                       "last": pipe["send_recv_expected"]}
    assert 2 * (pipe["stages"] - 1) * pipe["send_recv_expected"] \
        == pipe["boundary_wire_bytes"]
    peaks = res["memory"]["stage_peak_bytes"]
    assert res["memory"]["peak_bytes"] == max(peaks.values())
    assert peaks["last"] > peaks["first"] > 0     # the head's logits
    # the rest of each traced rank's wire is the layouts' estimate
    # (chip_smoke.pipe_wire_estimate: the edge gradients' broadcast, the
    # data axis's reduce-scatter onto the ZeRO blocks and gather back, the
    # loss, metrics and grad-norm sums); the reported trace is the last
    # stage's
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    from types import SimpleNamespace
    shape = {"data": 64, "pipe": 4, "model": 1}
    sess = Session(device="cpu", mesh=make_mesh((64, 4, 1),
                                                ("data", "pipe", "model")))
    plan = sess.plan("qwen2-0.5b", shape="train_4k", comms="off",
                     check_memory=False)
    assert plan.path == "pipeline"
    est = {s: chip_smoke.pipe_wire_estimate(plan, SimpleNamespace(
        shape=shape, coords={"data": 0, "pipe": s, "model": 0}))
        for s in (0, 3)}
    got = {op: c["wire_bytes"] for op, c in res["collectives"].items()
           if op != "send_recv"}
    assert got == est[3]
    assert pipe["wire_bytes"]["first"] \
        == sum(est[0].values()) + pipe["send_recv_bytes"]["first"]
    assert pipe["wire_bytes"]["last"] \
        == sum(est[3].values()) + pipe["send_recv_bytes"]["last"]


@pytest.mark.parametrize("argv,why", [
    (["--arch", "qwen2-0.5b", "--shape", "train_4k", "--pp", "3"],
     "must divide"),
    (["--arch", "qwen2-0.5b", "--shape", "train_4k", "--hlo-out", "x.gz"],
     "HLO"),
    (["--arch", "qwen2-0.5b", "--shape", "train_4k", "--comms", "auto"],
     "model=16"),
])
def test_unported_flags_are_refused(argv, why, capsys):
    with pytest.raises(SystemExit) as ei:
        dryrun.main(argv)
    assert ei.value.code == 2
    assert why in capsys.readouterr().err


def test_session_dryrun_refuses_a_serve_plan():
    """A family serving still waits for (mamba2) is refused naming item
    13; the dense family's serve plans trace their step."""
    sess = Session(device="cpu")
    plan = sess.plan("mamba2-780m", batch=2, seq=32, kind="decode",
                     scale_down=16)
    with pytest.raises(NotImplementedError, match="item 13"):
        sess.dryrun(plan)
    for kind, step in (("decode", "serve_step"), ("prefill", "prefill_step")):
        plan = sess.plan("qwen2-0.5b", batch=2, seq=32, kind=kind,
                         scale_down=16)
        trace, meta = sess.dryrun(plan)
        assert meta["step"] == step and trace.peak_bytes > trace.state_bytes
        assert trace.kernel_calls["matmul"] > 0


def test_a_trace_keeps_the_wire_counts_from_before_it():
    from repro_torch.core import distributed as D
    D.WIRE.reset()
    D.WIRE.record("all_gather", 1024, torch.bfloat16)
    with dry.fake_mode():
        a = torch.empty(8, 64, dtype=torch.bfloat16)
        b = torch.empty(64, 32, dtype=torch.bfloat16)
        with dry.traced((a, b)) as tr:
            D.WIRE.record("psum", 256, torch.float32)
            gemm.matmul(a, b)
    assert tr.collectives == {"psum": 256} and tr.wire_bytes == 256
    assert dict(D.WIRE.bytes) == {"all_gather": 1024}
    assert dict(D.WIRE.calls) == {"all_gather": 1}
    assert D.WIRE.dtypes == {torch.bfloat16}
    D.WIRE.reset()


@pytest.mark.gpu
def test_shape_functions_match_the_kernels_allocations(cuda):
    """On the card: the bytes a kernel call allocates (the allocator's
    peak over the call) equal what its shape function allocates in a
    dry trace of the same call, within the allocator's 512-byte
    rounding of each block."""
    def real(fn, *args):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn(*args)
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base, out

    def traced(fn, *shapes):
        with dry.fake_mode():
            args = [torch.empty(s, dtype=torch.bfloat16, device="cuda")
                    for s in shapes]
            with dry.traced(args) as tr:
                fn(*args)
        return tr.peak_bytes - tr.state_bytes

    cases = [
        (lambda a, b: gemm.matmul(a, b, torch.float32), (8, 896), (896, 4864)),
        (lambda a, b: gemm.matmul(a, b), (1024, 896), (896, 4864)),
        (lambda q, k, v: fa._forward(q, k, v, True, None, None, 0.125, 0,
                                     True), (2, 14, 512, 64),
         (2, 2, 512, 64), (2, 2, 512, 64)),
    ]
    for fn, *shapes in cases:
        args = [torch.randn(s, device=cuda).to(torch.bfloat16)
                for s in shapes]
        got, _ = real(fn, *args)
        want = traced(fn, *shapes)
        assert abs(got - want) <= 512 * 4, (shapes, got, want)
