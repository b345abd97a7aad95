"""The port's CLIs on the CPU: ``launch.train`` against the reference's
``launch/train.run``, its checkpoint resume, the flags that wait for
later items, ``--pp`` on two CPU ranks, and ``launch.serve``'s dense
default with ``--metrics``.

The two train CLIs start from one state: the reference's CLI writes its
initial state (``steps=0``) and the port's CLI resumes from that
checkpoint, which also crosses the checkpoint format between the
packages.  A resume restarts the batch stream from its first batch (the
reference's non-resilient resume), so the port's resumed run sees the
batches the reference's fresh run sees.  Both pipelines run one worker
(the reference's two-thread prefetch may reorder batches; substituted by
monkeypatching, nothing in the reference changes).  Losses are held at
``test_torch_train.py``'s step rule, rtol 1e-3: AdamW moves every weight
by about lr whatever its gradient, so elements with near-zero gradients
may move the other way and the losses of later steps drift apart by more
than one forward's 8e-6.

Every run writes under ``tmp_path``: the root ``BENCH_*.json`` files are
the reference's and nothing here touches them.
"""

import filecmp
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402

ARCH = "qwen2-0.5b"
KW = dict(batch=2, seq=32, scale_down=64, comms="off")


def _one_worker(module, monkeypatch):
    real = module.Pipeline

    def one(source, stages, n_threads=2, **kw):
        return real(source, stages, n_threads=1, **kw)

    monkeypatch.setattr(module, "Pipeline", one)


@pytest.fixture(scope="module")
def jtrain():
    pytest.importorskip("jax")
    import repro  # noqa: F401  (installs the JAX compat shims)
    from repro.launch import train
    return train


def test_train_cli_losses_match_the_references(jtrain, tmp_path,
                                               monkeypatch):
    _one_worker(jtrain, monkeypatch)
    _one_worker(ttrain, monkeypatch)
    ck = str(tmp_path / "ck")
    assert jtrain.run(ARCH, steps=0, ckpt_dir=ck, **KW) == []
    want = jtrain.run(ARCH, steps=3, log_every=1, **KW)
    got = ttrain.run(ARCH, steps=3, ckpt_dir=ck, resume=True,
                     device="cpu", log_every=1, **KW)
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-3)
    np.testing.assert_allclose(got[0], want[0], rtol=8e-6)   # one forward
    # the port's final checkpoint is one the reference accepts
    from repro.checkpoint import CheckpointManager as JManager
    jm = JManager(ck)
    assert jm.valid_steps() == [0, 3] and jm.latest_step() == 3
    assert int(np.asarray(jm.restore()["opt"]["step"])) == 3


def test_train_cli_resume_restores_the_saved_state_bitwise(tmp_path,
                                                           capsys):
    """Train 2 steps and save; resume from that checkpoint with nothing
    left to train: the state saved again from the session is the one
    restored, every file the same bytes (params, both moments, master,
    step).  Then a resume that trains goes on from step 2."""
    first, again = str(tmp_path / "a"), str(tmp_path / "b")
    ttrain.run(ARCH, steps=2, ckpt_dir=first, device="cpu", **KW)
    shutil.copytree(first, again)
    ttrain.run(ARCH, steps=2, ckpt_dir=again, resume=True, device="cpu",
               **KW)
    out = capsys.readouterr().out
    assert "resumed from step 2" in out
    a, b = os.path.join(first, "step_2"), os.path.join(again, "step_2")
    names = sorted(os.listdir(a))
    # qwen2's 15 leaves as params, mu, nu and master, the step, the manifest
    assert names == sorted(os.listdir(b)) and len(names) == 4 * 15 + 2
    _, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert mismatch == errors == []
    losses = ttrain.run(ARCH, steps=3, ckpt_dir=again, resume=True,
                        device="cpu", **KW)
    assert len(losses) == 1 and np.isfinite(losses[0])
    assert "step     3 loss" in capsys.readouterr().out


@pytest.mark.parametrize("flag,value,item", [
    ("pp", 2, 10), ("pp_schedule", "1f1b", 10), ("resilient", True, 12),
    ("faults", "[]", 12)])
def test_train_cli_refuses_flags_that_wait_for_later_items(flag, value,
                                                           item, capsys):
    """Every flag is ported.  Item 10's (the pipeline): on one rank
    ``--pp 2`` has no second stage to run (the mesh refuses it) and
    ``--pp-schedule`` alone trains the one-stage path (the ranks' ``--pp``
    run is in ``test_train_cli_main_writes_metrics_under_its_directory``).
    Item 12's: ``--resilient --faults`` with a NaN step rolls it back and
    retries it, and the run's losses are an unfaulted run's, bit for
    bit (each flag's case runs both)."""
    if item == 10 and flag == "pp":
        with pytest.raises(ValueError, match="pp=2 does not divide 1 ranks"):
            ttrain.run(ARCH, steps=1, device="cpu", **{flag: value}, **KW)
        return
    if item == 10:
        losses = ttrain.run(ARCH, steps=1, device="cpu", **{flag: value},
                            **KW)
        assert len(losses) == 1 and np.isfinite(losses[0])
        return
    plan = '[{"seam": "train.nonfinite", "step": 1}]'
    clean = ttrain.run(ARCH, steps=3, device="cpu", **KW)
    capsys.readouterr()
    got = ttrain.run(ARCH, steps=3, device="cpu", resilient=True,
                     faults=plan, **KW)
    out = capsys.readouterr().out
    assert got == clean and len(got) == 3
    assert 'faults: {"train.nonfinite": {"planned": 1, "injected": 1, ' \
        '"pending": 0}}' in out


def test_train_cli_hbm_gib_is_the_plans_budget(capsys):
    """``--hbm-gib`` is the budget the memory verdict prices the cell
    against: the memory-model line names it, and a budget the cell does
    not fit refuses the run before a step, with the footprint table."""
    from repro_torch.api import PlanMemoryError
    losses = ttrain.run(ARCH, steps=1, device="cpu", hbm_gib=8.0, **KW)
    assert len(losses) == 1
    out = capsys.readouterr().out
    assert "memory model: predicted peak" in out
    assert "vs override 8.0 GiB (usable 7.2 GiB @ headroom 0.90) -> fits" \
        in out
    with pytest.raises(PlanMemoryError, match="refusing to launch") as e:
        ttrain.run(ARCH, steps=1, device="cpu", hbm_gib=0.001, **KW)
    assert "step " not in capsys.readouterr().out
    assert e.value.budget.hbm_bytes == int(0.001 * 2**30)
    assert e.value.footprints and "OOM" in str(e.value)


def test_train_cli_calibration_loads_a_fitted_table_and_reports_drift(
        tmp_path, capsys):
    """A run with ``--metrics`` ends with the drift report and writes its
    rows under the snapshot's ``drift``; ``repro_torch.fit`` fits a table
    from that run (steady steps give the FLOPs rate), and
    ``--calibration`` loads it: the table is described, the drift report
    is printed again (its step-time row now from the fitted rate), the
    snapshot names the table, and the active table is cleared after the
    run.  On the CPU no peak is measured, so the report has no peak
    row."""
    from repro_torch import fit as tfit
    from repro_torch.core import calibrate
    first = tmp_path / "a" / "train.jsonl"
    ttrain.run(ARCH, steps=5, device="cpu", metrics=str(first), **KW)
    out = capsys.readouterr().out
    assert "drift report (predicted vs measured):" in out
    snap = json.loads((first.parent / "BENCH_step_metrics.json")
                      .read_text())
    rows = snap["meta"]["drift"]["rows"]
    assert [r["name"] for r in rows] == ["step_time_s"]
    assert snap["meta"]["mesh"] == {"data": 1, "model": 1}
    table = tfit.fit_from_files([str(first)])
    assert table.device_flops and table.device_flops > 0
    path = table.save(str(tmp_path / "calibration.json"))
    second = tmp_path / "b" / "train.jsonl"
    ttrain.run(ARCH, steps=5, device="cpu", metrics=str(second),
               calibration=path, **KW)
    out = capsys.readouterr().out
    assert f"calibration: {table.describe()}  [{path}]" in out
    assert "drift report (predicted vs measured):" in out
    assert calibrate.active() is None
    snap = json.loads((second.parent / "BENCH_step_metrics.json")
                      .read_text())
    assert snap["meta"]["calibration"] == path
    row, = snap["meta"]["drift"]["rows"]
    assert row["name"] == "step_time_s" and row["predicted"] > 0


def test_train_cli_main_writes_metrics_under_its_directory(tmp_path,
                                                           monkeypatch,
                                                           capsys):
    metrics = tmp_path / "m" / "train.jsonl"
    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", ARCH, "--steps", "2", "--batch", "2", "--seq",
        "32", "--comms", "off", "--device", "cpu", "--metrics",
        str(metrics)])
    ttrain.main()
    assert "final loss" in capsys.readouterr().out
    snap = json.loads((tmp_path / "m" / "BENCH_step_metrics.json")
                      .read_text())
    hist = snap["metrics"]["histograms"]
    for name in ("plan", "build_step", "step_warmup", "step"):
        assert hist[f"span.{name}.s"]["count"] == 1, name
    assert snap["meta"]["steps"] == 2 and snap["meta"]["device"] == "cpu"
    events = [json.loads(line) for line in metrics.read_text().splitlines()]
    kinds = {e["kind"] for e in events}
    assert kinds == {"span", "plan_resolved", "metrics"}
    # --pp 2 --pp-schedule 1f1b: two CPU ranks from the environment
    # (RANK, WORLD_SIZE, DMATH_INIT_METHOD) train on the pipeline path
    env = dict(os.environ, WORLD_SIZE="2", OMP_NUM_THREADS="1",
               DMATH_INIT_METHOD=f"file://{tmp_path / 'rendezvous'}",
               PYTHONPATH=str(Path(ttrain.__file__).parents[2]) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    ranks = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--pp", "2", "--pp-schedule", "1f1b", "--steps", "2", "--batch",
         "4", "--seq", "32", "--microbatches", "2", "--device", "cpu"],
        env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in ranks]
    assert all(p.returncode == 0 for p in ranks), "\n".join(outs)
    for out in outs:
        assert "pipeline: 2 stages (1f1b, 2 microbatches)" in out
        assert "step     1 loss" in out and "final loss" in out
    assert outs[0].split("final loss")[1] == outs[1].split("final loss")[1]


def test_serve_cli_dense_default_writes_its_snapshot(tmp_path, capsys):
    metrics = tmp_path / "serve.jsonl"
    total, dt = tserve.run(ARCH, n_requests=3, batch_slots=2, max_seq=32,
                           prompt_len=(5, 9), new_tokens=4, scale_down=64,
                           device="cpu", metrics=str(metrics))
    assert total == 3 * 3        # the first token of each comes at prefill
    out = capsys.readouterr().out
    assert "serve.decode_s: n=" in out and "3 finished" in out
    snap = json.loads((tmp_path / "BENCH_serve_metrics.json").read_text())
    assert snap["meta"]["serve"]["paged"] is False
    assert snap["meta"]["serve"]["scheduler"] == "static"
    assert snap["meta"]["tokens"] == total
    hist = snap["metrics"]["histograms"]
    assert hist["serve.prefill_s"]["count"] == 3
    assert hist["serve.decode_s"]["count"] >= 3
    assert hist["span.build_engine.s"]["count"] == 1
    assert snap["metrics"]["counters"]["serve.decode_tokens"] == total
    lines = metrics.read_text().splitlines()
    assert {json.loads(s)["kind"] for s in lines} == {"span", "metrics"}


@pytest.mark.parametrize("arch", ["gemma3-27b", "gemma-2b", "qwen3-14b"])
def test_clis_take_the_rest_of_the_dense_family(arch, tmp_path):
    """The serve CLI on the dense default (gemma3-27b's windowed cache,
    prompts past its cut window of 16) and the train CLI with a
    checkpoint, at ``--scale-down 64`` on the CPU."""
    total, _ = tserve.run(arch, n_requests=3, batch_slots=2, max_seq=48,
                          prompt_len=(10, 20), new_tokens=6, scale_down=64,
                          device="cpu")
    assert total == 3 * 5        # the first token of each comes at prefill
    losses = ttrain.run(arch, steps=2, ckpt_dir=str(tmp_path / "ck"),
                        device="cpu", **KW)
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert os.listdir(tmp_path / "ck")
