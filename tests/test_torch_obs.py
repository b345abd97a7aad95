"""The port's telemetry (``repro_torch.obs``) against the reference's
``repro.obs``: the metric registry and the sink are copies, pinned to
their originals' code and held to the same documents; the spans close
after the card's work; the disabled ``NULL`` is a no-op.

Everything here runs on the CPU: a span's ``block`` on CPU tensors has
nothing to wait for, and its synchronize on a card is pinned by
monkeypatching ``torch.cuda.synchronize``.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs as tobs  # noqa: E402
from repro_torch.obs import metrics as tmetrics  # noqa: E402
from repro_torch.obs import sink as tsink  # noqa: E402
from repro_torch.obs import trace as ttrace  # noqa: E402

from test_torch_kernels import _defs  # noqa: E402


@pytest.fixture(scope="module")
def J():
    pytest.importorskip("jax")
    from repro import obs
    from repro.obs import metrics, sink
    return obs, metrics, sink


@pytest.mark.parametrize("name", ["metrics", "sink"])
def test_copied_obs_modules_match_their_originals(J, name):
    jmod = {"metrics": J[1], "sink": J[2]}[name]
    tmod = {"metrics": tmetrics, "sink": tsink}[name]
    assert _defs(tmod) == _defs(jmod)


def _observe(reg):
    rng = np.random.default_rng(0)
    for v in rng.lognormal(-5, 2, 200):
        reg.histogram("lat_s").observe(float(v))
    for v in (1e-3, 2.5, 7.0):
        reg.histogram("few_s", buckets=(1e-3, 1.0, 5.0)).observe(v)
    reg.histogram("empty_s")
    reg.counter("bytes").inc(7)
    reg.counter("bytes").inc(35)
    reg.gauge("resident").set(3)
    reg.gauge("resident").set(12.5)


def test_registry_summaries_equal_the_references(J):
    jreg, treg = J[1].MetricRegistry(), tmetrics.MetricRegistry()
    _observe(jreg)
    _observe(treg)
    assert treg.summary() == jreg.summary()
    h = treg.histogram("lat_s")
    assert h.percentile(0.5) <= h.percentile(0.99) <= h.max
    assert treg.histogram("lat_s") is h            # get-or-create


def _drive(obs_mod, path):
    """The same events through one package's Obs facade."""
    obs = obs_mod.Obs(jsonl=str(path / "events.jsonl"), name="t")
    obs.counter("serve.decode_tokens").inc(5)
    obs.gauge("state.entries").set(2)
    obs.histogram("serve.decode_s").observe(0.25)
    obs.event("comms_sync", schedule="psum", wire_bytes=np.int64(64),
              t_wall="ignored")
    snap = obs.snapshot(str(path / "BENCH_x.json"), arch="qwen2-0.5b",
                        tokens=np.int32(9), serve={"paged": False})
    obs.close()
    return snap


def _no_time(doc):
    if isinstance(doc, dict):
        return {k: _no_time(v) for k, v in doc.items() if k != "t_wall"}
    if isinstance(doc, list):
        return [_no_time(v) for v in doc]
    return doc


def test_sink_documents_equal_the_references(J, tmp_path):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jsnap = _drive(J[0], tmp_path / "j")
    tsnap = _drive(tobs, tmp_path / "t")
    assert _no_time(tsnap) == _no_time(jsnap)
    for name in ("events.jsonl",):
        got = tsink.read_jsonl(str(tmp_path / "t" / name))
        want = J[2].read_jsonl(str(tmp_path / "j" / name))
        assert [e["kind"] for e in got] == ["comms_sync", "metrics"]
        assert _no_time(got) == _no_time(want)
    got = json.loads((tmp_path / "t" / "BENCH_x.json").read_text())
    want = json.loads((tmp_path / "j" / "BENCH_x.json").read_text())
    assert _no_time(got) == _no_time(want)
    assert got["meta"]["tokens"] == 9
    assert not list((tmp_path / "t").glob("*.tmp"))   # atomic: renamed


def test_spans_nest_and_feed_histograms(tmp_path):
    obs = tobs.Obs(jsonl=str(tmp_path / "s.jsonl"))
    with obs.span("step", path="gspmd") as outer:
        with obs.span("build_step") as inner:
            pass
        with pytest.raises(ValueError):
            with obs.span("bad"):
                raise ValueError("x")
    obs.close()
    events = tsink.read_jsonl(str(tmp_path / "s.jsonl"))
    by = {e["name"]: e for e in events}
    assert by["build_step"]["parent"] == outer.id == by["step"]["id"]
    assert by["step"]["parent"] is None and by["step"]["path"] == "gspmd"
    assert by["bad"]["error"] == "ValueError"
    assert inner.seconds <= outer.seconds
    hist = obs.metrics.summary()["histograms"]
    assert {"span.step.s", "span.build_step.s", "span.bad.s"} <= set(hist)


def test_span_block_synchronizes_each_card_at_close(monkeypatch):
    """``block`` waits at close on every card its tensors lie on (nested
    trees too), after the span's own work, and on none for CPU tensors."""
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda dev=None: synced.append(dev))
    obs = tobs.Obs()
    out = torch.ones(3)
    with obs.span("step") as sp:
        assert sp.block(out) is out
        sp.block({"a": [out, (out,)]})
        assert synced == []
    assert synced == []                             # CPU: nothing to wait
    devs = ttrace._cuda_devices(
        {"x": torch.empty(2, device="meta"), "y": [1, "s"]}, set())
    assert devs == set()
    fake = type("T", (torch.Tensor,), {})           # a tensor "on a card"
    t = torch.ones(2).as_subclass(fake)
    monkeypatch.setattr(fake, "device", property(
        lambda self: torch.device("cuda", 1)))
    with obs.span("step") as sp:
        sp.block({"m": [t]})
        assert synced == []
    assert synced == [torch.device("cuda", 1)]


def test_null_is_a_noop_that_never_synchronizes(monkeypatch, tmp_path):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda dev=None: synced.append(dev))
    null = tobs.NULL
    assert not null.enabled and isinstance(null, tobs.Obs)
    with null.span("step") as sp:
        assert sp is tobs.NULL_SPAN
        x = torch.ones(2)
        assert sp.block(x) is x
    null.counter("c").inc(3)
    null.gauge("g").set(1.0)
    null.histogram("h").observe(0.5)
    null.event("e", a=1)
    assert null.counter("c").value == 0
    assert null.histogram("h").summary() == {"count": 0}
    assert null.snapshot(str(tmp_path / "x.json")) == {
        "meta": {"name": "null"}, "metrics": {}}
    assert not (tmp_path / "x.json").exists() and synced == []


def test_active_obs_is_scoped(tmp_path):
    obs = tobs.Obs()
    assert tobs.get_active() is tobs.NULL
    prev = tobs.set_active(obs)
    try:
        assert prev is tobs.NULL and tobs.get_active() is obs
    finally:
        tobs.set_active(prev)
    assert tobs.get_active() is tobs.NULL
    assert tobs.set_active(None) is tobs.NULL


def test_session_and_sync_tree_record_the_references_sites(tmp_path):
    """The Session's ``plan`` / ``build_step`` / ``step_warmup`` / ``step``
    spans and its state gauges, and ``sync_tree``'s wire counters and
    event on a one-rank gloo group (int8 wire, credited 1/4 of fp32)."""
    import torch.distributed as dist
    from repro_torch.api import Session
    from repro_torch.comms.plan import CommsPlan, sync_tree
    from repro_torch.data import SyntheticLM

    obs = tobs.Obs(jsonl=str(tmp_path / "e.jsonl"))
    sess = Session(device="cpu", obs=obs)
    plan = sess.plan("qwen2-0.5b", batch=2, seq=16, scale_down=64,
                     comms="off")
    sess.init_state(plan, seed=0)
    data = iter(SyntheticLM(plan.cfg.vocab_size, 2, 16, structured=True))
    for _ in range(2):
        sess.step(plan, next(data))
    hist = obs.metrics.summary()["histograms"]
    for name in ("plan", "build_step", "step_warmup", "step"):
        assert hist[f"span.{name}.s"]["count"] == 1, name
    gauges = obs.metrics.summary()["gauges"]
    state = sess.get("train_state")
    n = sum(t.numel() * t.element_size() for t in
            list(state["params"].values()) + [state["opt"]["step"]]
            + [v for k in ("mu", "nu", "master")
               for v in state["opt"][k].values()])
    assert gauges == {"state.entries": 1.0, "state.resident_bytes": n}

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    prev = tobs.set_active(obs)
    try:
        grads = {"a": torch.ones(1000), "b": torch.ones(24)}
        from repro_torch.launch.mesh import make_host_mesh
        sync_tree(grads, CommsPlan(schedule="psum", wire_dtype="int8"),
                  make_host_mesh(), ("data",))
    finally:
        tobs.set_active(prev)
        dist.destroy_process_group()
    counters = obs.metrics.summary()["counters"]
    assert counters == {"comms.psum.buckets": 1, "comms.psum.wire_bytes":
                        1024, "comms.wire_bytes": 1024,
                        "comms.fused_pack": 1}
    obs.close()
    ev = [e for e in tsink.read_jsonl(str(tmp_path / "e.jsonl"))
          if e["kind"] == "comms_sync"]
    assert len(ev) == 1 and ev[0]["wire_dtype"] == "int8" \
        and ev[0]["fused"] is True
