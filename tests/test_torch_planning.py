"""The port's cost and memory model against the reference's, in process,
both packages on the same inputs: the topology's schedule scores and
``allreduce_design``; the planner's ``comms_plan_for``,
``score_hybrid_candidates`` and ``best_hybrid`` with their refusals; the
memory model's footprints byte for byte; the calibration fit from the
same events and snapshot; the drift report; ``PlanMemoryError``'s
messages; ``StateRegistry``'s refusals; ``Session.plan``'s memory
verdict (gemma3-27b on one rank refused before a model is built) and its
sweep; the copied ``pipeline/costs.py``.

The reference is imported inside the ``J`` fixture (one CPU device);
everything here is host arithmetic (no collective runs), ~10 s.
"""

import dataclasses
import json
import math
import warnings
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import PlanMemoryError, Session, StateRegistry  # noqa: E402,E501
from repro_torch.comms import topology  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import calibrate, memory, planner  # noqa: E402
from repro_torch.obs import report  # noqa: E402
from repro_torch.pipeline import costs  # noqa: E402

from test_torch_kernels import _defs  # noqa: E402

ARCHS = ("qwen2-0.5b", "gemma3-27b", "mamba2-780m")


@pytest.fixture(scope="module")
def J():
    pytest.importorskip("jax")
    import repro  # noqa: F401  (installs the JAX compat shims)
    from repro import fit as jfit
    from repro.api import Session as JSession
    from repro.api import errors, state
    from repro.comms import topology as jtopology
    from repro.configs import get_config as jget
    from repro.core import calibrate as jcal
    from repro.core import memory as jmem
    from repro.core import planner as jplanner
    from repro.obs import report as jreport
    from repro.pipeline import costs as jcosts
    return SimpleNamespace(topology=jtopology, get_config=jget, cal=jcal,
                           memory=jmem, planner=jplanner, report=jreport,
                           costs=jcosts, errors=errors, state=state,
                           Session=JSession, fit=jfit)


def _link(spec):
    return None if spec is None else (spec.latency_s, spec.bandwidth_Bps)


# ---------------------------------------------------------------------------
# the topology and the comms plan
# ---------------------------------------------------------------------------

SHAPES = [{"data": 1, "model": 1}, {"data": 2, "model": 1},
          {"data": 4, "model": 1}, {"data": 2, "model": 2},
          {"data": 1, "model": 4}, {"pod": 2, "data": 2, "model": 1},
          {"pod": 2, "data": 4, "model": 2}]
SIZES = [1, 4096, 65536, 1 << 20, 16 << 20, 1 << 30]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(
    f"{k}{v}" for k, v in s.items()))
def test_topology_scores_are_the_references(J, shape):
    """Every schedule's cost-model seconds, the usable set and the argmin
    (ties to the first key) at six message sizes, under the default
    split, ``data`` as the fast axis, and the gradient-sync topology."""
    mesh = SimpleNamespace(shape=shape)
    for intra in (None, ("data",)):
        t = topology.topology_from_mesh(mesh, intra_axes=intra)
        jt = J.topology.topology_from_mesh(mesh, intra_axes=intra)
        assert (t.intra_axes, t.inter_axes, t.axis_sizes) == \
            (jt.intra_axes, jt.inter_axes, jt.axis_sizes)
        assert t.usable_schedules() == jt.usable_schedules()
        for n in SIZES:
            assert t.schedule_scores(n) == jt.schedule_scores(n)
            assert t.best_schedule(n) == jt.best_schedule(n)
            for s in ("ring", "hier"):
                assert t.allreduce_time(n, s, n=2) == \
                    jt.allreduce_time(n, s, n=2)
    g, jg = planner.grad_sync_topology(mesh), \
        J.planner.grad_sync_topology(mesh)
    assert (g.intra_axes, g.inter_axes, g.axis_sizes) == \
        (jg.intra_axes, jg.inter_axes, jg.axis_sizes)
    for n in SIZES:
        assert planner.score_comms_schedules(n, mesh) == \
            J.planner.score_comms_schedules(n, mesh)


def test_allreduce_design_and_nominal_links_are_the_references(J):
    for s in ("psum", "ring", "rsag", "tree"):
        for n in (1, 2, 3, 4, 8, 16):
            for nbytes in (1, 1000, 1 << 20):
                assert topology.allreduce_design(nbytes, s, n) == \
                    J.topology.allreduce_design(nbytes, s, n)
    with pytest.raises(ValueError, match="no flat design"):
        topology.allreduce_design(8, "hier", 4)
    assert topology.SCHEDULES == J.topology.SCHEDULES
    assert _link(topology.PCIE_GEN3) == _link(J.topology.PCIE_GEN3)
    assert _link(topology.FDR_IB) == _link(J.topology.FDR_IB)


@pytest.mark.parametrize("arch", ARCHS + ("gemma-2b",))
def test_comms_plan_for_is_the_references(J, arch):
    cfg, jcfg = get_config(arch), J.get_config(arch)
    assert planner.approx_param_count(cfg) == \
        J.planner.approx_param_count(jcfg)
    for shape in SHAPES:
        mesh = SimpleNamespace(shape=shape)
        for kw in ({}, dict(wire_dtype="int8", bucket_bytes=1 << 20)):
            got = planner.comms_plan_for(cfg, mesh, **kw)
            want = J.planner.comms_plan_for(jcfg, mesh, **kw)
            for f in ("schedule", "wire_dtype", "bucket_bytes", "mean",
                      "intra_axis"):
                assert getattr(got, f) == getattr(want, f), (shape, f)
            plan = SimpleNamespace(shape=shape)
            for nbytes in (4096, 1 << 26):
                assert got.resolve(plan, nbytes) == want.resolve(plan, nbytes)
                auto = dataclasses.replace(got, schedule="auto")
                jauto = dataclasses.replace(want, schedule="auto")
                assert auto.resolve(plan, nbytes) == \
                    jauto.resolve(plan, nbytes)
                assert auto.estimate_seconds(plan, nbytes) == \
                    jauto.estimate_seconds(plan, nbytes)


# ---------------------------------------------------------------------------
# the hybrid sweep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_hybrid_sweep_and_refusals_are_the_references(J, arch, n_dev):
    """``score_hybrid_candidates`` (scores and refusal reasons) and
    ``best_hybrid`` under the h100 and v5e budgets, GPipe and 1F1B, with
    and without a microbatch count."""
    cfg, jcfg = get_config(arch), J.get_config(arch)
    for plat in ("h100", "v5e"):
        for kw in (dict(global_batch=8, seq_len=512),
                   dict(global_batch=4, seq_len=2048, schedule="1f1b",
                        num_microbatches=2)):
            got = planner.score_hybrid_candidates(
                cfg, n_dev, hbm_budget=memory.HBM_BUDGETS[plat],
                return_refused=True, **kw)
            want = J.planner.score_hybrid_candidates(
                jcfg, n_dev, hbm_budget=J.memory.HBM_BUDGETS[plat],
                return_refused=True, **kw)
            assert got == want, (plat, kw)
            try:
                best = planner.best_hybrid(
                    cfg, n_dev, hbm_budget=memory.HBM_BUDGETS[plat], **kw)
            except ValueError as e:
                with pytest.raises(ValueError) as je:
                    J.planner.best_hybrid(
                        jcfg, n_dev, hbm_budget=J.memory.HBM_BUDGETS[plat],
                        **kw)
                assert str(e) == str(je.value)
            else:
                assert best == J.planner.best_hybrid(
                    jcfg, n_dev, hbm_budget=J.memory.HBM_BUDGETS[plat],
                    **kw)


def test_best_hybrid_for_qwen2_on_four_h100s_is_the_references(J):
    kw = dict(global_batch=4, seq_len=512)
    got = planner.best_hybrid(get_config("qwen2-0.5b"), 4,
                              hbm_budget=memory.HBM_BUDGETS["h100"], **kw)
    assert got == (1, 1, 4) == J.planner.best_hybrid(
        J.get_config("qwen2-0.5b"), 4,
        hbm_budget=J.memory.HBM_BUDGETS["h100"], **kw)


# ---------------------------------------------------------------------------
# the memory model
# ---------------------------------------------------------------------------

def _fields(f):
    return {k: getattr(f, k) for k in memory.Footprint._FIELDS}


@pytest.mark.parametrize("arch", ARCHS + ("gemma-2b", "qwen3-14b"))
def test_footprints_are_the_references_byte_for_byte(J, arch):
    cfg, jcfg = get_config(arch), J.get_config(arch)
    for shape in SHAPES + [{"data": 2, "pipe": 2, "model": 1}]:
        mesh = SimpleNamespace(shape=shape)
        for kw in (dict(global_batch=4, seq_len=512),
                   dict(global_batch=8, seq_len=128, num_microbatches=4,
                        schedule="1f1b", moment_itemsize=2)):
            got = memory.footprints_for_mesh(cfg, mesh, **kw)
            want = J.memory.footprints_for_mesh(jcfg, mesh, **kw)
            assert [_fields(f) for f in got] == [_fields(f) for f in want]
            peak, jpeak = memory.peak_stage_footprint(got), \
                J.memory.peak_stage_footprint(want)
            assert peak.total == jpeak.total
            for plat in ("h100", "v5e", "cpu"):
                b, jb = memory.HBM_BUDGETS[plat], J.memory.HBM_BUDGETS[plat]
                assert (b.usable, b.describe()) == (jb.usable, jb.describe())
                assert memory.footprint_table(got, b) == \
                    J.memory.footprint_table(want, jb)
    for stage in range(4):
        for sched in ("gpipe", "1f1b"):
            kw = dict(local_batch=4, seq_len=256, stage=stage, n_stages=4,
                      num_microbatches=4, schedule=sched, tp_shards=2,
                      zero_shards=2, fsdp_shards=2, edge_gated=stage != 1)
            assert _fields(memory.stage_footprint(cfg, **kw)) == \
                _fields(J.memory.stage_footprint(jcfg, **kw))


def test_budgets_follow_the_device_and_the_override(J):
    """``budget_for`` keys on the device (``cpu`` here; the card by its
    name, where "h100" matches), ``hbm_gib`` and ``platform`` win, and
    the table is the reference's."""
    assert {k: dataclasses.astuple(v) for k, v in memory.HBM_BUDGETS.items()} \
        == {k: dataclasses.astuple(v)
            for k, v in J.memory.HBM_BUDGETS.items()}
    assert memory.budget_for(device="cpu") == memory.HBM_BUDGETS["cpu"]
    assert memory.budget_for() == memory.HBM_BUDGETS["v5e"]
    for kw in (dict(hbm_gib=80), dict(hbm_gib=7.5, headroom=0.5),
               dict(platform="h100"), dict(platform="v5p", headroom=0.8)):
        assert dataclasses.astuple(memory.budget_for(**kw)) == \
            dataclasses.astuple(J.memory.budget_for(**kw))
    assert memory.measured_peak_bytes("cpu") is None


def test_a_cuda_budget_is_the_cards_own(monkeypatch):
    """A card "h100" matches takes the table's h100 entry; any other CUDA
    card its own memory under its name, not the v5e default (the card's
    name and memory are stubbed: no card here)."""
    cards = {"NVIDIA H100 80GB HBM3": 85_045_870_592,
             "NVIDIA A100-SXM4-40GB": 42_297_524_224}
    for name, total in cards.items():
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda device=None, name=name: name)
        monkeypatch.setattr(torch.cuda, "get_device_properties",
                            lambda device=None, total=total:
                            SimpleNamespace(total_memory=total))
        got = memory.budget_for(device="cuda")
        if "H100" in name:
            assert got == memory.HBM_BUDGETS["h100"]
        else:
            assert (got.hbm_bytes, got.platform, got.headroom) == (
                total, name.lower(), memory.DEFAULT_HEADROOM)
            assert memory.budget_for(device="cuda",
                                     headroom=0.5).headroom == 0.5


def test_ledger_and_tree_bytes_count_tensors(J):
    from repro_torch.core.distributed import Mesh
    from repro_torch.core.layout import Layout
    tree = {"a": torch.zeros(3, 5), "b": [torch.zeros(7, dtype=torch.bfloat16),
                                          torch.zeros(2, dtype=torch.int8)]}
    assert memory.tree_bytes(tree) == 60 + 14 + 2
    led = memory.Ledger(Mesh((2, 2), ("data", "model")))
    assert led.add("w", (8, 6), torch.float32, Layout(("data", "model"))) \
        == 4 * 3 * 4
    assert led.add_tree("t", tree) == 76 and led.total == 124


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

def _events(seed):
    rng = np.random.default_rng(seed)
    out = []
    for s in ("ring", "tree", "psum"):
        for nbytes in (4096, 65536, 1 << 20, 16 << 20):
            steps, wire = topology.allreduce_design(nbytes, s, 4)
            t = steps * 3e-4 + wire / 2e9
            out.append({"kind": "collective_sample", "schedule": s,
                        "steps": steps, "wire_bytes": wire,
                        "seconds": t * (1 + 0.05 * rng.standard_normal())})
    out.append({"kind": "bubble_probe", "microbatches": [2, 4],
                "times_s": [0.31, 0.52]})
    return out


def _snapshot(arch="qwen2-0.5b", mesh=None, scale_down=64):
    return {"meta": {"arch": arch, "mesh": mesh or {"data": 1, "model": 1},
                     "batch": 8, "seq": 128, "scale_down": scale_down,
                     "microbatches": 1},
            "metrics": {"gauges": {
                report.MEASURED_PEAK_GAUGE: 3.1e9,
                report.PREDICTED_RAW_PEAK_GAUGE: 2.5e9},
                "histograms": {report.MEASURED_STEP_HISTOGRAM: {
                    "count": 5, "p50": 0.8}}}}


def _table(t):
    d = t.to_dict()
    prov = dict(d.pop("provenance"))
    prov.pop("fitted_at")
    prov.pop("sources")
    return d, prov


@pytest.mark.parametrize("case", ["full", "pipe", "degenerate"])
def test_calibration_fit_is_the_references(J, case, tmp_path):
    """The same events and snapshot give the reference's table, field for
    field (the provenance's time and sources aside), through ``fit`` and
    through ``fit_from_files`` on a JSONL stream whose last document is
    the snapshot; the saved table loads back equal."""
    events = _events(3)
    snap = _snapshot()
    if case == "pipe":
        snap = _snapshot(mesh={"data": 1, "pipe": 2, "model": 1})
    elif case == "degenerate":
        events = events[:1]
        snap["metrics"]["histograms"][report.MEASURED_STEP_HISTOGRAM][
            "count"] = 2
        del snap["metrics"]["gauges"][report.MEASURED_PEAK_GAUGE]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = calibrate.fit(events, snap)
        want = J.cal.fit(events, snap)
        assert _table(got) == _table(want)
        path = tmp_path / "run.jsonl"
        path.write_text("".join(json.dumps(e) + "\n" for e in
                                events + [dict(snap, kind="metrics")]))
        got2 = calibrate.fit_from_files([str(path)])
        want2 = J.cal.fit_from_files([str(path)])
    assert _table(got2) == _table(want2) == _table(got)
    saved = got.save(str(tmp_path / "table.json"))
    assert calibrate.load(saved).to_dict() == got.to_dict()
    assert got.describe() == want.describe()


def test_calibration_table_drives_the_planner_as_the_references(J):
    """An active table's links, FLOPs rate, overhead and memory scale
    move the topology, the sweep and the footprints' verdict as the
    reference's do; clearing it restores the nominals."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        table, jtable = calibrate.fit(_events(5), _snapshot()), \
            J.cal.fit(_events(5), _snapshot())
    assert _link(table.inter) == _link(jtable.inter)
    prev, jprev = calibrate.set_active(table), J.cal.set_active(jtable)
    try:
        assert prev is None and jprev is None
        assert tuple(map(_link, topology.default_links())) == \
            tuple(map(_link, J.topology.default_links()))
        assert costs.device_flops() == J.costs.device_flops()
        kw = dict(global_batch=8, seq_len=512, return_refused=True)
        for n in (2, 4):
            assert planner.score_hybrid_candidates(
                get_config("qwen2-0.5b"), n, **kw) == \
                J.planner.score_hybrid_candidates(
                    J.get_config("qwen2-0.5b"), n, **kw)
        f = memory.stage_footprint(get_config("qwen2-0.5b"),
                                   local_batch=2, seq_len=512)
        jf = J.memory.stage_footprint(J.get_config("qwen2-0.5b"),
                                      local_batch=2, seq_len=512)
        assert f.calibrated_total == jf.calibrated_total != f.total
    finally:
        calibrate.set_active(None)
        J.cal.set_active(None)
    assert topology.default_links() == (topology.PCIE_GEN3, topology.FDR_IB)
    assert costs.device_flops() == costs.DEVICE_FLOPS == 100e12


def test_fit_module_reexports_the_references_names(J):
    from repro_torch import fit as tfit
    assert tfit.__all__ == J.fit.__all__
    for name in tfit.__all__:
        assert hasattr(tfit, name), name


def test_pipeline_costs_copy_matches_its_original(J):
    assert _defs(costs, ("device_flops",)) == \
        _defs(J.costs, ("device_flops",))
    assert costs.DEVICE_FLOPS == J.costs.DEVICE_FLOPS


# ---------------------------------------------------------------------------
# the drift report
# ---------------------------------------------------------------------------

def test_drift_report_rows_and_predictions_are_the_references(J, tmp_path,
                                                              capsys):
    """``drift_report`` and ``session_drift_report`` on the same
    predictions and summary give the reference's rows and table;
    ``plan_predictions`` reads the planner's step seconds and the
    footprints' calibrated peak; the CLI gate exits 1 on a flagged row
    and 0 when it is waived."""
    pred = {"step_time_s": 0.5, "peak_bytes": 4e9, "bubble_fraction": 0.2}
    meas = {"step_time_s": 1.7, "peak_bytes": 4.3e9, "other": 1.0}
    got = report.drift_report(pred, meas)
    want = J.report.drift_report(pred, meas)
    assert got.to_dict() == want.to_dict() and got.table() == want.table()
    cfg, jcfg = get_config("qwen2-0.5b"), J.get_config("qwen2-0.5b")
    mesh = SimpleNamespace(shape={"data": 2, "model": 2})
    fps = memory.footprints_for_mesh(cfg, mesh, global_batch=4, seq_len=512)
    jfps = J.memory.footprints_for_mesh(jcfg, mesh, global_batch=4,
                                        seq_len=512)
    common = dict(mesh=mesh, global_batch=4, seq_len=512,
                  num_microbatches=1, schedule="gpipe", pipeline=None)
    plan = SimpleNamespace(cfg=cfg, footprints=fps, **common)
    jplan = SimpleNamespace(cfg=jcfg, footprints=jfps, **common)
    assert report.plan_predictions(plan) == J.report.plan_predictions(jplan)
    summary = {"metrics": {"histograms": {report.MEASURED_STEP_HISTOGRAM: {
        "count": 3, "p50": 2.0}}, "gauges": {
        report.MEASURED_PEAK_GAUGE: 3.9e9}}}
    got = report.session_drift_report(plan, summary)
    want = J.report.session_drift_report(jplan, summary)
    assert got.to_dict() == want.to_dict()
    assert [r.name for r in got.rows] == ["peak_bytes", "step_time_s"]
    snap = tmp_path / "BENCH.json"
    snap.write_text(json.dumps({"meta": {"drift": got.to_dict()}}))
    assert report.main([str(snap)]) == 1
    assert report.main([str(snap), "--waive", "step_time_s", "--waive",
                        "peak_bytes"]) == 0
    assert "waived: step_time_s" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# refusals: errors, the registry, the Session's verdict
# ---------------------------------------------------------------------------

def test_plan_memory_error_messages_are_the_references(J):
    cfg, jcfg = get_config("gemma3-27b"), J.get_config("gemma3-27b")
    mesh = SimpleNamespace(shape={"data": 1, "model": 1})
    fps = memory.footprints_for_mesh(cfg, mesh, global_batch=2, seq_len=512)
    jfps = J.memory.footprints_for_mesh(jcfg, mesh, global_batch=2,
                                        seq_len=512)
    b, jb = memory.HBM_BUDGETS["h100"], J.memory.HBM_BUDGETS["h100"]
    _, refused = planner.score_hybrid_candidates(
        cfg, 1, global_batch=2, seq_len=512, hbm_budget=b,
        return_refused=True)
    _, jrefused = J.planner.score_hybrid_candidates(
        jcfg, 1, global_batch=2, seq_len=512, hbm_budget=jb,
        return_refused=True)
    assert refused == jrefused and len(refused) == 1
    for r in (None, refused):
        e = PlanMemoryError.for_cell(fps, b, refused=r)
        je = J.errors.PlanMemoryError.for_cell(jfps, jb, refused=r)
        assert str(e) == str(je)
        assert e.refused == je.refused and len(e.footprints) == 1
    e = PlanMemoryError.all_refused(refused, b, 1)
    assert str(e) == str(J.errors.PlanMemoryError.all_refused(refused, jb, 1))
    assert PlanMemoryError.format_refusals(refused) == \
        J.errors.PlanMemoryError.format_refusals(refused)


def test_state_registry_refuses_as_the_references(J):
    """A put or an update past the aggregate capacity raises with the
    reference's message; a put that fits, ``evict`` and ``report``
    account the same bytes."""
    import jax.numpy as jnp
    budget = memory.MemoryBudget(4096, platform="tiny")
    jbudget = J.memory.MemoryBudget(4096, platform="tiny")
    reg = StateRegistry(budget, n_devices=2)
    jreg = J.state.StateRegistry(jbudget, n_devices=2)
    assert reg.capacity == jreg.capacity == 7372
    a, ja = {"w": torch.zeros(1000)}, {"w": jnp.zeros(1000)}
    big, jbig = {"w": torch.zeros(1000), "b": torch.zeros(900)}, \
        {"w": jnp.zeros(1000), "b": jnp.zeros(900)}
    reg.put("a", a)
    jreg.put("a", ja)
    for fn, jfn, args, jargs in (
            (reg.put, jreg.put, ("b", big), ("b", jbig)),
            (reg.update, jreg.update, ("a", {"w": torch.zeros(2000)}),
             ("a", {"w": jnp.zeros(2000)}))):
        with pytest.raises(PlanMemoryError) as e:
            fn(*args)
        with pytest.raises(J.errors.PlanMemoryError) as je:
            jfn(*jargs)
        assert str(e.value) == str(je.value)
    assert reg.footprint() == jreg.footprint() == {"a": 4000}
    assert reg.report() == jreg.report()
    assert reg["a"] is a and reg.evict("a") is a and len(reg) == 0
    with pytest.raises(KeyError):
        reg.update("a", a)


def test_session_refuses_gemma3_27b_on_one_rank_before_building(J,
                                                                monkeypatch):
    """gemma3-27b training on one rank at 2 x 512 tokens needs 479.2 GiB
    per device against the h100 budget's 72.0 usable: ``Session.plan``
    raises ``PlanMemoryError`` with the reference's message, before a
    model is built (``Model`` is never called)."""
    import repro_torch.api.session as sess_mod

    def no_model(*a, **k):
        raise AssertionError("the verdict must come before the model")

    monkeypatch.setattr(sess_mod, "Model", no_model)
    sess = Session(device="cpu", hbm_gib=80)
    assert sess.budget.usable / 2**30 == 72.0
    with pytest.raises(PlanMemoryError) as e:
        sess.plan("gemma3-27b", batch=2, seq=512)
    peak = memory.peak_stage_footprint(e.value.footprints).total / 2**30
    assert round(peak, 1) == 479.2
    with pytest.raises(J.errors.PlanMemoryError) as je:
        J.Session(hbm_gib=80).plan("gemma3-27b", batch=2, seq=512,
                                   comms="off")
    assert str(e.value) == str(je.value)
    assert e.value.refused == je.value.refused


def test_session_sweep_scores_are_the_references(J):
    """``sweep=True`` attaches the planner's scores (one rank: the one
    factorization) and refusals, and the footprints and budget; the
    plan's predictions are the reference's."""
    sess = Session(device="cpu")
    plan = sess.plan("qwen2-0.5b", batch=4, seq=64, scale_down=16,
                     sweep=True)
    jplan = J.Session().plan("qwen2-0.5b", batch=4, seq=64, scale_down=16,
                             sweep=True, comms="off")
    assert plan.scores == jplan.scores and plan.refused == jplan.refused
    assert [_fields(f) for f in plan.footprints] == \
        [_fields(f) for f in jplan.footprints]
    assert plan.budget == memory.HBM_BUDGETS["cpu"] and plan.fits()
    assert report.plan_predictions(plan) == \
        J.report.plan_predictions(jplan)
    assert math.isfinite(next(iter(plan.scores.values())))
    with pytest.raises(PlanMemoryError, match="all candidates refused"):
        Session(device="cpu", hbm_gib=0.01).plan(
            "qwen2-0.5b", batch=4, seq=64, scale_down=16, sweep=True)
