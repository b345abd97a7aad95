"""The port's fault injection and resilient control loops against the JAX
reference's (``repro.faults``, ``repro.train.resilience``).

- The reference's fast cases of ``tests/test_faults.py`` (the seams, the
  ``FaultPlan``, the watchdog's guards, ``StepAbort``, deadline shedding,
  the preempt-cycle bound, checkpoint crash consistency), each run on
  both packages.  ``faults/inject.py`` and ``train/watchdog.py`` import
  no framework: the port's are copies, pinned to the originals.
- The Session's host snapshot is a copy: a step, which updates the state
  in place, leaves it as it was, and a restore copies it back.
- The port's ``ResilientStepLoop`` and ``ElasticRunner`` against the
  reference's under the same ``FaultPlan``: the reference's loop is
  driven over an adapter whose ``step`` is its gspmd train step on a
  one-device mesh, as ``tests/test_torch_train.py`` runs it (its
  ``Session.step`` fails under this JAX on a nested ``shard_map``).
  Both train the same tiny dense model (the reference drill's config)
  from the same weights (``from_jax``) on the same ``SyntheticLM``
  batches.  The skipped steps, the restart records (all but their
  seconds), the ``resil.*`` counters and the plan's firings must be the
  same; the losses within rtol 1e-3 of the reference's
  (``test_torch_train``'s rule for a trajectory of steps, whose
  updates round apart);
  and the port's losses must equal its own no-fault run's bit for bit
  wherever the fault was recovered.  The restart driver's watchdog sees
  10 ms for every step (its own guards are tested above), and at an
  injected straggler 10 ms plus the delay, but only where the step's
  measured wall time shows the seam's sleep ran (else 10 ms, so a dead
  seam fails the case): no case depends on how loaded this machine is.
- ``arm_engine``'s pool storm on both packages' ``ContinuousEngine``:
  the same preemptions and sheds, and the admitted requests' tokens
  bitwise a storm-free run's in each package.
- Two gloo ranks: the ``comms.sync_tree`` seam fires once on both ranks
  and the retried step runs clean (bitwise the fault-free run's), and a
  ``checkpoint.torn`` crash on a (2,1) mesh restarts on a (1,1)
  subgroup, whose steps equal bitwise those of a one-rank run restored
  from the same snapshot.
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

from repro_torch import faults as tfaults  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.api import Session  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.faults import inject as tinject  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.params import from_jax  # noqa: E402
from repro_torch.serve import (AdmissionRefusal, BlockManager,  # noqa: E402
                               ContinuousEngine, DeadlineExceeded, Request,
                               Scheduler)
from repro_torch.train import (ElasticRunner, ResilienceConfig,  # noqa: E402
                               ResilientStepLoop, StepAbort,
                               StepTimeWatchdog)
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import watchdog as twatchdog  # noqa: E402

from test_torch_kernels import _defs  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
FIELDS = dict(name="faults-tiny", family="dense", n_layers=2, d_model=32,
              n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64, vocab_size=128)
TINY = ModelConfig(**FIELDS)
B, SEQ, STEPS, EVERY = 4, 16, 8, 2
PEAK, WARMUP = 3e-3, 2
COUNTERS = ("resil.retries", "resil.nonfinite", "resil.rollbacks",
            "resil.anomalies", "resil.aborts", "resil.skipped_steps",
            "resil.torn_checkpoints")


# ---------------------------------------------------------------------------
# both packages' pieces
# ---------------------------------------------------------------------------

def _port_pkg():
    return SimpleNamespace(
        faults=tfaults, StepAbort=StepAbort, StepTimeWatchdog=StepTimeWatchdog,
        BlockManager=BlockManager, Scheduler=Scheduler, Request=Request,
        AdmissionRefusal=AdmissionRefusal, DeadlineExceeded=DeadlineExceeded,
        CheckpointManager=CheckpointManager, cfg=TINY)


def _reference_pkg():
    pytest.importorskip("jax")
    import repro  # noqa: F401  (installs the JAX compat shims)
    from repro import faults
    from repro.checkpoint import CheckpointManager as JCkpt
    from repro.configs.base import ModelConfig as JModelConfig
    from repro.serve import AdmissionRefusal as JRefusal
    from repro.serve import BlockManager as JBlocks
    from repro.serve import Request as JRequest
    from repro.serve import Scheduler as JScheduler
    from repro.serve.scheduler import DeadlineExceeded as JDeadline
    from repro.train import StepAbort as JAbort
    from repro.train import StepTimeWatchdog as JDog
    return SimpleNamespace(
        faults=faults, StepAbort=JAbort, StepTimeWatchdog=JDog,
        BlockManager=JBlocks, Scheduler=JScheduler, Request=JRequest,
        AdmissionRefusal=JRefusal, DeadlineExceeded=JDeadline,
        CheckpointManager=JCkpt, cfg=JModelConfig(**FIELDS))


@pytest.fixture(params=["port", "reference"])
def pkg(request):
    return _port_pkg() if request.param == "port" else _reference_pkg()


# ---------------------------------------------------------------------------
# the reference's unit cases, on both packages
# ---------------------------------------------------------------------------

def test_fault_spec_rejects_unknown_seam(pkg):
    with pytest.raises(ValueError, match="unknown fault seam"):
        pkg.faults.FaultSpec("train.gremlin")


def test_fire_consumes_count_at_exact_step(pkg):
    F = pkg.faults
    plan = F.FaultPlan([F.FaultSpec("train.nonfinite", step=3, count=2)])
    assert plan.fire("train.nonfinite", 2) is None      # wrong step
    assert plan.fire("train.straggler", 3) is None      # wrong seam
    assert plan.fire("train.nonfinite", 3) is not None
    assert plan.fire("train.nonfinite", 3) is not None
    assert plan.fire("train.nonfinite", 3) is None      # budget consumed
    assert (plan.injected(), plan.pending()) == (2, 0)
    assert plan.summary()["train.nonfinite"] == \
        {"planned": 2, "injected": 2, "pending": 0}
    assert [f["step"] for f in plan.fired] == [3, 3]


def test_step_none_matches_any_consultation(pkg):
    F = pkg.faults
    plan = F.FaultPlan([F.FaultSpec("comms.sync_tree")])
    assert plan.fire("comms.sync_tree", 17) is not None
    assert plan.fire("comms.sync_tree") is None


def test_random_plan_is_seed_deterministic(pkg):
    a = pkg.faults.FaultPlan.random(seed=11, steps=20)
    b = pkg.faults.FaultPlan.random(seed=11, steps=20)
    assert a.specs == b.specs
    assert all(0 < s.step < 20 for s in a.specs)


def test_trace_seam_fires_once_then_retraces_clean(pkg):
    F = pkg.faults
    plan = F.FaultPlan([F.FaultSpec("comms.sync_tree")])
    prev = F.set_active(plan)
    try:
        with pytest.raises(F.CollectiveTimeout):
            F.trace_seam("comms.sync_tree")
        F.trace_seam("comms.sync_tree")      # disarmed: the clean retry
    finally:
        assert F.set_active(prev) is plan    # returns what we installed
    assert plan.injected("comms.sync_tree") == 1


def test_trace_seam_is_inert_without_active_plan(pkg):
    prev = pkg.faults.set_active(None)
    try:
        pkg.faults.trace_seam("comms.sync_tree")   # no plan: must not raise
    finally:
        pkg.faults.set_active(prev)


def test_watchdog_drops_nonfinite_and_nonpositive_dt(pkg):
    dog = pkg.StepTimeWatchdog(warmup_steps=2)
    for bad in (float("inf"), float("nan"), 0.0, -0.5):
        assert dog.observe(0, bad) is None
    assert (dog.n, dog.ignored) == (0, 4)    # estimator untouched
    dog.observe(1, 0.01)
    assert dog.n == 1 and dog.mean == pytest.approx(0.01)


def test_watchdog_flags_straggler_and_reset_keeps_hook(pkg):
    seen = []
    dog = pkg.StepTimeWatchdog(warmup_steps=3, z_threshold=4.0,
                               on_anomaly=lambda s, dt, msg: seen.append(s))
    for i in range(8):
        assert dog.observe(i, 0.010 + 0.0001 * (i % 2)) is None
    msg = dog.observe(8, 1.0)
    assert msg is not None and "straggler" in msg
    assert dog.anomalies == [8] and seen == [8]
    dog.reset()
    assert (dog.n, dog.mean, dog.var, dog.ignored, dog.anomalies) \
        == (0, 0.0, 0.0, 0, [])
    assert dog.on_anomaly is not None        # reset forgets stats, not wiring


def test_step_abort_carries_structured_fields(pkg):
    e = pkg.StepAbort("watchdog_escalation", step=7, checkpoint_step=8,
                      detail="3 anomalies")
    assert (e.reason, e.step, e.checkpoint_step) \
        == ("watchdog_escalation", 7, 8)
    assert "checkpoint at step 8" in str(e)


def _sched(pkg, **kw):
    blocks = pkg.BlockManager(pkg.cfg, num_pages=9, page_size=8, max_seq=64)
    return pkg.Scheduler(blocks, **kw)


def test_shed_expired_is_structured_and_spares_admitted(pkg):
    sched = _sched(pkg)
    R = pkg.Request
    doomed = R(rid=1, prompt=np.zeros(8, np.int32), max_new_tokens=8,
               deadline_s=1e-9)
    patient = R(rid=2, prompt=np.zeros(8, np.int32), max_new_tokens=8)
    running = R(rid=3, prompt=np.zeros(8, np.int32), max_new_tokens=8,
                deadline_s=1e-9)
    for r in (doomed, patient, running):
        sched.submit(r)
    running.admit_t = running.submit_t       # admission stops the clock
    shed = sched.shed_expired()
    assert [r.rid for r in shed] == [1] and sched.shed == shed
    ref = doomed.refusal
    assert isinstance(ref, pkg.DeadlineExceeded) and ref.reason == "deadline"
    assert ref.waited_s > ref.deadline_s and doomed.done
    assert ref.to_dict()["rid"] == 1 and "deadline" in ref.describe()
    assert [r.rid for r in sched.queue] == [2, 3]        # never silently lost


def test_preempt_cycle_converts_to_permanent_refusal(pkg):
    sched = _sched(pkg, max_preempt_restarts=2)
    req = pkg.Request(rid=9, prompt=np.zeros(8, np.int32), max_new_tokens=8)
    sched.submit(req)
    sched.queue.remove(req)                  # "admit" it
    assert sched.requeue_preempted(req) is None
    assert sched.queue[0] is req             # requeued at the FRONT
    sched.queue.remove(req)
    assert sched.requeue_preempted(req) is None
    sched.queue.remove(req)
    ref = sched.requeue_preempted(req)       # third strike: permanent
    assert isinstance(ref, pkg.AdmissionRefusal)
    assert ref.reason == "preempt_cycle" and req.done
    assert req in sched.refused and req not in sched.queue
    assert req.n_preempted == 3


def _state(v: float):
    return {"params": {"w": np.full((4, 4), v, np.float32)},
            "opt": {"step": np.int32(int(v))}}


def test_restore_walks_back_past_torn_snapshot(pkg, tmp_path):
    mgr = pkg.CheckpointManager(str(tmp_path))
    mgr.save(3, _state(3.0), blocking=True)
    pkg.faults.write_torn_checkpoint(mgr, 6, _state(6.0))
    assert mgr.latest_step() == 6            # the pointer trusts the torn one
    assert "torn" in mgr.validate(6)
    assert mgr.valid_steps() == [3]
    restored = mgr.restore()                 # walks back instead of crashing
    np.testing.assert_array_equal(np.asarray(restored["params"]["w"]),
                                  _state(3.0)["params"]["w"])
    with pytest.raises(FileNotFoundError, match="not restorable"):
        mgr.restore(step=6)                  # explicit ask: loud failure


def test_restore_survives_garbage_latest_pointer(pkg, tmp_path):
    mgr = pkg.CheckpointManager(str(tmp_path))
    mgr.save(2, _state(2.0), blocking=True)
    with open(os.path.join(str(tmp_path), "LATEST"), "w") as f:
        f.write("not-a-step")
    assert mgr.latest_step() is None
    restored = mgr.restore()
    np.testing.assert_array_equal(np.asarray(restored["params"]["w"]),
                                  _state(2.0)["params"]["w"])


def test_validate_catches_missing_and_empty_leaves(pkg, tmp_path):
    mgr = pkg.CheckpointManager(str(tmp_path))
    mgr.save(1, _state(1.0), blocking=True)
    leaf = os.path.join(str(tmp_path), "step_1", "params__w.npy")
    os.truncate(leaf, 0)
    assert "truncated" in mgr.validate(1)
    os.remove(leaf)
    assert "missing" in mgr.validate(1)
    assert mgr.valid_steps() == [] and mgr.restore() is None


# ---------------------------------------------------------------------------
# the copies, pinned
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["inject", "watchdog", "package"])
def test_copied_modules_match_their_originals(name):
    _reference_pkg()
    from repro import faults as jfaults
    from repro.faults import inject as jinject
    from repro.train import watchdog as jwatchdog
    if name == "package":
        assert tfaults.__all__ == jfaults.__all__
        assert tinject.SEAMS == jinject.SEAMS
        return
    got, want = {"inject": (tinject, jinject),
                 "watchdog": (twatchdog, jwatchdog)}[name]
    assert _defs(got) == _defs(want)


# ---------------------------------------------------------------------------
# the Session's snapshot
# ---------------------------------------------------------------------------

def _adamw():
    return topt.AdamWConfig(lr=topt.warmup_cosine(PEAK, WARMUP, STEPS))


def _data(pkg_synthetic=SyntheticLM):
    return pkg_synthetic(TINY.vocab_size, B, SEQ, seed=0, structured=True)


def _tree_equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_equal(a[k], b[k])
                                            for k in a)
    return torch.equal(a.detach().cpu(), b.detach().cpu())


def test_snapshot_is_a_copy_that_a_step_leaves_alone():
    """AdamW updates the state in place, and on the CPU ``.cpu()`` is the
    tensor itself: an aliased snapshot would follow the step and make a
    rollback a silent no-op."""
    sess = Session(device="cpu")
    plan = sess.plan(TINY, batch=B, seq=SEQ, comms="off", adamw=_adamw())
    sess.init_state(plan, seed=0)
    data = iter(_data())
    sess.step(plan, next(data))
    assert sess.last_step_compiled
    snap = sess.snapshot_state()
    again = sess.snapshot_state()
    assert _tree_equal(snap, sess.get("train_state"))
    sess.step(plan, next(data))
    assert not sess.last_step_compiled
    assert _tree_equal(snap, again)                   # the step left it
    assert not _tree_equal(snap, sess.get("train_state"))
    sess.restore_state(snap)
    assert _tree_equal(sess.get("train_state"), snap)
    assert all(p.requires_grad
               for p in sess.get("train_state")["params"].values())
    sess.step(plan, next(data))                       # restored: a copy too
    assert _tree_equal(snap, again)


# ---------------------------------------------------------------------------
# the loops, against the reference's
# ---------------------------------------------------------------------------

def _fixed_dog(dog_cls, stragglers):
    """A watchdog factory of either package whose dog sees 10 ms for
    every step, plus the injected delay on the ``stragglers`` (step ->
    seconds) where the measured ``dt`` shows that the delay ran (else 10
    ms too, so a seam that did not fire escalates nothing): the cases do
    not depend on this machine's load.  (A straggler step's own
    wall time under a loaded machine once took the second straggler's
    z-score under the threshold, and no escalation came.)"""
    class Fixed(dog_cls):
        def observe(self, step, dt):
            m = stragglers.get(step, 0.0)
            return super().observe(step, 0.01 + (m if dt >= m else 0.0))
    return lambda: Fixed(warmup_steps=3)


@pytest.fixture(scope="module")
def R():
    """The reference's loop pieces, its tiny model's init (numpy) and
    one jitted gspmd step shared by every adapter session."""
    pytest.importorskip("jax")
    import repro  # noqa: F401
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro import obs as jobs
    from repro.api.session import Session as JSession
    from repro.api.session import dispatch_train_step
    from repro.checkpoint import CheckpointManager as JCkpt
    from repro.core.planner import plan_for
    from repro.data import SyntheticLM as JSynthetic
    from repro.launch.mesh import make_mesh
    from repro.models import Model as JModel
    from repro.train import optimizer as jopt
    from repro.train import resilience as jres
    pkg = _reference_pkg()
    mesh = make_mesh((1, 1), ("data", "model"))
    with jax.set_mesh(mesh):
        model = JModel(pkg.cfg, mesh, plan_for(pkg.cfg, mesh))
        params = jax.tree.map(np.asarray,
                              model.init(jax.random.PRNGKey(0)))
        adamw = jopt.AdamWConfig(lr=jopt.warmup_cosine(PEAK, WARMUP, STEPS))
        step = jax.jit(dispatch_train_step(model, mesh, adamw=adamw,
                                           num_microbatches=1,
                                           path="gspmd"))
    return SimpleNamespace(
        jax=jax, jnp=jnp, P=P, NamedSharding=NamedSharding, obs=jobs,
        JSession=JSession, JCkpt=JCkpt, JSynthetic=JSynthetic, mesh=mesh,
        model=model, params=params, step=step, opt=jopt, res=jres, pkg=pkg)


class _Registry(dict):
    def get(self, name):
        return self[name]

    def update(self, name, value):
        self[name] = value

    def put(self, name, value, kind="state"):
        self[name] = value


class _RefSession:
    """The reference loop's view of a session: its gspmd step on a
    one-device mesh, its Session's own ``snapshot_state`` and
    ``restore_state``."""

    def __init__(self, R, obs):
        self.R, self.obs, self.mesh = R, obs, R.mesh
        self.state = _Registry()
        self.last_step_compiled = False

    def init_state(self, plan, seed=0, name="train_state"):
        R = self.R
        params = R.jax.tree.map(R.jnp.asarray, R.params)
        self.state[name] = {"params": params, "opt": R.opt.init_state(
            params, R.model.param_specs(), R.mesh)}

    def get(self, name):
        return self.state[name]

    def step(self, plan, batch, name="train_state"):
        # a step that compiles (the first, or a re-specialization for
        # restored inputs) is the reference Session's compiled step
        n0 = self.R.step._cache_size()
        state, m = self.R.step(self.state[name], batch)
        self.state[name] = state
        self.last_step_compiled = self.R.step._cache_size() > n0
        return m

    def snapshot_state(self, name="train_state"):
        return self.R.JSession.snapshot_state(self, name)

    def restore_state(self, snapshot, *, shardings=None,
                      name="train_state"):
        return self.R.JSession.restore_state(self, snapshot,
                                             shardings=shardings, name=name)


class _RefPlan:
    def __init__(self, R):
        self.R = R

    def state_shardings(self):
        R = self.R
        with R.jax.set_mesh(R.mesh):
            params = R.jax.tree.map(R.jnp.asarray, R.params)
            tmpl = {"params": params, "opt": R.opt.init_state(
                params, R.model.param_specs(), R.mesh)}
        return R.jax.tree.map(lambda _: R.NamedSharding(R.mesh, R.P()), tmpl)


def _port_session_factory(R, obs):
    """(session, plan) on the reference's weights: the runner's
    ``init_state(plan, seed=)`` takes them."""
    p0 = from_jax(R.params)

    class Seeded(Session):
        def init_state(self, plan, *, seed=0, name="train_state",
                       params=None):
            return super().init_state(plan, seed=seed, name=name,
                                      params=p0 if params is None else params)

    def factory(attempt):
        sess = Seeded(device="cpu", obs=obs)
        return sess, sess.plan(TINY, batch=B, seq=SEQ, comms="off",
                               adamw=_adamw())
    return factory


def _ref_session_factory(R, obs):
    return lambda attempt: (_RefSession(R, obs), _RefPlan(R))


def _run(side, R, specs, tmp, *, elastic, cfg_kw):
    """One case on one package: (result, counters, fired)."""
    if side == "port":
        F, obs = tfaults, tobs.Obs(name="test/faults")
        factory, data = _port_session_factory(R, obs), _data
        loop_cls, runner_cls, ckpt_cls = (ResilientStepLoop, ElasticRunner,
                                          CheckpointManager)
        config, dog_cls = ResilienceConfig(**cfg_kw), StepTimeWatchdog
    else:
        F, obs = R.pkg.faults, R.obs.Obs(name="test/faults")
        factory = _ref_session_factory(R, obs)
        data = lambda: _data(R.JSynthetic)  # noqa: E731
        loop_cls, runner_cls, ckpt_cls = (R.res.ResilientStepLoop,
                                          R.res.ElasticRunner, R.JCkpt)
        config, dog_cls = R.res.ResilienceConfig(**cfg_kw), R.pkg.\
            StepTimeWatchdog
    faults = F.FaultPlan([F.FaultSpec(**s) for s in specs], seed=0) \
        if specs else None
    with R.jax.set_mesh(R.mesh):
        if elastic:
            runner = runner_cls(
                factory, data, ckpt=ckpt_cls(str(tmp / side)), steps=STEPS,
                ckpt_every=EVERY, config=config, faults=faults, seed=0,
                watchdog_factory=_fixed_dog(dog_cls, {
                    s["step"]: s["magnitude"] for s in specs
                    if s["seam"] == "train.straggler"}))
            out = runner.run()
        else:
            sess, plan = factory(0)
            sess.init_state(plan, seed=0)
            loop = loop_cls(sess, plan, faults=faults, config=config)
            out = loop.run(iter(data()), start_step=0, steps=STEPS)
    counters = {k: obs.counter(k).value for k in COUNTERS}
    fired = faults.fired if faults is not None else []
    return out, counters, fired


CASES = {
    "rollback_and_retry": dict(specs=[
        dict(seam="train.nonfinite", step=2),
        dict(seam="comms.timeout", step=3)], elastic=False, recovered=True),
    "persistent_nonfinite_skips": dict(specs=[
        dict(seam="train.nonfinite", step=2, count=2)], elastic=False,
        recovered=False),
    "torn_checkpoint_restart": dict(specs=[
        dict(seam="checkpoint.torn", step=6)], elastic=True, recovered=True),
    "timeout_abort_restart": dict(specs=[
        dict(seam="comms.timeout", step=3, count=2)], elastic=True,
        recovered=True, cfg_kw=dict(max_retries=1)),
    "straggler_escalation_restart": dict(specs=[
        dict(seam="train.straggler", step=5, magnitude=0.6),
        dict(seam="train.straggler", step=6, magnitude=1.2)], elastic=True,
        recovered=True, cfg_kw=dict(anomaly_window=8, anomaly_limit=2)),
}


@pytest.fixture(scope="module")
def oracle(R, tmp_path_factory):
    """The port's and the reference's no-fault runs."""
    tmp = tmp_path_factory.mktemp("oracle")
    kw = dict(elastic=False, cfg_kw=dict(backoff_base_s=0.01))
    return {side: _run(side, R, [], tmp, **kw)[0]["losses"]
            for side in ("port", "reference")}


@pytest.mark.parametrize("case", list(CASES))
def test_loop_recovers_as_the_reference_does(R, oracle, tmp_path, case):
    c = CASES[case]
    cfg_kw = dict(dict(backoff_base_s=0.01), **c.get("cfg_kw", {}))
    runs = {side: _run(side, R, c["specs"], tmp_path, elastic=c["elastic"],
                       cfg_kw=cfg_kw)
            for side in ("port", "reference")}
    (got, gc, gf), (want, wc, wf) = runs["port"], runs["reference"]
    assert gc == wc and gf == wf
    assert got["skipped"] == want["skipped"]
    assert sorted(got["losses"]) == sorted(want["losses"])
    for i, v in want["losses"].items():
        np.testing.assert_allclose(got["losses"][i], v, rtol=1e-3)
    if c["elastic"]:
        strip = [{k: v for k, v in r.items() if k != "recovery_s"}
                 for r in got["restarts"]]
        assert strip == [{k: v for k, v in r.items() if k != "recovery_s"}
                         for r in want["restarts"]]
        assert got["attempts"] == want["attempts"] == 2
        assert all(r["recovery_s"] > 0 for r in got["restarts"])
    if c["recovered"]:
        assert got["losses"] == oracle["port"]           # bitwise
        assert got["skipped"] == []
    else:
        assert got["skipped"] == [2]
        assert {i: v for i, v in got["losses"].items() if i < 2} == \
            {i: v for i, v in oracle["port"].items() if i < 2}
    for i, v in oracle["reference"].items():
        np.testing.assert_allclose(oracle["port"][i], v, rtol=1e-3)


def test_case_records_are_the_drill_contract(R, tmp_path):
    """What each case exercises, on the port alone: the torn label is
    walked back past, a timeout abort checkpoints at its step, the
    straggler burst escalates with an early checkpoint."""
    recs = {}
    for case in ("torn_checkpoint_restart", "timeout_abort_restart",
                 "straggler_escalation_restart"):
        c = CASES[case]
        cfg_kw = dict(dict(backoff_base_s=0.01), **c.get("cfg_kw", {}))
        out, counters, _ = _run("port", R, c["specs"], tmp_path / case,
                                elastic=True, cfg_kw=cfg_kw)
        recs[case] = (out["restarts"][0], counters)
    rec, counters = recs["torn_checkpoint_restart"]
    assert (rec["reason"], rec["abort_step"], rec["restored_step"],
            rec["steps_lost"]) == ("checkpoint.torn", 6, 4, 2)
    assert counters["resil.torn_checkpoints"] == 1
    rec, counters = recs["timeout_abort_restart"]
    assert (rec["reason"], rec["checkpoint_step"], rec["restored_step"]) \
        == ("collective_timeout", 3, 3)
    assert counters["resil.retries"] == 2 and counters["resil.aborts"] == 1
    rec, counters = recs["straggler_escalation_restart"]
    assert (rec["reason"], rec["abort_step"], rec["checkpoint_step"],
            rec["restored_step"], rec["steps_lost"]) == \
        ("watchdog_escalation", 6, 7, 7, 0)
    assert counters["resil.anomalies"] == 2


# ---------------------------------------------------------------------------
# serve: a pool storm on both packages' engines
# ---------------------------------------------------------------------------

STORM = dict(seam="serve.pool_storm", step=4, magnitude=12, duration=6)


def _storm_requests(R_cls, vocab, expired: bool):
    rng = np.random.default_rng(5)
    out = [R_cls(rid=r, prompt=rng.integers(0, vocab, 8, dtype=np.int32),
                 max_new_tokens=20) for r in range(3)]
    if expired:
        out += [R_cls(rid=100 + i, prompt=np.zeros(8, np.int32),
                      max_new_tokens=6, deadline_s=1e-9) for i in range(2)]
    return out


def _storm_record(eng, reqs, F, storm: bool):
    if storm:
        F.arm_engine(F.FaultPlan([F.FaultSpec(**STORM)]), eng)
    for r in reqs:
        eng.submit(r)
    eng.run()
    return dict(tokens={r.rid: list(r.out) for r in eng.finished},
                preempted={r.rid: r.n_preempted for r in reqs},
                shed=sorted(r.rid for r in eng.shed),
                shed_reasons=[r.refusal.reason for r in eng.shed],
                finished=[r.rid for r in eng.finished])


def test_pool_storm_preempts_and_sheds_as_the_reference(R):
    kw = dict(batch_slots=2, max_seq=64, page_size=8, prefill_chunk=8)
    model = Model(TINY, device="cpu")
    params = from_jax(R.params)
    port = {storm: _storm_record(
        ContinuousEngine(model, params, **kw),
        _storm_requests(Request, TINY.vocab_size, storm), tfaults, storm)
        for storm in (False, True)}
    from repro.serve import ContinuousEngine as JEngine
    with R.jax.set_mesh(R.mesh):
        jparams = R.jax.tree.map(R.jnp.asarray, R.params)
        ref = {storm: _storm_record(
            JEngine(R.model, jparams, **kw),
            _storm_requests(R.pkg.Request, TINY.vocab_size, storm),
            R.pkg.faults, storm) for storm in (False, True)}
    for side in (port, ref):
        assert sum(side[True]["preempted"].values()) >= 1
        assert side[True]["shed"] == [100, 101]
        assert side[True]["shed_reasons"] == ["deadline"] * 2
        assert side[True]["tokens"] == side[False]["tokens"]   # bitwise
    for k in ("preempted", "shed", "finished"):
        assert port[True][k] == ref[True][k], k


# ---------------------------------------------------------------------------
# two gloo ranks: the sync_tree seam and an elastic restart on a subgroup
# ---------------------------------------------------------------------------

_RANK = textwrap.dedent("""
    import json, sys
    import torch
    import torch.distributed as dist
    from repro_torch import faults as F
    from repro_torch import obs as obs_mod
    from repro_torch.api import Session
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core.distributed import Mesh, close_group, init_group
    from repro_torch.data import SyntheticLM
    from repro_torch.train import ElasticRunner, ResilienceConfig, \\
        ResilientStepLoop
    from repro_torch.train import optimizer as opt
    from repro_torch.train.resilience import StateCheckpoints
    rank, init, ckdir, dst = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                              sys.argv[4])
    init_group(init, rank=rank, world_size=2, device="cpu")
    cfg = ModelConfig(**json.loads(sys.argv[5]))
    B, SEQ, STEPS = 4, 16, 6
    world = dist.group.WORLD
    sub = dist.new_group([0])          # collective: every rank makes it
    def data():
        return SyntheticLM(cfg.vocab_size, B, SEQ, seed=0, structured=True)
    def session(group, mesh, obs=None, comms="off"):
        sess = Session(device="cpu", group=group, mesh=mesh, obs=obs)
        return sess, sess.plan(cfg, batch=B, seq=SEQ, comms=comms,
                               adamw=opt.AdamWConfig(
                                   lr=opt.warmup_cosine(3e-3, 2, STEPS)))
    rcfg = ResilienceConfig(backoff_base_s=0.01)
    out = {}
    # 1. the comms path on (2,1): the sync_tree seam fires once on both
    # ranks, the retried step runs clean
    for armed in (False, True):
        obs = obs_mod.Obs(name="seam")
        sess, plan = session(world, None, obs, comms="auto")
        assert plan.path == "comms", plan.path
        sess.init_state(plan, seed=0)
        fp = F.FaultPlan([F.FaultSpec("comms.sync_tree")]) if armed else None
        prev = F.set_active(fp)
        try:
            res = ResilientStepLoop(sess, plan, config=rcfg).run(
                iter(data()), start_step=0, steps=3)
        finally:
            F.set_active(prev)
        out["seam_armed" if armed else "seam_clean"] = dict(
            losses=res["losses"],
            retries=obs.counter("resil.retries").value,
            injected=fp.injected() if fp else 0)
    # 2. a torn checkpoint on (2,1), the restart on a (1,1) subgroup
    mgr = CheckpointManager(ckdir)
    class Retired(Exception):
        pass
    def factory(attempt):
        if attempt == 0:
            return session(world, Mesh((2, 1), ("data", "model"), world))
        if rank != 0:
            raise Retired()
        return session(sub, Mesh((1, 1), ("data", "model"), sub))
    faults = F.FaultPlan([F.FaultSpec("checkpoint.torn", step=4)])
    runner = ElasticRunner(factory, data, ckpt=mgr, steps=STEPS,
                           ckpt_every=2, config=rcfg, faults=faults)
    try:
        res = runner.run()
    except Retired:
        res = None
    if rank == 0:
        rec = res["restarts"][0]
        # a one-rank run on the subgroup restored from the same snapshot
        sess, plan = session(sub, Mesh((1, 1), ("data", "model"), sub))
        start = rec["restored_step"]
        sess.restore_state(StateCheckpoints(mgr, sess, plan).restore(start))
        it = iter(data())
        for _ in range(start):
            next(it)
        alone = ResilientStepLoop(sess, plan, config=rcfg).run(
            it, start_step=start, steps=STEPS)
        out["elastic"] = dict(
            losses=res["losses"], restarts=[
                {k: v for k, v in r.items() if k != "recovery_s"}
                for r in res["restarts"]],
            alone=alone["losses"], valid=mgr.valid_steps(),
            plan_path=plan.path)
    with open(dst, "w") as f:
        json.dump(out, f)
    close_group()
""")


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("faults2")
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    init = f"file://{tmp / 'rendezvous'}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), init, str(tmp / "ckpt"),
         str(tmp / f"r{r}.json"), json.dumps(FIELDS)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    for p in procs:
        out = p.communicate(timeout=600)[0]
        assert p.returncode == 0, out[-3000:]
    return [json.loads((tmp / f"r{r}.json").read_text()) for r in range(2)]


def test_sync_tree_seam_fires_once_then_runs_clean(two_ranks):
    for r in two_ranks:
        armed, clean = r["seam_armed"], r["seam_clean"]
        assert (armed["injected"], armed["retries"]) == (1, 1)
        assert clean["retries"] == 0
        assert armed["losses"] == clean["losses"]       # bitwise
    assert two_ranks[0]["seam_armed"]["losses"] == \
        two_ranks[1]["seam_armed"]["losses"]


def test_torn_crash_on_two_ranks_restarts_on_a_one_rank_subgroup(two_ranks):
    e = two_ranks[0]["elastic"]
    assert "elastic" not in two_ranks[1]                 # retired
    rec, = e["restarts"]
    assert (rec["reason"], rec["abort_step"], rec["restored_step"],
            rec["mesh"]) == ("checkpoint.torn", 4, 2,
                             {"data": 1, "model": 1})
    assert e["valid"][-1] == 6
    start = rec["restored_step"]
    assert {k: v for k, v in e["losses"].items() if int(k) >= start} == \
        e["alone"]                                      # bitwise
    assert sorted(int(k) for k in e["losses"]) == list(range(6))
