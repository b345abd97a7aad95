"""The port's checkpoint manager against the reference's: one on-disk
format, read both ways bitwise.

A tiny qwen2 train state (bf16 params, fp32 moments and master, an int32
step) made by the reference's own init; the port's leaves come from
``from_jax`` of the same arrays.  The reference writes and the port
restores, the port writes and the reference validates and restores; the
files the two write for one state are the same bytes.  Then the
manager's own contract: a torn newest snapshot is walked back, ``keep``
collects the oldest, an async save lands after ``wait``.
"""

import filecmp
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import (CheckpointManager,  # noqa: E402
                                    state_from_tree, state_tree)
from repro_torch.configs import get_config, scale_config  # noqa: E402
from repro_torch.models.params import from_jax  # noqa: E402

CFG = scale_config(get_config("qwen2-0.5b"), 64)


@pytest.fixture(scope="module")
def J():
    pytest.importorskip("jax")
    import repro  # noqa: F401  (installs the JAX compat shims)
    import jax
    from repro.checkpoint import CheckpointManager as JManager
    from repro.core.planner import plan_for
    from repro.launch.mesh import make_mesh
    from repro.models import Model as JModel
    from repro.train import init_state
    mesh = make_mesh((1, 1), ("data", "model"))
    with jax.set_mesh(mesh):
        model = JModel(CFG, mesh, plan_for(CFG, mesh))
        st = init_state(model, mesh, jax.random.PRNGKey(0))
        state = jax.tree.map(np.asarray, {"params": st.params, "opt": st.opt})
    # moments and step as after some steps: values that are not zeros
    rng = np.random.default_rng(1)
    for k in ("mu", "nu"):
        state["opt"][k] = jax.tree.map(
            lambda a: rng.standard_normal(a.shape).astype(a.dtype),
            state["opt"][k])
    state["opt"]["step"] = np.asarray(7, np.int32)
    return jax, JManager, state


def _port_state(jstate):
    opt = jstate["opt"]
    return {"params": from_jax(jstate["params"]),
            "opt": {"step": torch.from_numpy(np.array(opt["step"])),
                    **{k: from_jax(opt[k]) for k in ("mu", "nu", "master")}}}


def _leaves(state):
    opt = state["opt"]
    out = {f"params.{n}": t for n, t in state["params"].items()}
    out["opt.step"] = opt["step"]
    for k in ("mu", "nu", "master"):
        out.update({f"opt.{k}.{n}": t for n, t in opt[k].items()})
    return out


def _bits(t):
    t = t.detach().cpu()
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _assert_bitwise(got, want):
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert torch.equal(_bits(got[name]), _bits(want[name])), name


def test_state_has_every_leaf_type(J):
    _, _, jstate = J
    dtypes = {t.dtype for t in _leaves(_port_state(jstate)).values()}
    assert dtypes == {torch.bfloat16, torch.float32, torch.int32}


def test_port_restores_what_the_reference_wrote(J, tmp_path):
    _, JManager, jstate = J
    JManager(str(tmp_path)).save(3, jstate, blocking=True)
    tree = CheckpointManager(str(tmp_path)).restore()
    _assert_bitwise(state_from_tree(tree), _port_state(jstate))
    assert tree["opt"]["step"].shape == ()


def test_reference_restores_what_the_port_wrote(J, tmp_path):
    jax, JManager, jstate = J
    CheckpointManager(str(tmp_path / "t")).save(
        3, state_tree(_port_state(jstate)), blocking=True)
    jm = JManager(str(tmp_path / "t"))
    assert jm.validate(3) is None and jm.valid_steps() == [3]
    back = jm.restore()
    got = jax.tree.map(np.asarray, back)
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_want = dict(jax.tree_util.tree_flatten_with_path(jstate)[0])
    assert len(flat_got) == len(flat_want)
    for path, a in flat_got:
        w = flat_want[path]
        assert a.dtype == w.dtype and a.shape == w.shape, path
        assert a.tobytes() == np.asarray(w).tobytes(), path
    # the same state written by both packages: the same files, byte for byte
    JManager(str(tmp_path / "j")).save(3, jstate, blocking=True)
    t, j = tmp_path / "t" / "step_3", tmp_path / "j" / "step_3"
    names = sorted(os.listdir(j))
    assert sorted(os.listdir(t)) == names
    _, mismatch, errors = filecmp.cmpfiles(j, t, names, shallow=False)
    assert mismatch == errors == []


def test_restore_onto_a_device_and_explicit_steps(J, tmp_path):
    _, _, jstate = J
    mgr = CheckpointManager(str(tmp_path))
    state = _port_state(jstate)
    mgr.save(1, state_tree(state), blocking=True)
    tree = mgr.restore(step=1, device="meta")
    assert all(t.device.type == "meta"
               for t in _leaves(state_from_tree(tree)).values())
    with pytest.raises(FileNotFoundError, match="step dir missing"):
        mgr.restore(step=2)


def test_torn_newest_snapshot_is_walked_back(J, tmp_path, capsys):
    _, _, jstate = J
    mgr = CheckpointManager(str(tmp_path))
    state = _port_state(jstate)
    mgr.save(1, state_tree(state), blocking=True)
    later = state_tree(state)
    later["opt"]["step"] = torch.tensor(9, dtype=torch.int32)
    mgr.save(2, later, blocking=True)
    assert mgr.latest_step() == 2
    leaf = tmp_path / "step_2" / "params__embed.npy"
    leaf.write_bytes(b"")                           # a torn write
    assert "truncated" in mgr.validate(2)
    assert mgr.valid_steps() == [1]
    back = state_from_tree(mgr.restore())
    assert "walked back to step 1" in capsys.readouterr().out
    _assert_bitwise(back, state)
    (tmp_path / "step_1" / "manifest.json").write_text("{")
    assert "torn" in mgr.validate(1)
    assert mgr.restore() is None
    with pytest.raises(FileNotFoundError, match="not restorable"):
        mgr.restore(step=1)


def test_keep_collects_the_oldest_and_async_saves_land(J, tmp_path):
    _, _, jstate = J
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = state_tree(_port_state(jstate))
    for s in (1, 2, 3, 4):
        mgr.save(s, state)                          # async
    mgr.wait()
    assert mgr.latest_step() == 4
    assert sorted(mgr.all_steps()) == [3, 4] == mgr.valid_steps()
    manifest = json.loads((tmp_path / "step_4" / "manifest.json")
                          .read_text())
    assert manifest["step"] == 4
    assert manifest["tree"]["params"]["embed"]["dtype"] == "bfloat16"


def test_save_snapshots_at_call_time(J, tmp_path):
    """``save`` copies the tensors before it returns: an in-place update
    afterwards (the next train step) does not reach the written files."""
    _, _, jstate = J
    state = _port_state(jstate)
    mgr = CheckpointManager(str(tmp_path))
    before = state["params"]["embed"].clone()
    mgr.save(1, state_tree(state))
    state["params"]["embed"].add_(1.0)
    mgr.wait()
    got = state_from_tree(mgr.restore(step=1))["params"]["embed"]
    assert torch.equal(_bits(got), _bits(before))


def test_a_failed_async_write_surfaces_on_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    (tmp_path / ".tmp_step_2").write_text("")     # blocks the write dir
    mgr.save(2, {"x": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="async checkpoint write"):
        mgr.wait()
    assert mgr.valid_steps() == [] and mgr.latest_step() is None
    mgr.wait()                                      # reported once
