"""Checkpoint-restart with async saves (paper §2 requirement e), ported
from the reference's ``checkpoint/manager.py`` on the same on-disk format,
so a directory either package writes can be read by the other.

Format:  <dir>/step_<N>/
            manifest.json          tree structure, shapes, dtype names
            <flatkey>.npy          one file per leaf
         <dir>/LATEST              atomic pointer (written last)

A leaf's key is its path through nested dicts (and lists) joined by ``/``;
its file name joins it by ``__``.  numpy's own dtypes are saved as they
are; every other dtype as its raw bytes viewed as uint8, under the
reference's dtype name (``bfloat16``: the tensor's int16 bits, since
numpy has no bf16).  Saves snapshot the tensors to host memory at once and
write on a background thread; :meth:`CheckpointManager.wait` joins before
the next save, and an exit handler joins the last one.  ``restore`` walks
back past torn or missing snapshots and places the leaves on a device.

On a mesh (``save(..., mesh=, layouts=)``) every rank gathers each
leaf's blocks into its global array, one rank writes it, and every rank
waits for the write; ``restore(mesh=, layouts=)`` reads each global leaf
and keeps this rank's block in the layout given, on any mesh: the
elastic re-shard (the reference's ``restore(shardings=)``).

The port's train state keeps flat dicts of dotted parameter names; the
reference's is nested.  :func:`state_tree` and :func:`state_from_tree`
map one to the other (the names ``models.params.from_jax`` maps), so the
train CLIs of both packages write the same files for the same state.
"""

from __future__ import annotations

import atexit
import json
import os
import shutil
import threading
import weakref
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.core.device import host_copy
from repro_torch.models.params import flat_names, nest_names

# dtypes numpy has no type for: moved as their bits
_BITS = {"bfloat16": (torch.bfloat16, torch.int16, np.int16),
         "float8_e4m3fn": (torch.float8_e4m3fn, torch.uint8, np.uint8),
         "float8_e5m2": (torch.float8_e5m2, torch.uint8, np.uint8)}


def _dtype_name(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _to_host(x) -> np.ndarray:
    """A copy of a tensor (or array) in host memory, as numpy: bf16 and
    fp8 as their bits.  A tensor on the card is copied into pinned memory
    (:func:`~repro_torch.core.device.host_copy`); the caller synchronizes
    before the copy is read."""
    if isinstance(x, (np.ndarray, np.generic)):
        return np.array(x, copy=True)
    t = host_copy(x)
    name = _dtype_name(t)
    if name in _BITS:
        t = t.view(_BITS[name][1])
    return t.numpy()


def _host_leaves(tree) -> Dict[str, np.ndarray]:
    """Every leaf of ``tree`` copied to host memory by its key, the
    copies from the card finished."""
    host = {k: _to_host(v) for k, v in _flatten(tree).items()}
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return host


def _encode(arr: np.ndarray) -> np.ndarray:
    """Raw-byte view so np.save round-trips every dtype without pickle."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype in (np.float32, np.float64, np.int32, np.int64,
                     np.int8, np.uint8, np.bool_):
        return arr
    return arr.view(np.uint8)


def _decode(raw: np.ndarray, dtype_str: str, shape) -> torch.Tensor:
    if dtype_str in _BITS:
        dtype, _, bits = _BITS[dtype_str]
        arr = raw.view(bits).reshape(shape) if raw.dtype == np.uint8 \
            else raw.reshape(shape)
        return torch.from_numpy(np.array(arr)).view(dtype)
    dt = np.dtype(dtype_str)
    arr = raw.view(dt).reshape(shape) if raw.dtype == np.uint8 \
        else raw.reshape(shape)
    return torch.from_numpy(np.array(arr))


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: Dict[str, Any], manifest_tree):
    if isinstance(manifest_tree, dict) and manifest_tree.get("__leaf__"):
        return flat[manifest_tree["key"]]
    if isinstance(manifest_tree, dict):
        return {k: _unflatten(flat, v) for k, v in manifest_tree.items()}
    if isinstance(manifest_tree, list):
        return tuple(_unflatten(flat, v) for v in manifest_tree)
    raise ValueError(f"bad manifest node {manifest_tree!r}")


def _map_leaves(fn, tree, other):
    """``fn(leaf, other's leaf)`` over two trees of one structure."""
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v, o) for v, o in zip(tree, other))
    return fn(tree, other)


def _global(x, layout, mesh):
    """The global array of this rank's block ``x`` of ``layout``."""
    from repro_torch.core.layout import Layout, constrain
    x = x.detach() if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    return constrain(x, Layout.replicated(x.dim()), mesh, src=layout)


def _manifest_of(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: _manifest_of(tree[k], f"{prefix}{k}/") for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_manifest_of(v, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return {"__leaf__": True, "key": prefix[:-1],
            "shape": list(tree.shape), "dtype": _dtype_name(tree)}


def _manifest_leaves(tree):
    if isinstance(tree, dict) and tree.get("__leaf__"):
        yield tree
        return
    vals = tree.values() if isinstance(tree, dict) else tree
    for v in vals:
        yield from _manifest_leaves(v)


def _atexit_wait(ref: "weakref.ref") -> None:
    """Join a still-running daemon save thread at interpreter exit: the
    thread would otherwise be killed mid-write, silently truncating the
    final checkpoint.  Errors are printed, not raised — exit handlers
    must not mask the process's own exit status."""
    mgr = ref()
    if mgr is None:
        return
    try:
        mgr.wait()
    except Exception as e:                       # pragma: no cover
        print(f"checkpoint: final async save failed at exit: {e}")


def blocks_of(tree, mesh, layouts):
    """This rank's block of every global leaf of ``tree`` in its layout
    (``layouts``: the same structure, a :class:`Layout` per leaf)."""
    return _map_leaves(lambda x, lay: lay.block(x, mesh), tree, layouts)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # daemon save threads die with the interpreter; join them at exit
        # so the last checkpoint is never torn.  weakref: the handler must
        # not keep a dead manager (and its state snapshot) alive.
        atexit.register(_atexit_wait, weakref.ref(self))

    # ------------------------------------------------------------------
    def save(self, step: int, state, blocking: bool = False, mesh=None,
             layouts=None):
        """Snapshot ``state`` (nested dicts, lists and tuples of tensors or
        arrays) to host memory synchronously, write it to disk async.

        On a ``mesh`` of ranks ``state`` holds this rank's blocks and
        ``layouts`` (the same tree, a :class:`Layout` per leaf) their
        layouts: each leaf is gathered whole on every rank, the mesh's
        first rank writes it (blocking), and every rank waits at a
        barrier."""
        self.wait()
        if mesh is not None and mesh.group is not None:
            import torch.distributed as dist
            whole = _map_leaves(lambda x, lay: _global(x, lay, mesh), state,
                                layouts)
            if mesh.rank == 0:
                host = _host_leaves(whole)
                self._write(step, _manifest_of(whole), host)
                self._gc()
            dist.barrier(group=mesh.group)
            return
        manifest = _manifest_of(state)
        host = _host_leaves(state)

        def _write():
            try:
                self._write(step, manifest, host)
                self._gc()
            except BaseException as e:          # surfaced on next wait()
                self._error = e

        if blocking:
            _write()
            self._raise_if_failed()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def _write(self, step: int, manifest, host: Dict[str, np.ndarray]):
        tmp = os.path.join(self.dir, f".tmp_step_{step}")
        final = os.path.join(self.dir, f"step_{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        for key, arr in host.items():
            fn = key.replace("/", "__") + ".npy"
            np.save(os.path.join(tmp, fn), _encode(arr))
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "tree": manifest}, f)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        with open(os.path.join(self.dir, ".LATEST_tmp"), "w") as f:
            f.write(str(step))
        os.replace(os.path.join(self.dir, ".LATEST_tmp"),
                   os.path.join(self.dir, "LATEST"))

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError(f"async checkpoint write failed: {e}") from e

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_"):
                try:
                    out.append(int(d.split("_")[1]))
                except ValueError:
                    continue
        return out

    def latest_step(self) -> Optional[int]:
        """The ``LATEST`` pointer as written — an *intent*, not a verdict:
        the pointed-at snapshot may be torn or GC'd (``validate`` /
        ``restore`` re-judge it)."""
        p = os.path.join(self.dir, "LATEST")
        if not os.path.exists(p):
            return None
        try:
            with open(p) as f:
                return int(f.read().strip())
        except (ValueError, OSError):
            return None              # torn pointer write: walk the dirs

    def validate(self, step: int) -> Optional[str]:
        """Crash-consistency verdict for one snapshot: None when it is
        complete (manifest parses, every leaf file present and non-empty),
        else the reason it must not be trusted."""
        d = os.path.join(self.dir, f"step_{step}")
        if not os.path.isdir(d):
            return f"step dir missing: {d}"
        mpath = os.path.join(d, "manifest.json")
        try:
            with open(mpath) as f:
                manifest = json.load(f)
        except FileNotFoundError:
            return f"manifest missing: {mpath}"
        except (json.JSONDecodeError, OSError) as e:
            return f"manifest torn: {mpath} ({e})"
        if "tree" not in manifest:
            return f"manifest torn: {mpath} (no tree)"
        for node in _manifest_leaves(manifest["tree"]):
            fn = os.path.join(d, node["key"].replace("/", "__") + ".npy")
            try:
                if os.path.getsize(fn) == 0:
                    return f"leaf truncated: {fn}"
            except OSError:
                return f"leaf missing: {fn}"
        return None

    def valid_steps(self) -> List[int]:
        """All complete snapshots, ascending."""
        return sorted(s for s in self.all_steps()
                      if self.validate(s) is None)

    def restore(self, step: Optional[int] = None,
                device: Union[str, torch.device, None] = None, mesh=None,
                layouts=None):
        """Load a checkpoint as tensors (on ``device``, else the CPU).
        Given a ``mesh`` and ``layouts`` (a tree of the state's structure,
        a :class:`Layout` per leaf), each leaf is this rank's block of the
        global array in its layout, on any mesh: the elastic re-shard.

        Crash consistency: an EXPLICIT ``step`` is validated and raises
        :class:`FileNotFoundError` with the torn/missing reason (the
        caller asked for that snapshot by name).  With ``step=None`` the
        ``LATEST`` pointer is only a hint — a torn, missing, or GC'd
        target makes restore WALK BACK to the newest complete snapshot
        instead of crashing mid-load, and returns None only when no valid
        snapshot exists at all.
        """
        self.wait()
        if step is not None:
            reason = self.validate(step)
            if reason is not None:
                raise FileNotFoundError(
                    f"checkpoint step {step} is not restorable: {reason}")
            return self._load(step, device, mesh, layouts)
        candidates = sorted(self.all_steps(), reverse=True)
        latest = self.latest_step()
        if latest is not None and latest in candidates:
            # try the pointer first, then newer-to-older
            candidates.remove(latest)
            candidates.insert(0, latest)
        for s in candidates:
            if self.validate(s) is None:
                if latest is not None and s != latest:
                    print(f"checkpoint: LATEST -> step {latest} is torn or "
                          f"missing; walked back to step {s}")
                return self._load(s, device, mesh, layouts)
        return None

    def _load(self, step: int, device, mesh=None, layouts=None):
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        flat = {}
        for node in _manifest_leaves(manifest["tree"]):
            fn = node["key"].replace("/", "__") + ".npy"
            raw = np.load(os.path.join(d, fn))
            flat[node["key"]] = _decode(raw, node["dtype"], node["shape"])
        state = _unflatten(flat, manifest["tree"])
        if mesh is not None:
            state = blocks_of(state, mesh, layouts)
        if device is not None:
            state = _map_leaves(lambda x, _: x.to(device), state, state)
        return state


# ---------------------------------------------------------------------------
# the train state in the reference's layout
# ---------------------------------------------------------------------------

_OPT_TREES = ("mu", "nu", "master")


def state_tree(state: Dict[str, Any]) -> Dict[str, Any]:
    """A port train state ``{"params", "opt": {"step", "mu", "nu",
    "master"}}``, whose parameter dicts are flat, as the reference's
    pytree (each dict nested along its dotted names)."""
    opt = state["opt"]
    return {"params": nest_names(state["params"]),
            "opt": {"step": opt["step"],
                    **{k: nest_names(opt[k]) for k in _OPT_TREES}}}


def state_from_tree(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`state_tree`: a train state restored from
    either package's checkpoint, with the port's flat parameter dicts."""
    opt = tree["opt"]
    return {"params": flat_names(tree["params"]),
            "opt": {"step": opt["step"],
                    **{k: flat_names(opt[k]) for k in _OPT_TREES}}}
