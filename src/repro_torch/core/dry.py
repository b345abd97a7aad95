"""The dry trace: run a step on fake tensors, for one rank, without
running it.

The reference lowers and compiles its step on fake XLA devices and reads
the compiled program's memory and cost analyses.  The port runs eagerly,
so its counterpart traces the same dispatched step under
``torch._subclasses.fake_tensor.FakeTensorMode``: every tensor has its
shape, dtype and device and no storage, every operator computes only the
shapes of its outputs, and a collective over a process group of torch's
``fake`` backend returns at once.  What the trace reads:

- **peak**: the most live bytes of tensor storage at any point of the
  trace (:class:`PeakTracker`, an operator-level dispatch mode that
  counts each storage once, from the operator that made it until it is
  freed), the traced state's own storage included;
- **FLOPs**: ``torch.utils.flop_counter.FlopCounterMode``'s count of the
  plain operators, plus the kernels' counts from their shape functions
  (:data:`repro_torch.kernels.roofline.DRY`);
- **bytes accessed**: each plain operator's inputs and outputs, plus the
  kernels' HBM bytes;
- **collectives**: :data:`repro_torch.core.distributed.WIRE`, the bytes
  this rank would receive, by collective.

The kernel wrappers take a fake tensor to their shape function: it
allocates exactly what the kernel allocates (outputs, log-sum-exp,
scratch) and records the kernel's FLOPs and bytes, so the trace's memory
is the card's and not the plain versions' (plain attention would hold
S x T scores).

Nothing of a trace may read a tensor's values: ``.item()`` and
``.tolist()`` raise on fake tensors, and the train path has none.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
import weakref
from typing import Any, Dict

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode


_FACTORIES = {"empty", "empty_like", "empty_strided", "new_empty",
              "new_empty_strided", "detach", "alias", "lift_fresh"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class PeakTracker(TorchDispatchMode):
    """Live and peak bytes of tensor storage, and the bytes the plain
    operators read and write.

    A storage counts from the operator that made it until it is freed,
    once however many views share it.  :meth:`track` adds storages made
    before the mode was entered (a step's arguments)."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self.op_bytes = 0
        self._seen: Dict[int, int] = {}

    def track(self, tree: Any) -> None:
        for t in tree_flatten(tree)[0]:
            if isinstance(t, torch.Tensor):
                self._add(t)

    def _add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._drop, key)

    def _drop(self, key: int) -> None:
        self.live -= self._seen.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if not func.is_view and name not in _FACTORIES:
            ins = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
            self.op_bytes += sum(_nbytes(t) for t in ins + outs)
        for t in outs:
            self._add(t)
        return out


@dataclasses.dataclass
class Trace:
    """What one dry trace read (see the module's docstring)."""

    peak_bytes: int = 0
    state_bytes: int = 0
    flops: float = 0.0
    bytes_accessed: float = 0.0
    kernel_flops: Dict[str, float] = dataclasses.field(default_factory=dict)
    kernel_calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    collectives: Dict[str, int] = dataclasses.field(default_factory=dict)
    collective_calls: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    wire_bytes: int = 0
    trace_s: float = 0.0


def fake_mode() -> FakeTensorMode:
    """The fake-tensor mode a dry trace runs in."""
    return FakeTensorMode(allow_non_fake_inputs=False)


@contextlib.contextmanager
def traced(state: Any = None):
    """Trace what runs inside (under an active :func:`fake_mode`): yields
    a :class:`Trace` that is filled in on exit.  ``state`` (tensors made
    before, the step's arguments) counts as live from the start.

    ``WIRE`` counts the trace's collectives from zero, and its counts
    from before the trace are put back on exit, so a process that counts
    its real wire bytes around a trace keeps them.  ``roofline.DRY`` is
    the dry trace's own: it holds the last trace's kernel counts."""
    from repro_torch.core import distributed as dist_mod
    from repro_torch.kernels import roofline

    wire = dist_mod.WIRE
    saved = (wire.bytes, wire.calls, wire.dtypes)
    trace = Trace()
    tracker = PeakTracker()
    tracker.track(state)
    trace.state_bytes = tracker.live
    roofline.DRY.reset()
    wire.reset()
    flops = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    try:
        with flops, tracker:
            yield trace
        trace.trace_s = time.perf_counter() - t0
        trace.peak_bytes = tracker.peak
        trace.kernel_flops = dict(roofline.DRY.flops)
        trace.kernel_calls = dict(roofline.DRY.calls)
        trace.flops = float(flops.get_total_flops()) + sum(
            roofline.DRY.flops.values())
        trace.bytes_accessed = float(tracker.op_bytes) + sum(
            roofline.DRY.bytes.values())
        trace.collectives = dict(wire.bytes)
        trace.collective_calls = dict(wire.calls)
        trace.wire_bytes = wire.total()
    finally:
        wire.bytes, wire.calls, wire.dtypes = saved
