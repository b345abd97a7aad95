"""DistTensor: the user-facing distributed array (paper §2, §2.1), ported
from the reference's ``core/dtensor.py``.

dMath's programming model: "the developer uses dMath like any other
mathematics library; the distributed computation is handled internally".
A :class:`DistTensor` holds this rank's block of a global tensor with its
:class:`Layout`, mesh and global shape, and registers itself in a
:class:`TensorRegistry`, the analogue of every worker knowing the layout
of every matrix (§2.1).  The reference holds the global ``jax.Array``;
here every rank builds the same DistTensors in the same order (SPMD), so
the registries agree.

Arithmetic dispatches through ``core.gemm`` / ``core.redistribute``;
``@``, ``+``, ``-``, ``*`` work without the caller knowing the
distribution.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional, Tuple

import torch

from . import distributed as D
from . import precision
from .gemm import gemm_auto
from .layout import Layout, axis_names
from .redistribute import relayout_explicit


class TensorRegistry:
    """name -> (global shape, dtype, layout): the layout table of §2.1.

    All mutation happens under one lock — anonymous names too, so
    concurrent construction never mints a duplicate — and entries can be
    ``evict``ed/``clear``ed so long sessions do not leak rows."""

    def __init__(self):
        self._table: Dict[str, tuple] = {}
        self._lock = threading.Lock()
        self._anon = 0

    def register(self, name: str, shape, dtype: torch.dtype, layout: Layout):
        with self._lock:
            self._table[name] = (tuple(shape), dtype, layout)

    def next_anon(self) -> str:
        with self._lock:
            self._anon += 1
            return f"tensor_{self._anon}"

    def lookup(self, name: str):
        return self._table.get(name)

    def layouts(self) -> Dict[str, Layout]:
        return {k: v[2] for k, v in self._table.items()}

    def evict(self, name: str) -> bool:
        """Drop one layout-table entry; True if it existed."""
        with self._lock:
            return self._table.pop(name, None) is not None

    def clear(self) -> None:
        with self._lock:
            self._table.clear()

    def __contains__(self, name: str) -> bool:
        return name in self._table

    def __len__(self):
        return len(self._table)


REGISTRY = TensorRegistry()


@dataclasses.dataclass
class DistTensor:
    """This rank's block of a global tensor + its layout + the mesh.

    ``registry`` defaults to the process-wide :data:`REGISTRY`;
    :meth:`repro_torch.api.Session.tensor` passes the session's table, so
    derived tensors (relayouts, products) land there too."""

    data: torch.Tensor                  # this rank's block
    layout: Layout
    mesh: "D.Mesh"
    global_shape: Tuple[int, ...]
    name: Optional[str] = None
    policy: precision.Policy = precision.MIXED
    registry: Optional[TensorRegistry] = dataclasses.field(
        default=None, repr=False, compare=False)

    def __post_init__(self):
        self.global_shape = tuple(self.global_shape)
        if self.registry is None:
            self.registry = REGISTRY
        if self.name is None:
            self.name = self.registry.next_anon()
        self.registry.register(self.name, self.global_shape, self.data.dtype,
                               self.layout)

    # -- construction -------------------------------------------------------
    @staticmethod
    def shard(data: torch.Tensor, layout: Layout, mesh: "D.Mesh",
              name: Optional[str] = None, **kw) -> "DistTensor":
        """This rank's block of the global ``data``."""
        return DistTensor(layout.block(data, mesh), layout, mesh,
                          tuple(data.shape), name=name, **kw)

    def _derived(self, data, layout, name=None) -> "DistTensor":
        return DistTensor(data, layout, self.mesh,
                          layout.global_shape(data.shape, self.mesh),
                          name=name, policy=self.policy,
                          registry=self.registry)

    # -- views --------------------------------------------------------------
    @property
    def shape(self):
        return self.global_shape

    @property
    def dtype(self):
        return self.data.dtype

    def bytes_per_device(self) -> int:
        return self.layout.bytes_per_device(self.shape, self.dtype, self.mesh)

    # -- redistribution (§3.3) ----------------------------------------------
    def with_layout(self, dst: Layout, dtype: Optional[torch.dtype] = None,
                    explicit: bool = False) -> "DistTensor":
        """The same tensor in ``dst`` (and ``dtype``).  The port has only
        the explicit path; ``explicit`` is kept for the reference's
        signature."""
        arr = relayout_explicit(self.data, self.layout, dst, self.mesh, dtype)
        return self._derived(arr, dst, name=f"{self.name}@{dst}")

    def replicated(self) -> "DistTensor":
        return self.with_layout(Layout.replicated(self.data.dim()))

    # -- math (layout-independent, §3.2) -------------------------------------
    def matmul(self, other: "DistTensor",
               out_layout: Optional[Layout] = None) -> "DistTensor":
        c, plan = gemm_auto(self.data, other.data, self.layout, other.layout,
                            self.mesh, out_layout=out_layout,
                            policy=self.policy)
        lay = out_layout if out_layout is not None else plan.out_layout
        return self._derived(c, lay, name=f"({self.name}@{other.name})")

    def __matmul__(self, other: "DistTensor") -> "DistTensor":
        return self.matmul(other)

    def _ewise(self, other, op):
        if isinstance(other, DistTensor):
            o = other
            if o.layout != self.layout:
                o = o.with_layout(self.layout)
            arr = op(self.data, o.data)
        else:
            arr = op(self.data, other)
        return self._derived(arr, self.layout)

    def __add__(self, other):
        return self._ewise(other, torch.add)

    def __sub__(self, other):
        return self._ewise(other, torch.sub)

    def __mul__(self, other):
        return self._ewise(other, torch.mul)

    def sum(self, axis: Optional[int] = None) -> torch.Tensor:
        """The global sum (over ``axis``, or all of it), the same tensor on
        every rank: this rank's block summed, the partial sums added over
        the axes the summed dims are sharded on (in rank order), and the
        rest gathered."""
        dims = tuple(range(self.data.dim())) if axis is None else (axis,)
        x = self.data.sum(dim=dims, keepdim=True)
        for d in dims:
            x = D.psum(x, self.mesh, axis_names(self.layout.dims[d]))
        for d in reversed(self.layout.sharded_dims()):
            if d not in dims:
                x = D.all_gather(x, self.mesh, self.layout.dims[d], d)
        return x.squeeze(dims) if dims else x

    def to_global(self) -> torch.Tensor:
        """The whole tensor on every rank."""
        return self.replicated().data

    def __repr__(self):
        return (f"DistTensor({self.name}, shape={tuple(self.shape)}, "
                f"dtype={self.dtype}, layout={self.layout})")
