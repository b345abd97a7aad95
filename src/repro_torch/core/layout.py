"""Layout algebra for distributed tensors (paper §2.1, §3.2), ported from
the reference's ``core/layout.py``.

A distributed matrix is split into non-overlapping blocks, one per rank,
and every rank knows the layout of every matrix.  A :class:`Layout` is a
tuple of per-dimension shardings over the *named* axes of a
:class:`~repro_torch.core.distributed.Mesh`; ``None`` leaves a dimension
whole.  The classic dMath/ScaLAPACK layouts are special cases:

- ``Layout.replicated(ndim)``                — every block on every rank
- ``Layout.row_sharded(ndim, axis="model")`` — 1-D row decomposition
- ``Layout.col_sharded(ndim, axis="model")`` — 1-D column decomposition
- ``Layout.blocked_2d(("data", "model"))``   — 2-D block decomposition

The reference's ``spec`` and ``sharding`` are JAX's objects and have no
counterpart here: a rank holds its block as a plain tensor
(:meth:`Layout.block`).  :func:`constrain` has no partitioner to steer,
so it is a relayout from a source layout that the caller names.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple, Union

import torch

AxisSpec = Union[None, str, Tuple[str, ...]]


def _canon_axis(a: AxisSpec) -> Union[None, str, Tuple[str, ...]]:
    """Canonicalize a per-dim axis spec: () -> None, ("x",) -> "x"."""
    if a is None:
        return None
    if isinstance(a, str):
        return a
    t = tuple(a)
    if len(t) == 0:
        return None
    if len(t) == 1:
        return t[0]
    return t


def axis_names(a: AxisSpec) -> Tuple[str, ...]:
    if a is None:
        return ()
    if isinstance(a, str):
        return (a,)
    return tuple(a)


@dataclasses.dataclass(frozen=True)
class Layout:
    """Per-dimension mapping of a logical tensor onto named mesh axes.

    ``dims[i]`` is the mesh axis (or axes, major first) that shard
    dimension ``i``; ``None`` means the dimension is replicated.  Hashable
    and comparable, so it can key the op cache."""

    dims: Tuple[AxisSpec, ...]

    def __post_init__(self):
        object.__setattr__(self, "dims",
                           tuple(_canon_axis(d) for d in self.dims))
        seen = set()
        for d in self.dims:
            for name in axis_names(d):
                if name in seen:
                    raise ValueError(
                        f"mesh axis {name!r} used for two dimensions in "
                        f"{self.dims}")
                seen.add(name)

    # -- constructors -------------------------------------------------------
    @staticmethod
    def replicated(ndim: int) -> "Layout":
        return Layout((None,) * ndim)

    @staticmethod
    def row_sharded(ndim: int, axis: AxisSpec = "model") -> "Layout":
        return Layout((axis,) + (None,) * (ndim - 1))

    @staticmethod
    def col_sharded(ndim: int, axis: AxisSpec = "model") -> "Layout":
        return Layout((None,) * (ndim - 1) + (_canon_axis(axis),))

    @staticmethod
    def blocked_2d(axes: Tuple[AxisSpec, AxisSpec] = ("data", "model")
                   ) -> "Layout":
        return Layout(tuple(axes))

    # -- views --------------------------------------------------------------
    @property
    def ndim(self) -> int:
        return len(self.dims)

    def is_replicated(self) -> bool:
        return all(d is None for d in self.dims)

    def sharded_dims(self) -> Tuple[int, ...]:
        return tuple(i for i, d in enumerate(self.dims) if d is not None)

    def mesh_axes_used(self) -> Tuple[str, ...]:
        out = []
        for d in self.dims:
            out.extend(axis_names(d))
        return tuple(out)

    # -- geometry -----------------------------------------------------------
    def shard_count(self, mesh, dim: int) -> int:
        """Number of shards along logical dimension ``dim``."""
        return math.prod(mesh.shape[name]
                         for name in axis_names(self.dims[dim]))

    def num_shards(self, mesh) -> int:
        return math.prod(self.shard_count(mesh, i) for i in range(self.ndim))

    def local_shape(self, global_shape: Sequence[int], mesh
                    ) -> Tuple[int, ...]:
        out = []
        for i, size in enumerate(global_shape):
            n = self.shard_count(mesh, i)
            if size % n:
                raise ValueError(
                    f"dim {i} of size {size} not divisible by {n} shards "
                    f"(layout {self.dims}, mesh {dict(mesh.shape)})")
            out.append(size // n)
        return tuple(out)

    def global_shape(self, local_shape: Sequence[int], mesh
                     ) -> Tuple[int, ...]:
        """The global shape whose blocks have ``local_shape``."""
        return tuple(size * self.shard_count(mesh, i)
                     for i, size in enumerate(local_shape))

    def divisible(self, global_shape: Sequence[int], mesh) -> bool:
        try:
            self.local_shape(global_shape, mesh)
            return True
        except ValueError:
            return False

    def bytes_per_device(self, global_shape: Sequence[int],
                         dtype: torch.dtype, mesh) -> int:
        local = self.local_shape(global_shape, mesh)
        return math.prod(local) * dtype.itemsize

    def block(self, x: torch.Tensor, mesh) -> torch.Tensor:
        """This rank's block of the global tensor ``x``: a contiguous copy
        (the GEMM kernel takes row-major operands; a column block of a
        row-major matrix is not one)."""
        if mesh.coords is None:
            raise ValueError("block needs a mesh with this rank's "
                             "coordinates (over a process group, or of one "
                             "position)")
        local = self.local_shape(x.shape, mesh)
        for dim in self.sharded_dims():
            i = 0                  # the rank's coordinates, major axis first
            for name in axis_names(self.dims[dim]):
                i = i * mesh.shape[name] + mesh.coords[name]
            x = x.narrow(dim, i * local[dim], local[dim])
        return x.clone(memory_format=torch.contiguous_format)

    # -- transforms ---------------------------------------------------------
    def with_dim(self, dim: int, axis: AxisSpec) -> "Layout":
        dims = list(self.dims)
        dims[dim] = _canon_axis(axis)
        return Layout(tuple(dims))

    def drop_axis(self, name: str) -> "Layout":
        """Remove one mesh axis from wherever it shards (-> replicated
        there)."""
        new = []
        for d in self.dims:
            names = tuple(n for n in axis_names(d) if n != name)
            new.append(_canon_axis(names))
        return Layout(tuple(new))

    def __repr__(self) -> str:  # compact, e.g. L[model, -, data]
        parts = []
        for d in self.dims:
            if d is None:
                parts.append("-")
            elif isinstance(d, str):
                parts.append(d)
            else:
                parts.append("+".join(d))
        return "L[" + ", ".join(parts) + "]"


def constrain(x: torch.Tensor, layout: Layout, mesh,
              src: Optional[Layout] = None, manual: Sequence[str] = ()
              ) -> torch.Tensor:
    """This rank's block of ``x`` in ``layout``, differentiably.

    The reference's ``with_sharding_constraint`` lets GSPMD find the
    move; a block carries no layout of its own, so the port needs the
    layout ``x`` is in (``src``) and raises without one.  The move is
    :func:`~repro_torch.core.redistribute.relayout_explicit`, and its
    backward the move back (the transpose of a relayout of one global
    value: a gathered value's gradient is whole on every rank, so the
    backward of a gather is this rank's slice).

    ``manual``: the axes the caller has already split the work over (the
    reference's manual ``shard_map`` axes, e.g. ``data`` on the comms
    path's (n, 1) mesh).  They are dropped from both layouts, since the
    block is already local over them; a constraint left equal to its
    source is the identity."""
    if src is None:
        raise ValueError(
            "constrain: a block does not know its layout; pass src= (the "
            "layout x is in), there is no partitioner to infer it")
    for name in manual:
        layout, src = layout.drop_axis(name), src.drop_axis(name)
    if layout == src:
        return x
    return _Relayout.apply(x, src, layout, mesh)


class _Relayout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, src, dst, mesh):
        from .redistribute import relayout_explicit
        ctx.args = (src, dst, mesh)
        out = relayout_explicit(x, src, dst, mesh)
        return out.view_as(out) if out is x else out

    @staticmethod
    def backward(ctx, g):
        from .redistribute import relayout_explicit
        src, dst, mesh = ctx.args
        return (relayout_explicit(g.contiguous(), dst, src, mesh), None,
                None, None)


def batch_block(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """This rank's rows of a global batch leaf: its block of the layout
    that shards dim 0 over ``axes`` (the rows of the rank's data
    coordinate, ``np.unravel_index(rank, shape)``'s, not of its raw rank),
    or the whole leaf when ``axes`` cannot split its rows (the reference's
    ``_maybe_batch``: a batch smaller than the data axes)."""
    n = math.prod(mesh.shape[a] for a in axes)
    if n == 1 or x.shape[0] % n or x.shape[0] < n:
        return x
    return Layout((tuple(axes),) + (None,) * (x.dim() - 1)).block(x, mesh)


def best_divisor_axis(size: int, mesh, candidates: Sequence[str]
                      ) -> Optional[str]:
    """First candidate mesh axis whose size divides ``size`` (planner
    helper)."""
    for name in candidates:
        if name in mesh.shape and size % mesh.shape[name] == 0:
            return name
    return None
