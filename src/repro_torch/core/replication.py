"""Parameter replication & ZeRO-sharded state (paper §2.1): the layout
algebra, ported from the reference's ``core/replication.py``.

dMath: "After each worker computes the weight updates for its chunk of
the model, asynchronous replications are initiated for learnable
parameters that will be needed by all workers for the forward pass."
That is ZeRO-style optimizer sharding with an overlapped parameter
all-gather:

- *chunk of the model*: optimizer state sharded over the unused mesh
  axes (:func:`zero_layout`, :func:`zero_layout_tree`);
- *replication*: the relayout from the storage layout to the use layout
  (:func:`gathered`), or to replicated (:func:`replicate_now`).

The train step keeps its optimizer state on :func:`zero_layout` blocks
(:func:`to_zero` takes a block's piece, :func:`from_zero` gathers the
new parameters back); the reference overlaps the gather with the
previous layer's compute through XLA's scheduler, which an eager
relayout does not.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

from .layout import Layout, axis_names
from .redistribute import relayout_explicit


def zero_layout(param_layout: Layout, shape, mesh,
                axes: tuple = ("data", "model", "pod")) -> Layout:
    """Layout for optimizer state: the param layout plus every unused mesh
    axis placed greedily on unsharded divisible dimensions (ZeRO-1, pushed
    to the full device count).  If no dimension qualifies the state stays
    at the param layout (norms and biases are not worth scattering)."""
    lay = param_layout
    local = list(lay.local_shape(shape, mesh)) if lay.divisible(shape, mesh) \
        else list(shape)
    for axis in axes:
        if axis not in mesh.shape or axis in lay.mesh_axes_used():
            continue
        n = mesh.shape[axis]
        for dim, d in enumerate(lay.dims):
            if d is None and local[dim] % n == 0 and local[dim] >= n:
                lay = lay.with_dim(dim, axis)
                local[dim] //= n
                break
    return lay


def zero_layout_tree(param_layouts: Dict[str, Layout],
                     shapes: Dict[str, Sequence[int]], mesh
                     ) -> Dict[str, Layout]:
    """:func:`zero_layout` of every leaf of the port's flat param dicts
    (``shapes`` may hold tensors or shapes)."""
    return {k: zero_layout(lay, tuple(getattr(shapes[k], "shape",
                                              shapes[k])), mesh)
            for k, lay in param_layouts.items()}


def gathered(param: torch.Tensor, storage: Layout, use_layout: Layout,
             mesh, split: Sequence[str] = ()) -> torch.Tensor:
    """This rank's block of a parameter in its use layout, from its block
    in the storage layout (the storage -> use boundary), differentiably.
    ``split``: the axes over which the use splits its work (an FSDP
    weight gathered over ``data``, where each data rank runs its own
    rows): there the gather's backward is the reduce-scatter of the
    ranks' shares; over any other axis, the slice of the whole
    gradient."""
    from .distributed import all_gather_ad
    from .layout import constrain
    for dim in range(storage.ndim):
        for name in axis_names(storage.dims[dim]):
            if name in split and name not in use_layout.mesh_axes_used():
                param = all_gather_ad(param, mesh, name, dim)
                storage = storage.drop_axis(name)
    return constrain(param, use_layout, mesh, src=storage)


def to_zero(x: torch.Tensor, storage: Layout, zero: Layout, mesh
            ) -> torch.Tensor:
    """This rank's block in ``zero`` (a :func:`zero_layout` of
    ``storage``: axes added on dims ``storage`` leaves whole) from its
    block in ``storage``: a local slice, no communication."""
    for dim in range(zero.ndim):
        extra = axis_names(zero.dims[dim])[len(axis_names(storage.dims[dim])):]
        if extra:
            n = math.prod(mesh.shape[a] for a in extra)
            i = 0
            for a in extra:
                i = i * mesh.shape[a] + mesh.coords[a]
            size = x.shape[dim] // n
            x = x.narrow(dim, i * size, size)
    return x.contiguous()


def from_zero(x: torch.Tensor, zero: Layout, storage: Layout, mesh
              ) -> torch.Tensor:
    """This rank's block in ``storage`` from its block in ``zero``: the
    all-gather of the axes the ZeRO layout added (the parameter
    replication after the update)."""
    return relayout_explicit(x, zero, storage, mesh)


def replicate_now(param: torch.Tensor, storage: Layout, mesh
                  ) -> torch.Tensor:
    """Synchronous replication (paper §2.1's blocking variant)."""
    return relayout_explicit(param, storage, Layout.replicated(param.dim()),
                             mesh)


def use_layout_of(storage: Layout, fsdp_axis: str = "data") -> Layout:
    """The compute-time layout of an FSDP-stored parameter: drop the
    storage axis, keep the TP axes."""
    return storage.drop_axis(fsdp_axis)
