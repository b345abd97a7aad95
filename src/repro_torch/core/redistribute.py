"""Data reorganization service (paper §3.3), ported from the reference's
``core/redistribute.py``.

dMath "allows an algorithm to reshape (including a change of concurrency
and layout) ... and/or change precision during reshape".  Every function
here is SPMD: each rank passes its own block and gets its own block of
the result.  The primitive relayouts map onto collectives:

  sharded  -> replicated : all-gather, last sharded dim first
  replicated -> sharded  : local slice (no communication)
  sharded(dim i) -> sharded(dim j), one axis : all-to-all
  anything else          : gather, then slice

The reference has two paths, GSPMD's (:func:`relayout`, a sharding
constraint pair) and an explicit ``shard_map`` one; the port has only the
explicit one, so :func:`relayout` needs the source layout.  Both take
``dtype`` to change precision in flight: the cast comes before the
collective when it narrows and after it when it widens, so the wire
carries the narrow form (the paper's reduced-precision transfer, §4.2;
``distributed.WIRE`` records the dtypes that crossed).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import distributed as D
from .layout import Layout, axis_names


def relayout(x: torch.Tensor, dst: Layout, mesh: "D.Mesh",
             dtype: Optional[torch.dtype] = None,
             src: Optional[Layout] = None) -> torch.Tensor:
    """Move this rank's block ``x`` from ``src`` to ``dst``, optionally
    changing dtype.  There is no partitioner to infer ``src`` from, so it
    is required."""
    if src is None:
        raise ValueError("relayout: pass src=, the layout x is in (a block "
                         "does not know its layout)")
    return relayout_explicit(x, src, dst, mesh, dtype)


def relayout_explicit(x: torch.Tensor, src: Layout, dst: Layout,
                      mesh: "D.Mesh",
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """This rank's block of ``dst`` from its block ``x`` of ``src``, naming
    each collective; narrowing casts before the wire, widening after."""
    if dtype is not None and dtype.itemsize < x.dtype.itemsize:
        x = x.to(dtype)
        dtype = None
    out = x if src == dst else _move(x, src, dst, mesh)
    if dtype is not None:
        out = out.to(dtype)
    return out


def _move(x: torch.Tensor, src: Layout, dst: Layout, mesh) -> torch.Tensor:
    src_dims, dst_dims = src.sharded_dims(), dst.sharded_dims()

    # sharded -> replicated: all-gather every axis src uses
    if dst.is_replicated():
        for dim in reversed(src_dims):
            x = D.all_gather(x, mesh, src.dims[dim], dim)
        return x

    # replicated -> sharded: this rank's slice
    if src.is_replicated():
        return dst.block(x, mesh)

    # sharded dim i -> sharded dim j over the same single axis: all-to-all
    if (len(src_dims) == 1 and len(dst_dims) == 1 and src_dims != dst_dims
            and src.dims[src_dims[0]] == dst.dims[dst_dims[0]]
            and isinstance(src.dims[src_dims[0]], str)):
        i, j = src_dims[0], dst_dims[0]
        return D.all_to_all(x, mesh, src.dims[i], split_dim=j, concat_dim=i)

    # one axis moves from dim i to dim j, every other dim as it was (the
    # residual stream's (batch, None, model) -> (batch, model, None)):
    # an all-to-all over that axis alone
    moved = [d for d in range(src.ndim) if src.dims[d] != dst.dims[d]]
    if (len(moved) == 2 and all(isinstance(src.dims[d], (str, type(None)))
                                and isinstance(dst.dims[d], (str, type(None)))
                                for d in moved)):
        i, j = moved if src.dims[moved[0]] is not None else moved[::-1]
        if (src.dims[j] is None and dst.dims[i] is None
                and src.dims[i] == dst.dims[j]):
            return D.all_to_all(x, mesh, src.dims[i], split_dim=j,
                                concat_dim=i)

    # src refines dst (each dim's dst axes lead its src axes): gather the
    # extra axes alone, minor first
    if all(axis_names(s)[:len(axis_names(d))] == axis_names(d)
           for s, d in zip(src.dims, dst.dims)):
        for dim in reversed(range(src.ndim)):
            extra = axis_names(src.dims[dim])[len(axis_names(dst.dims[dim])):]
            if extra:
                x = D.all_gather(x, mesh, extra, dim)
        return x

    # anything else: gather fully, then slice
    full = _move(x, src, Layout.replicated(src.ndim), mesh)
    return dst.block(full, mesh)


def replicate(x: torch.Tensor, mesh: "D.Mesh", src: Layout) -> torch.Tensor:
    """The whole tensor on every rank, from this rank's block of ``src``."""
    return relayout(x, Layout.replicated(x.dim()), mesh, src=src)


def collective_bytes_estimate(shape, dtype: torch.dtype, src: Layout,
                              dst: Layout, mesh) -> int:
    """Analytic wire-bytes-per-device for a relayout (planner aid), the
    reference's model:

    all-gather: (n-1)/n of the global array arrives per device;
    all-to-all:  (n-1)/n of the local block leaves per device.
    """
    total = math.prod(shape) * dtype.itemsize
    if src == dst:
        return 0
    if dst.is_replicated():
        n = src.num_shards(mesh)
        return total * (n - 1) // n
    if src.is_replicated():
        return 0
    n = src.num_shards(mesh)
    local = total // n
    return local * (n - 1) // n
