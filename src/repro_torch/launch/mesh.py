"""Mesh builders, ported from the reference's ``launch/mesh.py``.

Functions, not module-level constants: importing this module creates no
process group.  Each builds a :class:`~repro_torch.core.distributed.Mesh`
over ``group`` (the default group when one is initialized), and raises
when the group's size does not fill the mesh; with no group, a
shape-only mesh for the layout algebra and the planner.
"""

from __future__ import annotations

from typing import Optional

import torch.distributed as dist

from repro_torch.core.distributed import Mesh


def _default(group: Optional[dist.ProcessGroup]):
    if group is None and dist.is_initialized():
        group = dist.group.WORLD
    return group


def production_shape(*, multi_pod: bool = False, pp: int = 1):
    """(shape, axes) of the reference's production mesh: 16x16 (256
    chips) or 2x16x16 (512 chips, 2 pods); ``pp > 1`` carves a ``pipe``
    axis out of the pod's chips and collapses the model axis to 1."""
    if pp > 1:
        chips = 256
        if chips % pp:
            raise ValueError(f"pp={pp} does not divide {chips} chips/pod")
        shape = (2, chips // pp, pp, 1) if multi_pod \
            else (chips // pp, pp, 1)
        axes = ("pod", "data", "pipe", "model") if multi_pod \
            else ("data", "pipe", "model")
    else:
        shape = (2, 16, 16) if multi_pod else (16, 16)
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return shape, axes


def make_production_mesh(*, multi_pod: bool = False, pp: int = 1,
                         group: Optional[dist.ProcessGroup] = None) -> Mesh:
    """The production mesh over ``group``, which must have exactly as many
    ranks (256 or 512); it never shrinks to fit."""
    shape, axes = production_shape(multi_pod=multi_pod, pp=pp)
    group = _default(group)
    if group is None:
        raise ValueError(f"a production mesh of shape {shape} needs a "
                         "process group of that many ranks")
    return Mesh(shape, axes, group)


def make_mesh(shape, axes, group: Optional[dist.ProcessGroup] = None
              ) -> Mesh:
    """An arbitrary mesh (tests, benchmarks); shape-only without a
    group."""
    return Mesh(tuple(shape), tuple(axes), _default(group))


def make_host_mesh(pp: int = 1, group: Optional[dist.ProcessGroup] = None
                   ) -> Mesh:
    """The group's ranks as (data=n, model=1) — the layouts always name
    both axes.  ``pp > 1`` inserts a ``pipe`` axis: (data=n/pp, pipe=pp,
    model=1).  With no group, one rank."""
    group = _default(group)
    n = dist.get_world_size(group) if group is not None else 1
    if pp > 1:
        if n % pp:
            raise ValueError(f"pp={pp} does not divide {n} ranks")
        return Mesh((n // pp, pp, 1), ("data", "pipe", "model"), group)
    return Mesh((n, 1), ("data", "model"), group)
