"""Process-group setup for the data-parallel train path.

Nothing tells a program of its cluster: each rank is given its rank, the
world size and a rendezvous address, here or through ``RANK``,
``WORLD_SIZE`` and ``DMATH_INIT_METHOD`` (a ``file://`` path or
``tcp://127.0.0.1:<port>``).  A rank on the card first makes its device
current.  The backend is gloo by default: two ranks can share one card
through it (NCCL refuses two ranks on one device), and the schedules stage
a CUDA tensor through host memory for it; NCCL, for ranks that each have
their own card, is the same call with ``backend="nccl"``.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch
import torch.distributed as dist

from repro_torch.core.device import resolve_device


def init_group(init_method: Optional[str] = None, *,
               rank: Optional[int] = None, world_size: Optional[int] = None,
               backend: str = "gloo",
               device: Union[str, torch.device] = "cuda"
               ) -> dist.ProcessGroup:
    """Join the default process group and return it; on the card, the
    rank's device (``cuda:0`` unless given) becomes current first."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None
                  else world_size)
    init_method = init_method or os.environ["DMATH_INIT_METHOD"]
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    return dist.group.WORLD


def close_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
