"""Where the port's entry points run."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The ``torch.device`` an entry point runs on.

    Entry points default to the card.  Without one they raise rather than
    continue on the CPU; the CPU (plain PyTorch versions of the kernels)
    is only taken when the caller asks for it with ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def host_copy(x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` in host memory that shares no storage with it.  A
    tensor on the card lands in pinned memory, which the copy engine
    writes at the link's rate and PyTorch's host cache hands out again
    once the copy is freed (on an H100 host, a 4.65 GB train state took
    ~2 s a copy into fresh pageable memory and 85 ms into cached pinned
    memory); the caller synchronizes before it reads the copy."""
    if x.is_cuda:
        out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        return out.copy_(x.detach(), non_blocking=True)
    return x.detach().clone()
