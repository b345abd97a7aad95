"""The kernel surface the model calls.

The device of the tensors decides, and nothing else: each wrapper runs
its plain PyTorch version for CPU tensors and its CUDA kernel for CUDA
tensors, raising when the kernel cannot take them.  There is no
environment switch, availability probe or roofline gate (the reference's
``ops.py`` has all three): on the card any of them would be a hidden
fallback to the plain version.
"""

from __future__ import annotations

from typing import Dict

from . import flash_attention as _fa
from . import gemm as _gemm
from . import paged_attention as _paged

matmul = _gemm.matmul
attention = _fa.attention
paged_decode_attention = _paged.paged_decode_attention

_KERNELS = {"matmul": _gemm, "attention": _fa,
            "paged_decode_attention": _paged}


def dispatch_report() -> Dict[str, int]:
    """Kernel launches per op since the last :func:`reset_launches`."""
    return {op: mod.launches for op, mod in _KERNELS.items()}


def reset_launches() -> None:
    for mod in _KERNELS.values():
        mod.launches = 0
