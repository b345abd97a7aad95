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
from . import fused as _fused
from . import gemm as _gemm
from . import paged_attention as _paged
from . import ref as _ref
from . import ssd_scan as _ssd

matmul = _gemm.matmul                  # differentiable: dA, dB on the kernel
attention = _fa.attention              # differentiable: the backward kernel
paged_decode_attention = _paged.paged_decode_attention
# serving on a mesh: a rank's shard of the sequence, the ranks' combine
paged_decode_partials = _paged.paged_decode_partials
paged_decode_combine = _paged.paged_decode_combine
ssd = _ssd.ssd                         # differentiable: the backward kernel
ssd_step = _ref.ssd_step     # single-token decode: plain PyTorch everywhere
quantize_int8 = _fused.quantize_int8
quantize_compress = _fused.quantize_compress
# v = g + err quantized with its error feedback; counted as quantize_compress
quantize_compress_ef = _fused.quantize_compress_ef
matmul_dequant = _gemm.matmul_dequant
# offline weight preparation: plain PyTorch everywhere, as in the reference
quantize_int8_per_channel = _ref.quantize_int8_per_channel

# op -> (module, its launch counter)
_KERNELS = {"matmul": (_gemm, "launches"), "attention": (_fa, "launches"),
            "attention_backward": (_fa, "bwd_launches"),
            "paged_decode_attention": (_paged, "launches"),
            # serving on a mesh: the shard mode and the ranks' combine
            "paged_decode_partials": (_paged, "shard_launches"),
            "paged_decode_combine": (_paged, "combine_launches"),
            "ssd": (_ssd, "launches"),
            "ssd_backward": (_ssd, "bwd_launches"),
            "quantize_int8": (_fused, "launches"),
            "quantize_compress": (_fused, "compress_launches"),
            "matmul_dequant": (_gemm, "dequant_launches")}


def dispatch_report() -> Dict[str, int]:
    """Kernel launches per op since the last :func:`reset_launches`."""
    return {op: getattr(mod, attr) for op, (mod, attr) in _KERNELS.items()}


def reset_launches() -> None:
    for mod, attr in _KERNELS.values():
        setattr(mod, attr, 0)
    _gemm.batched_launches = 0     # the batched share of matmul's count
