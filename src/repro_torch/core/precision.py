"""Mixed-precision policies (paper §4.2): the dtype at each storage and
compute boundary.

A port of the reference's ``core/precision.py``: :class:`Policy`, the
paper's operating points :data:`FULL`, :data:`MIXED` and
:data:`HALF_STORAGE`, and :func:`matmul` and :func:`einsum`, whose
products all run through :func:`repro_torch.kernels.ops.matmul` with an
``accum_dtype`` result, as ``preferred_element_type`` gives in JAX.  fp32
operands (``FULL``, ``HALF_STORAGE``) take the GEMM kernel's fp32 path,
FMAs on the CUDA cores: nothing falls to TF32.  :func:`div_count` is
the reference's division by a count fixed when the program is built (a
mean over ranks or microbatches), rounded as XLA compiles it;
:func:`lazy_promote` the input pipeline's last-stage promotion.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class Policy:
    """Dtype at each storage/compute boundary."""

    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16
    accum_dtype: torch.dtype = torch.float32
    master_dtype: torch.dtype = torch.float32
    reduce_dtype: torch.dtype = torch.float32
    activation_dtype: torch.dtype = torch.bfloat16

    def cast_params(self, tree: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        return {k: _maybe_cast(v, self.param_dtype) for k, v in tree.items()}

    def cast_compute(self, *xs: torch.Tensor):
        out = tuple(_maybe_cast(x, self.compute_dtype) for x in xs)
        return out[0] if len(out) == 1 else out

    def cast_master(self, tree: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        return {k: _maybe_cast(v, self.master_dtype) for k, v in tree.items()}


def _maybe_cast(x, dtype: torch.dtype):
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        return x.to(dtype)
    return x


# The paper's operating points.
FULL = Policy(param_dtype=torch.float32, compute_dtype=torch.float32,
              activation_dtype=torch.float32)
MIXED = Policy()                                  # bf16 storage+compute
HALF_STORAGE = Policy(compute_dtype=torch.float32)  # store half, compute fp32


def matmul(a: torch.Tensor, b: torch.Tensor,
           policy: Policy = MIXED) -> torch.Tensor:
    """``(..., K) @ (K, N)`` on compute-dtype operands with an
    ``accum_dtype`` result: one GEMM over ``a``'s flattened rows."""
    a, b = policy.cast_compute(a, b)
    if b.dim() != 2:
        raise ValueError(f"matmul: b must be (K, N), got {tuple(b.shape)}")
    c = ops.matmul(a.reshape(-1, a.shape[-1]).contiguous(), b.contiguous(),
                   out_dtype=policy.accum_dtype)
    return c.reshape(*a.shape[:-1], b.shape[1])


def einsum(spec: str, a: torch.Tensor, b: torch.Tensor,
           policy: Policy = MIXED) -> torch.Tensor:
    """A two-operand einsum whose contracted indices are the trailing
    indices of ``a`` and the leading ones of ``b`` (``bsd,dhk->bshk``,
    ``bshk,hkd->bsd``, ``bsd,df->bsf``, ``bsf,fd->bsd``, ``bsd,dv->bsv``):
    one ``(M, K) @ (K, N)`` GEMM with an ``accum_dtype`` result.  A
    leading index both operands share and the output keeps is a batch
    (the expert banks' ``ecd,edf->ecf`` and ``ecf,efd->ecd``): one batched
    GEMM, ``(E, M, K) @ (E, K, N)``, in one launch."""
    ins, out = spec.replace(" ", "").split("->")
    sa, sb = ins.split(",")
    if a.dim() != len(sa) or b.dim() != len(sb):
        raise ValueError(f"einsum {spec!r}: operand ranks {a.dim()}, "
                         f"{b.dim()}")
    batch = sa[:1] if sa[:1] == sb[:1] == out[:1] != "" else ""
    ra, rb, ro = sa[len(batch):], sb[len(batch):], out[len(batch):]
    n = sum(c not in ro for c in ra)
    if n == 0 or any(c in ro for c in ra[len(ra) - n:]) \
            or rb[:n] != ra[len(ra) - n:] or ro != ra[:len(ra) - n] + rb[n:]:
        raise ValueError(f"einsum {spec!r} is not a trailing/leading "
                         "contraction of two operands")
    a, b = policy.cast_compute(a, b)
    e = a.shape[:len(batch)]
    if batch and b.shape[0] != a.shape[0]:
        raise ValueError(f"einsum {spec!r}: batch sizes {a.shape[0]}, "
                         f"{b.shape[0]}")
    lead = a.shape[len(batch):a.dim() - n]
    trail = b.shape[len(batch) + n:]
    k = math.prod(a.shape[a.dim() - n:])
    c = ops.matmul(a.reshape(*e, -1, k).contiguous(),
                   b.reshape(*e, k, -1).contiguous(),
                   out_dtype=policy.accum_dtype)
    return c.reshape(*e, *lead, *trail)


def div_count(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x / n`` for a count ``n`` fixed when the program is built, rounded
    as XLA compiles the reference's division by a trace-time constant: a
    multiply by fl32(1/n), in fp32 for a 16-bit ``x`` (widened, multiplied,
    rounded once to ``x``'s dtype).  A division by a tensor is a true
    division, which rounds otherwise when ``n`` is not a power of two."""
    inv = float(torch.tensor(1.0) / torch.tensor(float(n)))   # fl32(1/n)
    if x.dtype in (torch.float32, torch.float64):
        return x * inv
    return (x.float() * inv).to(x.dtype)


def lazy_promote(x: torch.Tensor, target_dtype: torch.dtype) -> torch.Tensor:
    """Identity marker for pipeline stages: promote only when actually
    needed (``x`` itself when it already has ``target_dtype``)."""
    if x.dtype == target_dtype:
        return x
    return x.to(target_dtype)
