"""Gradient compression with error feedback for the explicit data-parallel
SGD step, ported from the reference's ``train/compression.py`` (the
paper's CNTK one-bit column, Table 1) onto ``torch.distributed``:

- ``onebit``: sign + per-tensor L1 scale, residual error feedback (Seide
  et al. 2014), plain PyTorch on every device, as in the reference;
- ``int8``: per-tensor absmax affine quantization with error feedback,
  one call of :func:`repro_torch.kernels.ops.quantize_compress_ef` per
  leaf (the CUDA kernel pair for a tensor on the card), which rounds as
  the reference's quantizer does under ``jit`` (the jitted step is its
  production form): ``v = g + err``, the scale as ``fmaf(absmax,
  fl32(1/127), fl32(1e-12))``, and the new error as ``fma(-q, scale,
  v)``, rounded once.

Wire format, as in the reference: the all-reduce moves the dequantized
fp32 values (the gradients' own dtype for ``none``), and
:data:`COMPRESSION_RATIO` is the modeled ratio of a wire that would carry
the compressed form; :func:`wire_bytes` reports both.  The step updates
params, velocity and error state in place (the reference's jitted step
donates them and returns new ones).
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.comms import schedules
from repro_torch.core import precision
from repro_torch.kernels import ops

Tensors = Dict[str, torch.Tensor]

COMPRESSION_RATIO = {"none": 1.0, "onebit": 1.0 / 32.0, "int8": 1.0 / 4.0}


def quantize_onebit(g: torch.Tensor, err: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """sign(g+err) * mean|g+err|; returns (q, new_err).  The mean is the
    sum times fl32(1/numel), as XLA compiles the reference's ``jnp.mean``
    (a division by a count)."""
    v = g.float() + err
    scale = precision.div_count(torch.sum(torch.abs(v)), v.numel())
    q = torch.sign(v) * scale
    return q, v - q


def quantize_int8(g: torch.Tensor, err: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dequantized values, new_err) of ``v = g + err``: int8 against
    ``v``'s own absmax scale, ``deq = q * scale`` in fp32, and the new
    error ``fma(-q, scale, v)``.  New tensors; ``g`` and ``err`` are left
    as they are."""
    deq, new_err, _ = ops.quantize_compress_ef(g, err)
    return deq, new_err


_QUANTIZERS: Dict[str, Callable] = {
    "onebit": quantize_onebit,
    "int8": quantize_int8,
}


def compressed_psum(grads: Tensors, errs: Tensors,
                    group: Optional[dist.ProcessGroup] = None,
                    scheme: str = "onebit") -> Tuple[Tensors, Tensors]:
    """Quantize with error feedback locally, then the group mean, leaf by
    leaf.  Returns (reduced grads, new errs); ``scheme='none'`` is the
    exact baseline (the gradients' mean in their dtype, the error state
    returned as it is)."""
    if scheme == "none":
        return {k: schedules.pmean(g, group) for k, g in grads.items()}, errs
    quant = _QUANTIZERS[scheme]
    reduced, new_errs = {}, {}
    for name, g in grads.items():
        q, new_errs[name] = quant(g, errs[name])
        reduced[name] = schedules.pmean(q, group)
    return reduced, new_errs


def init_error_state(params: Mapping[str, torch.Tensor]) -> Tensors:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def wire_bytes(params: Mapping[str, torch.Tensor], scheme: str
               ) -> Dict[str, float]:
    """Bytes one rank sends into the all-reduce per step: ``physical``,
    what this implementation moves (fp32 dequantized values, or the
    gradients' dtype for ``none``), and ``modeled``, the fp32 gradient
    bytes times :data:`COMPRESSION_RATIO` (the reference's accounting)."""
    n = sum(p.numel() for p in params.values())
    physical = (sum(p.numel() * p.element_size() for p in params.values())
                if scheme == "none" else 4 * n)
    return {"physical": float(physical),
            "modeled": 4.0 * n * COMPRESSION_RATIO[scheme]}


def _local_rows(batch, n: int, rank: int):
    """This rank's contiguous share of every leaf's rows (``P(axis)``)."""
    if isinstance(batch, Mapping):
        return {k: _local_rows(v, n, rank) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(_local_rows(v, n, rank) for v in batch)
    rows = batch.shape[0]
    if rows % n:
        raise ValueError(f"a batch of {rows} rows does not split over {n} "
                         "ranks")
    return batch.chunk(n)[rank]


def build_dp_sgd_step(loss_fn: Callable, group: Optional[dist.ProcessGroup]
                      = None, scheme: str = "onebit", lr: float = 0.1,
                      momentum: float = 0.9) -> Callable:
    """Explicit data-parallel SGD with momentum and a compressed gradient
    all-reduce over ``group`` (the default group when None).

    ``loss_fn(params, batch) -> scalar`` on local data; ``params`` (a dict
    of leaves that require grad), ``vel`` and ``err`` are replicated, the
    batch (a tensor, or a dict, tuple or list of them) is the global one,
    split by rows over the ranks.  ``step(params, vel, err, batch)``
    updates all three in place and returns ``{"loss": the local loss,
    "grads": the reduced gradients it applied}``.

    The dtypes follow the reference's: ``vel = momentum * vel - lr * g``
    stays in the params' dtype while ``g`` does (``none`` on bf16 params)
    and becomes fp32 after one compressed step (bf16 times a float minus
    fp32 promotes); params are updated as ``p + vel.to(p.dtype)``."""
    if scheme not in COMPRESSION_RATIO:
        raise ValueError(f"unknown scheme {scheme!r}; expected one of "
                         f"{sorted(COMPRESSION_RATIO)}")
    n = dist.get_world_size(group)
    rank = dist.get_rank(group)

    def step(params: Tensors, vel: Tensors, err: Tensors, batch):
        names = list(params)
        with torch.enable_grad():
            loss = loss_fn(params, _local_rows(batch, n, rank))
            grads = dict(zip(names, torch.autograd.grad(
                loss, [params[k] for k in names])))
        synced, new_err = compressed_psum(grads, err, group, scheme)
        with torch.no_grad():
            for k in names:
                vel[k] = momentum * vel[k] - lr * synced[k]
                params[k].add_(vel[k].to(params[k].dtype))
        err.update(new_err)
        return {"loss": loss.detach(), "grads": synced}

    return step
