"""Gradient bucketing: coalesce many gradient tensors into few 1-D
buckets, ported from the reference's ``comms/bucketer.py``.

The plan is deterministic, and it is the reference's plan: leaves are
packed greedily in the reference's pytree-flatten order, which sorts the
keys of every nested dict.  The port's flat parameter dict keeps spec
insertion order (embed, unembed, final_norm, layers.*), so the leaves are
first ordered by their dotted paths taken as tuples of keys.  The order
decides which leaves share a bucket, hence each bucket's absmax and the
int8 wire's scale, so every int8 value depends on it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

DEFAULT_BUCKET_BYTES = 32 * 1024 * 1024


@dataclasses.dataclass(frozen=True)
class _Slot:
    bucket: int      # which bucket this leaf landed in
    offset: int      # element offset inside the bucket
    size: int        # number of elements


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """Static packing of a flat tensor dict into 1-D buckets."""

    names: Tuple[str, ...]               # leaves in packing order
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    slots: Tuple[_Slot, ...]
    bucket_sizes: Tuple[int, ...]        # elements per bucket
    dtype: torch.dtype                   # bucket compute dtype

    @property
    def num_buckets(self) -> int:
        return len(self.bucket_sizes)


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def tree_order(names) -> List[str]:
    """The reference's leaf order for dotted paths: nested dict keys
    sorted at every level."""
    return sorted(names, key=lambda n: tuple(n.split(".")))


def plan_buckets(tree: Mapping[str, torch.Tensor],
                 bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                 dtype: torch.dtype = torch.float32) -> BucketPlan:
    """Greedy first-fit packing in the reference's leaf order.  A bucket
    closes when the next leaf would push it past ``bucket_bytes``; a leaf
    larger than the budget gets a bucket of its own."""
    cap = max(1, bucket_bytes // _itemsize(dtype))
    names = tree_order(tree)
    shapes, dtypes, slots = [], [], []
    bucket_sizes: List[int] = []
    cur_fill = 0
    for name in names:
        leaf = tree[name]
        size = int(leaf.numel())
        shapes.append(tuple(leaf.shape))
        dtypes.append(leaf.dtype)
        if not bucket_sizes or (cur_fill and cur_fill + size > cap):
            bucket_sizes.append(0)
            cur_fill = 0
        slots.append(_Slot(bucket=len(bucket_sizes) - 1, offset=cur_fill,
                           size=size))
        cur_fill += size
        bucket_sizes[-1] = cur_fill
    return BucketPlan(names=tuple(names), shapes=tuple(shapes),
                      dtypes=tuple(dtypes), slots=tuple(slots),
                      bucket_sizes=tuple(bucket_sizes), dtype=dtype)


def _parts(plan: BucketPlan, tree: Mapping[str, torch.Tensor]
           ) -> List[List[torch.Tensor]]:
    """Each bucket's leaves, flattened, in packing order."""
    if set(tree) != set(plan.names):
        raise ValueError("tree does not match the bucket plan")
    parts: List[List[torch.Tensor]] = [[] for _ in range(plan.num_buckets)]
    for name, slot in zip(plan.names, plan.slots):
        parts[slot.bucket].append(tree[name].reshape(-1))
    return parts


def _cat(pieces: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat(list(pieces)) if len(pieces) > 1 else pieces[0]


def flatten_buckets(plan: BucketPlan, tree: Mapping[str, torch.Tensor]
                    ) -> List[torch.Tensor]:
    """Pack the leaves into the plan's 1-D buckets (cast to the bucket
    dtype)."""
    return [_cat([x.to(plan.dtype) for x in p]) for p in _parts(plan, tree)]


def flatten_buckets_fused(plan: BucketPlan, tree: Mapping[str, torch.Tensor],
                          wire_dtype: str
                          ) -> Tuple[List[torch.Tensor],
                                     Optional[List[torch.Tensor]]]:
    """Pack the leaves AND fold the wire format's prologue into the pass.

    - ``bf16``: each leaf narrows while being packed, so the buckets come
      out in the wire dtype;
    - ``int8``: buckets stay in the plan dtype, and each bucket's local
      absmax comes out of the same pass as a max of per-leaf maxes (a
      floating max is exact: bit-identical to reducing the packed bucket).

    Returns ``(buckets, absmaxes)``; ``absmaxes`` (0-d fp32 tensors) is
    None unless int8."""
    parts = _parts(plan, tree)
    if wire_dtype == "bf16":
        return ([_cat([x.to(plan.dtype).to(torch.bfloat16) for x in p])
                 for p in parts], None)
    if wire_dtype == "int8":
        buckets, absmaxes = [], []
        for p in parts:
            flat = [x.to(plan.dtype) for x in p]
            buckets.append(_cat(flat))
            absmaxes.append(torch.max(torch.stack(
                [torch.max(torch.abs(x.float())) for x in flat])))
        return buckets, absmaxes
    raise ValueError(f"no fused flatten for wire_dtype {wire_dtype!r}")


def unflatten_buckets(plan: BucketPlan, buckets: Sequence[torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """Invert :func:`flatten_buckets`, restoring shapes and dtypes."""
    out = {}
    for name, shape, dt, slot in zip(plan.names, plan.shapes, plan.dtypes,
                                     plan.slots):
        piece = buckets[slot.bucket][slot.offset:slot.offset + slot.size]
        out[name] = piece.reshape(shape).to(dt)
    return out
