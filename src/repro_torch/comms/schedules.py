"""Explicit all-reduce schedules over the named axes of a
:class:`~repro_torch.core.distributed.Mesh`, ported from the reference's
``comms/schedules.py``.

dMath picks the schedule per message (paper §3.2, §4): ring for
bandwidth, tree for latency, the two-level reduce across nodes.  Each
function reduces this rank's tensor over one or two mesh axes and gives
every rank of the line the same bits, the reference's:

- :func:`ring_all_reduce`: chunked ring, a reduce-scatter then an
  all-gather by point-to-point steps, 2(n-1) of them.  Chunk c's sum
  starts on the line's rank c and adds in ring order, one rounding per
  step in the tensor's dtype (a bf16 bucket rounds at every hop).
- :func:`reduce_scatter_all_gather`: the same dataflow as the counted
  ``psum_scatter`` (the pieces' rank-ordered sum, a 16-bit type in fp32
  and rounded once) and ``all_gather``.
- :func:`tree_all_reduce`: recursive doubling, log2(n) whole-buffer
  exchanges (``x + partner`` is the same on both partners); a line that
  is not a power of two falls back to ``psum``, as the reference's does.
  A line of two is its one level, ``x0 + x1``, which the backend's
  all-reduce gives in the same bits (gathered and added in the wider
  type where the last add is widened).
- :func:`hierarchical_all_reduce`: a reduce-scatter on the fast axis, a
  ``psum`` of the 1/n_intra slice on the slow one, an all-gather on the
  fast one.

The ring's and the tree's steps go through
:func:`~repro_torch.core.distributed.exchange`.  On a gloo group a CUDA
tensor cannot be sent point to point (gloo ends the process), so every
step is a round trip through host memory: 2(n-1) of them a ring bucket,
log2(n) a tree bucket.  The bytes each rank receives are counted in
``distributed.WIRE``.

``psum`` (:func:`group_reduce` on one process group) adds the ranks in
rank order, as XLA's all-reduce does (``(x0 + x1) + x2``, a 16-bit type
in fp32 and rounded once).  A backend's ring starts each chunk's sum at
another rank, which differs from three ranks on: there
:func:`ordered_sum` gathers the group's tensors and adds them in order,
at (n - 1) tensors received per rank.  Two addends sum the same in either
order, so a group of two, like integer sums (exact in any order) and
MAX, goes to ``torch.distributed.all_reduce``: on two gloo ranks sharing
an H100, over qwen2-0.5b's 15 gradient leaves, the backend's sum took
0.60–0.64 of the gathered one's time for the same bits
(``scripts/gloo_sum_cost.py``).  On a gloo group a CUDA tensor goes to
the collective as it is: gloo stages it through host memory.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import distributed as dist_mod
from repro_torch.core import precision

def group_reduce(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None,
                 op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Reduce ``x`` over a process group (sum by default) and return the
    result in ``x``'s dtype: a new tensor for a floating sum (``x`` is
    left as it is), ``x`` reduced in place otherwise."""
    if x.is_floating_point():
        if op == dist.ReduceOp.SUM and dist.get_world_size(group) > 2:
            return ordered_sum(x, group)
        x = x.clone()             # a floating result is a new tensor
    dist.all_reduce(x, op=op, group=group)
    return x


def ordered_sum(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None
                ) -> torch.Tensor:
    """The group's sum of ``x`` added in rank order, a 16-bit type in fp32
    and rounded once: every rank gathers the group's tensors and adds
    them, so every rank gets the same bits, the reference's."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return _add_in_order(parts, x.dtype)


def _add_in_order(parts, dtype: torch.dtype) -> torch.Tensor:
    acc = parts[0].to(torch.promote_types(dtype, torch.float32))
    for p in parts[1:]:
        acc += p
    return acc.to(dtype)


def pmean(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None
          ) -> torch.Tensor:
    """The group mean as XLA compiles the reference's ``pmean``: the sum,
    rounded to ``x``'s dtype, times fl32(1/n) (a 16-bit sum widened for
    the multiply and rounded once more)."""
    n = dist.get_world_size(group)
    return precision.div_count(group_reduce(x, group), n)


# ---------------------------------------------------------------------------
# the schedules
# ---------------------------------------------------------------------------

def _flatten_chunks(x: torch.Tensor, n: int) -> Tuple[torch.Tensor, int]:
    """``x`` flattened and zero-padded to (n, chunk); (buf, size)."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(n, -1).clone(), x.numel()


def _unflatten(buf: torch.Tensor, size: int, shape) -> torch.Tensor:
    return buf.reshape(-1)[:size].reshape(shape)


def ring_all_reduce(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Chunked ring all-reduce over ``axis``: n - 1 accumulate steps
    (after which index i holds the whole sum of chunk (i + 1) mod n) and
    n - 1 gather steps, each moving 1/n of the buffer to the next index."""
    n = mesh.shape[axis]
    if n <= 1:
        return x
    buf, size = _flatten_chunks(x, n)
    i = mesh.coords[axis]
    nxt, prv = (i + 1) % n, (i - 1) % n
    recv = torch.empty_like(buf[0])
    # reduce-scatter: at step s index i sends its running sum of chunk
    # (i - s) and adds the incoming chunk (i - s - 1) to its own
    for s in range(n - 1):
        dist_mod.exchange({nxt: buf[(i - s) % n]}, {prv: recv}, mesh, axis)
        buf[(i - s - 1) % n] += recv
    # all-gather: circulate the reduced chunks
    for s in range(n - 1):
        dist_mod.exchange({nxt: buf[(i + 1 - s) % n]}, {prv: recv}, mesh,
                          axis)
        buf[(i - s) % n] = recv
    return _unflatten(buf, size, x.shape)


def reduce_scatter_all_gather(x: torch.Tensor, mesh, axis: str
                              ) -> torch.Tensor:
    """All-reduce as a reduce-scatter and an all-gather over ``axis``
    (the counted ``psum_scatter`` and ``all_gather``)."""
    n = mesh.shape[axis]
    if n <= 1:
        return x
    buf, size = _flatten_chunks(x, n)
    part = dist_mod.psum_scatter(buf.reshape(-1), mesh, axis, 0)
    out = dist_mod.all_gather(part, mesh, axis, 0)
    return _unflatten(out, size, x.shape)


def tree_all_reduce(x: torch.Tensor, mesh, axis: str,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Recursive-doubling all-reduce: log2(n) whole-buffer exchanges with
    the index i ^ d.  A line whose size is not a power of two falls back
    to ``psum`` (the cost model still prices log2(n) steps).

    With a wider ``out_dtype`` the last level adds in it: XLA keeps the
    reference's last add unrounded when its result is only widened
    (excess precision), where every earlier add is rounded by the
    collective that takes it.

    A line of two is one level, the sum of two addends, the same in
    either order: it goes to the backend's all-reduce (one tensor
    received, as by the exchange), or with a wider ``out_dtype`` to an
    all-gather added in that type.  On gloo the exchange copies the whole
    bucket to the host, sends it and copies it back; the backend's
    all-reduce stages the same bytes without that round trip."""
    n = mesh.shape[axis]
    if n <= 1:
        return x
    if n & (n - 1):
        return dist_mod.psum(x, mesh, axis)
    if n == 2:
        if out_dtype is None or out_dtype == x.dtype:
            return dist_mod.psum(x, mesh, axis)
        a, b = dist_mod.all_gather(x.contiguous()[None], mesh, axis, 0)
        return a.to(out_dtype) + b.to(out_dtype)
    i = mesh.coords[axis]
    x = x.contiguous()
    d = 1
    while d < n:
        recv = torch.empty_like(x)
        dist_mod.exchange({i ^ d: x}, {i ^ d: recv}, mesh, axis)
        if 2 * d >= n and out_dtype is not None:
            x = x.to(out_dtype) + recv.to(out_dtype)
        else:
            x = x + recv
        d *= 2
    return x


def hierarchical_all_reduce(x: torch.Tensor, mesh, intra_axis: str,
                            inter_axis: str) -> torch.Tensor:
    """Two-level all-reduce (paper §4): a reduce-scatter over the fast
    ``intra_axis`` leaves each rank a 1/n_intra slice of the node's sum,
    only that slice is summed over the slow ``inter_axis``, and an
    all-gather over ``intra_axis`` rebuilds the buffer."""
    buf, size = _flatten_chunks(x, mesh.shape[intra_axis])
    part = dist_mod.psum_scatter(buf.reshape(-1), mesh, intra_axis, 0)
    part = dist_mod.psum(part, mesh, inter_axis)
    out = dist_mod.all_gather(part, mesh, intra_axis, 0)
    return _unflatten(out, size, x.shape)


def psum(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """The reference's ``jax.lax.psum(x, axes)``: one sum over the group
    of every rank along ``axes``, in the group's order (row-major over
    the axes as given).  One axis is :func:`group_reduce` on its line;
    several are gathered and added in that order, a 16-bit type in fp32
    and rounded once."""
    axes = tuple(a for a in axes if mesh.shape[a] > 1)
    if len(axes) <= 1:
        return dist_mod.psum(x, mesh, axes) if axes else x
    parts = dist_mod.all_gather(x.contiguous()[None], mesh, axes, 0)
    if not x.is_floating_point():
        return parts.sum(0, dtype=x.dtype)
    return _add_in_order(list(parts.unbind(0)), x.dtype)


def all_reduce(x: torch.Tensor, mesh, axes: Sequence[str],
               schedule: str = "psum", intra_axis: str = "model", *,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One all-reduce of ``x`` over the mesh ``axes`` by schedule name,
    in ``out_dtype`` (``x``'s dtype by default; a wider one changes only
    the tree's last add, see :func:`tree_all_reduce`).

    A tuple of axes reduces one axis after another in the order given,
    except ``psum`` (one sum over the whole group) and ``hier``, which
    takes the fast ``intra_axis`` (the last axis if it is not among
    ``axes``) and one slow axis, summing any further axes first with
    ``psum``; on one axis ``hier`` is ``rsag``."""
    axes = tuple(axes)
    out_dtype = out_dtype or x.dtype
    if not axes:
        return x.to(out_dtype)
    if schedule == "psum":
        return psum(x, mesh, axes).to(out_dtype)
    if schedule == "hier":
        if len(axes) == 1:
            return reduce_scatter_all_gather(x, mesh, axes[0]).to(out_dtype)
        intra = intra_axis if intra_axis in axes else axes[-1]
        inters = tuple(a for a in axes if a != intra)
        for extra in inters[1:]:          # > 2 axes: fold extras with psum
            x = psum(x, mesh, (extra,))
        return hierarchical_all_reduce(x, mesh, intra,
                                       inters[0]).to(out_dtype)
    wider = out_dtype if out_dtype != x.dtype else None
    for k, ax in enumerate(axes):
        if schedule == "ring":
            x = ring_all_reduce(x, mesh, ax)
        elif schedule == "rsag":
            x = reduce_scatter_all_gather(x, mesh, ax)
        elif schedule == "tree":
            x = tree_all_reduce(x, mesh, ax,
                                wider if k == len(axes) - 1 else None)
        else:
            raise ValueError(f"unknown schedule {schedule!r}")
    return x.to(out_dtype)
