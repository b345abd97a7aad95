"""Process groups, the device mesh over them, and the counted collectives
the linear-algebra layer moves blocks with.

Nothing tells a program of its cluster: each rank is given its rank, the
world size and a rendezvous address, here or through ``RANK``,
``WORLD_SIZE`` and ``DMATH_INIT_METHOD`` (a ``file://`` path or
``tcp://127.0.0.1:<port>``).  A rank on the card first makes its device
current.  :func:`init_group` takes NCCL when every rank has a card of
its own and gloo otherwise (:func:`select_backend`): several ranks can
share one card through gloo (NCCL refuses two ranks on one device), and
gloo stages a CUDA tensor through host memory for a collective
(:func:`exchange` does so itself, on gloo only).

A :class:`Mesh` names the axes of a grid of ranks, as ``jax.make_mesh``
does of devices: rank r of the group sits at ``np.unravel_index(r,
shape)``, row-major, the order ``jax.make_mesh`` gives fake CPU devices.
Each axis has one process group per line of ranks along it.  Every
collective below runs over one axis's line (a tuple of axes: one axis at
a time, minor first), counts the bytes this rank receives from the others
in :data:`WIRE`, and is the identity on an axis of one rank.

gloo on CUDA tensors (PyTorch 2.11, ``scripts/gloo_cuda_coverage.py`` on
the card): ``all_gather`` and ``all_to_all_single`` take fp32 and bf16;
``all_reduce`` and ``reduce_scatter`` sum them, but at 4 ranks not in
rank order; point-to-point sends of a CUDA tensor end the process
(gloo's TCP transport reads the device pointer from the host), so
:func:`exchange` copies through host memory itself, and so does
:func:`broadcast`.  A reduce-scatter is
an all-to-all and then the rank-ordered sum of the pieces (the bytes of a
ring reduce-scatter, and the reference's order of adds); an all-reduce is
``comms.schedules.group_reduce`` on the axis's group (rank order).
"""

from __future__ import annotations

import collections
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.device import resolve_device


def select_backend(device_type: str, device_count: int, world_size: int,
                   local_rank: int) -> str:
    """The backend :func:`init_group` takes by default: ``nccl`` when every
    rank of the group has a card of its own (on the card, at least as many
    cards as ranks, this rank's card ``cuda:<local_rank>``), ``gloo``
    otherwise: on the CPU, and for ranks that share a card, which NCCL
    refuses.  Nothing tells a program of a cluster, so the ranks are taken
    to be on one machine."""
    if device_type == "cuda" and world_size <= device_count \
            and 0 <= local_rank < device_count:
        return "nccl"
    return "gloo"


def init_group(init_method: Optional[str] = None, *,
               rank: Optional[int] = None, world_size: Optional[int] = None,
               backend: Optional[str] = None,
               device: Union[str, torch.device] = "cuda"
               ) -> dist.ProcessGroup:
    """Join the default process group and return it.  ``backend=None``
    takes :func:`select_backend`'s choice for this machine's cards (the
    local rank is ``LOCAL_RANK``, else the rank).  On the card the rank's
    device becomes current first: ``cuda:<local rank>`` under NCCL when
    ``device`` names no index, else the one given (``cuda:0`` unless
    given)."""
    dev = resolve_device(device)
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None
                  else world_size)
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if backend is None:
        backend = select_backend(
            dev.type, torch.cuda.device_count() if dev.type == "cuda" else 0,
            world_size, local_rank)
    if dev.type == "cuda":
        index = dev.index
        if index is None:
            index = local_rank if backend == "nccl" else 0
        torch.cuda.set_device(index)
    init_method = init_method or os.environ["DMATH_INIT_METHOD"]
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    return dist.group.WORLD


def close_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

class Mesh:
    """Named axes over the ranks of a process group.

    ``Mesh(shape, axes)`` alone (no group) serves the layout algebra and
    the GEMM planner, which need only the axis sizes (a mesh of one
    position also takes blocks).  With a ``group`` the mesh must cover it
    exactly, and every rank creates every line's group in the same order
    (``dist.new_group`` is collective): an axis of one rank needs none,
    and an axis that spans the whole group uses the group itself."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 group: Optional[dist.ProcessGroup] = None):
        shape, axes = tuple(int(s) for s in shape), tuple(axes)
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes} differ "
                             "in length")
        self.axis_names = axes
        self.shape: Dict[str, int] = collections.OrderedDict(zip(axes, shape))
        self.size = math.prod(shape)
        # mesh position -> rank of the group, row-major
        self.devices = np.arange(self.size).reshape(shape)
        self.group = group
        self._lines: Dict[str, Tuple[Optional[dist.ProcessGroup],
                                     List[int]]] = {}
        rank = 0 if self.size == 1 else None
        if group is not None:
            n = dist.get_world_size(group)
            if n != self.size:
                raise ValueError(f"a mesh of shape {dict(self.shape)} needs "
                                 f"{self.size} ranks; the group has {n}")
            rank = dist.get_rank(group)
            self._global = dist.get_process_group_ranks(group)
            self._build_lines(rank)
        self.rank = rank
        self.coords: Optional[Dict[str, int]] = None
        if rank is not None:
            self.coords = dict(zip(axes, (int(i) for i in np.unravel_index(
                rank, shape))))

    def _build_lines(self, rank: int) -> None:
        me = np.unravel_index(rank, self.devices.shape)
        for a, name in enumerate(self.axis_names):
            moved = np.moveaxis(self.devices, a, -1)
            lines = moved.reshape(-1, moved.shape[-1])
            mine = [int(r) for r in moved[tuple(np.delete(me, a))]]
            ranks = [self._global[r] for r in mine]
            if len(mine) == 1:
                self._lines[name] = (None, ranks)
            elif len(mine) == self.size:
                self._lines[name] = (self.group, ranks)
            else:
                for line in lines:
                    members = [self._global[int(r)] for r in line]
                    g = dist.new_group(members)
                    if members == ranks:
                        self._lines[name] = (g, ranks)

    def axis_group(self, axis: str) -> Optional[dist.ProcessGroup]:
        """The process group of this rank's line along ``axis`` (None on
        an axis of one rank)."""
        return self._line(axis)[0]

    def line_ranks(self, axis: str) -> List[int]:
        """Global ranks of this rank's line along ``axis``, by index."""
        return self._line(axis)[1]

    def _line(self, axis: str):
        if self.group is None:
            raise ValueError("this mesh has no process group: it serves the "
                             "layout algebra only")
        return self._lines[axis]

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)}, rank={self.rank})"


# ---------------------------------------------------------------------------
# counted collectives
# ---------------------------------------------------------------------------

class WireCounter:
    """Bytes this rank received from other ranks by collective, the calls
    by collective and the dtypes that crossed, since the last
    :meth:`reset`."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.bytes: Dict[str, int] = collections.defaultdict(int)
        self.calls: Dict[str, int] = collections.defaultdict(int)
        self.dtypes: set = set()

    def record(self, op: str, nbytes: int, dtype: torch.dtype) -> None:
        self.bytes[op] += int(nbytes)
        self.calls[op] += 1
        self.dtypes.add(dtype)

    def total(self) -> int:
        return sum(self.bytes.values())


WIRE = WireCounter()


def _axes(axis) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def all_gather(x: torch.Tensor, mesh: Mesh, axis, dim: int) -> torch.Tensor:
    """Concatenate the line's blocks along ``dim`` in axis order (tiled,
    as ``jax.lax.all_gather(..., tiled=True)``); a tuple of axes gathers
    the minor one first."""
    for name in reversed(_axes(axis)):
        n = mesh.shape[name]
        if n == 1:
            continue
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=mesh.axis_group(name))
        WIRE.record("all_gather", (n - 1) * _nbytes(x), x.dtype)
        x = torch.cat(parts, dim)
    return x


def all_to_all(x: torch.Tensor, mesh: Mesh, axis: str, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """Split ``x`` along ``split_dim`` into one piece per rank of the line,
    send piece k to rank k, and concatenate what arrives along
    ``concat_dim`` in axis order (``jax.lax.all_to_all``, tiled)."""
    pieces = _exchange_pieces(x, mesh, axis, split_dim)
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, concat_dim)


def _exchange_pieces(x: torch.Tensor, mesh: Mesh, axis: str,
                     split_dim: int) -> List[torch.Tensor]:
    """The all-to-all's received pieces, by source rank."""
    n = mesh.shape[axis]
    if n == 1:
        return [x]
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} "
                         f"does not split over {n} ranks")
    send = torch.stack(x.chunk(n, split_dim)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.axis_group(axis))
    WIRE.record("all_to_all", (n - 1) * _nbytes(send[0]), x.dtype)
    return list(recv.unbind(0))


def psum(x: torch.Tensor, mesh: Mesh, axis) -> torch.Tensor:
    """The sum over the line, the same on every rank: a floating sum adds
    the ranks in order (``comms.schedules.group_reduce``)."""
    from repro_torch.comms import schedules
    for name in reversed(_axes(axis)):
        n = mesh.shape[name]
        if n == 1:
            continue
        ordered = x.is_floating_point() and n > 2
        # the ordered sum gathers the line's tensors; the backend's
        # all-reduce receives 2 (n - 1) / n of one (n = 2: one tensor)
        WIRE.record("all_reduce", (n - 1) * _nbytes(x) if ordered
                    else 2 * (n - 1) * _nbytes(x) // n, x.dtype)
        x = schedules.group_reduce(x.contiguous(), mesh.axis_group(name))
    return x


def psum_scatter(x: torch.Tensor, mesh: Mesh, axis,
                 dim: int) -> torch.Tensor:
    """This rank's piece along ``dim`` of the line's sum (tiled
    ``jax.lax.psum_scatter``): an all-to-all of the pieces, then their
    sum in rank order, a 16-bit type in fp32 and rounded once.  A tuple
    of axes scatters the major one first (the transpose of
    :func:`all_gather`)."""
    for name in _axes(axis):
        pieces = _exchange_pieces(x, mesh, name, dim)
        if len(pieces) == 1:
            continue
        acc = pieces[0].to(torch.promote_types(x.dtype, torch.float32))
        for p in pieces[1:]:
            acc += p
        x = acc.to(x.dtype)
    return x


def pmax(x: torch.Tensor, mesh: Mesh, axis) -> torch.Tensor:
    """The elementwise maximum over the line, the same on every rank (an
    all-gather of the line's tensors: a maximum is exact in any order)."""
    for name in reversed(_axes(axis)):
        if mesh.shape[name] > 1:
            x = all_gather(x[None], mesh, name, 0).amax(0)
    return x


def broadcast(x: torch.Tensor, mesh: Mesh, axis: str, src: int
              ) -> torch.Tensor:
    """The line's index-``src`` rank's ``x`` on every rank of the line
    (written into ``x`` on the others, which pass a buffer of its shape
    and dtype).  On a gloo group a CUDA tensor travels as a host copy, as
    in :func:`exchange`.  A receiving rank counts the tensor's bytes."""
    if mesh.shape[axis] == 1:
        return x
    group = mesh.axis_group(axis)
    x = x.contiguous()
    staged = dist.get_backend(group) == "gloo" and x.is_cuda
    buf = x.cpu() if staged else x
    dist.broadcast(buf, mesh.line_ranks(axis)[src], group=group)
    if staged:
        x.copy_(buf)
    if mesh.coords[axis] != src:
        WIRE.record("broadcast", _nbytes(x), x.dtype)
    return x


def exchange(sends: Dict[int, torch.Tensor], recvs: Dict[int, torch.Tensor],
             mesh: Mesh, axis: str) -> None:
    """Point-to-point along ``axis``: ``sends[i]`` goes to the line's rank
    of index i, and ``recvs[j]`` is filled from index j, all at once
    (``dist.batch_isend_irecv``).  On a gloo group CUDA tensors travel as
    host copies (gloo cannot send device memory)."""
    if not sends and not recvs:
        return
    ranks, group = mesh.line_ranks(axis), mesh.axis_group(axis)
    staged = (dist.get_backend(group) == "gloo"
              and any(t.is_cuda for t in [*sends.values(), *recvs.values()]))
    host = (lambda t: t.cpu()) if staged else (lambda t: t.contiguous())
    out = {j: (torch.empty(t.shape, dtype=t.dtype) if staged else t)
           for j, t in recvs.items()}
    ops = ([dist.P2POp(dist.isend, host(t), ranks[i], group)
            for i, t in sends.items()]
           + [dist.P2POp(dist.irecv, t, ranks[j], group)
              for j, t in out.items()])
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    for j, t in recvs.items():
        WIRE.record("send_recv", _nbytes(t), t.dtype)
        if staged:
            t.copy_(out[j])


# ---------------------------------------------------------------------------
# differentiable collectives
# ---------------------------------------------------------------------------
#
# Each rank differentiates its own blocks.  A rank holds the whole
# gradient of every value it holds (Megatron's convention): where a value
# the line shares feeds work split over the line, each rank's backward
# gives a share, and the split's entry sums the shares.  So each
# collective below has its transpose as its backward, which runs the same
# counted collectives (``WIRE`` counts both directions), and ``dtype``
# keeps the wire narrow both ways: the forward casts ``x`` to ``dtype``
# before a narrowing collective and after a widening one, and the
# backward casts the gradient back to ``x``'s dtype the same way.

def _on_wire(fn, x: torch.Tensor, dtype: Optional[torch.dtype]):
    if dtype is None or dtype == x.dtype:
        return fn(x)
    if dtype.itemsize < x.dtype.itemsize:
        return fn(x.to(dtype))
    return fn(x).to(dtype)


class _Collective(torch.autograd.Function):
    """``fwd`` forward, ``bwd`` (its transpose) backward."""

    @staticmethod
    def forward(ctx, x, fwd, bwd, dtype):
        ctx.bwd, ctx.dtype = bwd, x.dtype
        out = _on_wire(fwd, x, dtype)
        return out.view_as(out) if out is x else out

    @staticmethod
    def backward(ctx, g):
        return _on_wire(ctx.bwd, g.contiguous(), ctx.dtype), None, None, None


def all_gather_ad(x: torch.Tensor, mesh: Mesh, axis, dim: int,
                  dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """:func:`all_gather` of a block whose gathered value feeds work split
    over ``axis``; backward: the reduce-scatter of the shares."""
    return _Collective.apply(
        x, lambda t: all_gather(t, mesh, axis, dim),
        lambda g: psum_scatter(g, mesh, axis, dim), dtype)


def psum_scatter_ad(x: torch.Tensor, mesh: Mesh, axis, dim: int,
                    dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """:func:`psum_scatter` of this rank's share; backward: the all-gather
    of the pieces' gradients (each share's gradient is the sum's)."""
    return _Collective.apply(
        x, lambda t: psum_scatter(t, mesh, axis, dim),
        lambda g: all_gather(g, mesh, axis, dim), dtype)


def all_to_all_ad(x: torch.Tensor, mesh: Mesh, axis: str, split_dim: int,
                  concat_dim: int,
                  dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """:func:`all_to_all`; backward: the inverse all-to-all."""
    return _Collective.apply(
        x, lambda t: all_to_all(t, mesh, axis, split_dim, concat_dim),
        lambda g: all_to_all(g, mesh, axis, concat_dim, split_dim), dtype)


def psum_ad(x: torch.Tensor, mesh: Mesh, axis,
            dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """:func:`psum` of shares (Megatron's g): every rank holds the sum,
    and each share's gradient is the sum's, so the backward is the
    identity."""
    return _Collective.apply(x, lambda t: psum(t, mesh, axis),
                             lambda g: g, dtype)


def copy_ad(x: torch.Tensor, mesh: Mesh, axis) -> torch.Tensor:
    """The identity on a value every rank of the line holds, entering work
    split over ``axis`` (Megatron's f): the backward sums the ranks'
    shares (:func:`psum`)."""
    return _Collective.apply(x, lambda t: t, lambda g: psum(g, mesh, axis),
                             None)
