"""Stage partitioner: split a model's layer stack across the ``pipe``
axis, ported from the reference's ``pipeline/partition.py``.

The partitioner works on the memory model (``core/memory.py``): each
layer's parameter bytes come from the model's stacked ``layers.*`` specs,
and the stages are the contiguous partition that minimizes the heaviest
stage (the balanced-chains problem, solved exactly by a DP: L and S are
small).

For the homogeneous stacks the port trains (every layer the same specs)
the balanced partition is the uniform split, which is also what the
executable path needs: a rank holds dim 0 of each stacked leaf sliced
over ``pipe``, in equal blocks.  Heterogeneous stacks still get a report
(per-stage bytes and imbalance) so a planner can refuse a degree that
would not balance.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

from repro_torch.core import memory


@dataclasses.dataclass(frozen=True)
class StagePartition:
    """Contiguous split of L layers into S pipeline stages."""

    boundaries: Tuple[int, ...]      # S+1 ints: [0, ..., L]
    stage_bytes: Tuple[int, ...]     # memory-model bytes per stage

    @property
    def n_stages(self) -> int:
        return len(self.boundaries) - 1

    @property
    def n_layers(self) -> int:
        return self.boundaries[-1]

    @property
    def sizes(self) -> Tuple[int, ...]:
        return tuple(b - a for a, b in zip(self.boundaries,
                                           self.boundaries[1:]))

    @property
    def is_uniform(self) -> bool:
        return len(set(self.sizes)) <= 1

    @property
    def imbalance(self) -> float:
        """max/mean - 1 of per-stage bytes (0.0 == perfectly balanced)."""
        if not self.stage_bytes or sum(self.stage_bytes) == 0:
            return 0.0
        mean = sum(self.stage_bytes) / len(self.stage_bytes)
        return max(self.stage_bytes) / mean - 1.0


def partition_layers(per_layer_bytes: Sequence[float],
                     n_stages: int) -> StagePartition:
    """Balanced contiguous partition (minimize the heaviest stage).

    Exact O(L^2 * S) DP.  Ties break toward the uniform boundary, so
    equal-weight layers yield the uniform split whenever ``L % S == 0``.
    """
    w = [float(x) for x in per_layer_bytes]
    L = len(w)
    if n_stages < 1:
        raise ValueError(f"n_stages must be >= 1, got {n_stages}")
    if n_stages > L:
        raise ValueError(f"cannot split {L} layers into {n_stages} stages")
    prefix = [0.0]
    for x in w:
        prefix.append(prefix[-1] + x)

    def cost(a: int, b: int) -> float:
        return prefix[b] - prefix[a]

    # best[s][i]: minimal max-stage cost splitting layers [0, i) into s
    # stages; back[s][i] the start of the last stage, ties toward the
    # uniform boundary
    INF = float("inf")
    best = [[INF] * (L + 1) for _ in range(n_stages + 1)]
    back = [[0] * (L + 1) for _ in range(n_stages + 1)]
    best[0][0] = 0.0
    for s in range(1, n_stages + 1):
        for i in range(s, L + 1):
            target = i * s // n_stages
            for j in range(s - 1, i):
                c = max(best[s - 1][j], cost(j, i))
                better = c < best[s][i] - 1e-9
                tie = (abs(c - best[s][i]) <= 1e-9
                       and abs(j - target) < abs(back[s][i] - target))
                if better or tie:
                    best[s][i] = c
                    back[s][i] = j
    bounds = [L]
    i = L
    for s in range(n_stages, 0, -1):
        i = back[s][i]
        bounds.append(i)
    bounds.reverse()
    stage_bytes = tuple(int(cost(a, b)) for a, b in zip(bounds, bounds[1:]))
    return StagePartition(boundaries=tuple(bounds), stage_bytes=stage_bytes)


def per_layer_param_bytes(model) -> Tuple[int, ...]:
    """Memory-model bytes of each layer's parameters, from the stacked
    ``layers.*`` specs (leading dim L: one layer's bytes is the stack's
    over L)."""
    per_layer = 0
    for name, s in model.param_specs().items():
        if name.startswith("layers."):
            per_layer += memory.nbytes(s.shape, s.dtype) // max(1, s.shape[0])
    return (per_layer,) * model.cfg.n_layers


def partition_model(model, n_stages: int) -> StagePartition:
    """Memory-balanced stage partition of a model.  The executable path
    slices dim 0 of every stacked leaf over ``pipe``, so the partition must
    be uniform: ``n_layers % n_stages == 0`` on a homogeneous stack; a
    ``hybrid`` family (a block shared by every site) is refused."""
    cfg = model.cfg
    if cfg.family == "hybrid":
        raise NotImplementedError(
            "pipeline partitioning of hybrid (shared-block) stacks is not "
            "supported: the shared attention block is reused at every site "
            "and cannot be assigned to one contiguous stage")
    if cfg.n_layers % n_stages:
        raise ValueError(
            f"n_layers={cfg.n_layers} not divisible by pp={n_stages}: the "
            "stacked-parameter pipeline path needs uniform stages")
    part = partition_layers(per_layer_param_bytes(model), n_stages)
    assert part.is_uniform, (
        "balanced partition of a homogeneous stack must be uniform", part)
    return part
