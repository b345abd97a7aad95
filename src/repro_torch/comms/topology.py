"""Two-level device topology and the alpha-beta collective cost model,
ported from the reference's ``comms/topology.py``.

dMath's clusters are two-level: GPUs inside a node talk over a fast link,
nodes over a slower one.  On a named mesh the same structure is a fast
*intranode* axis group and a slow *internode* one; by the repo's
convention ``"model"`` is intranode and ``"data"``/``"pod"`` span nodes.

:class:`Topology` holds the split and one :class:`LinkSpec` per level
and prices each all-reduce schedule with

    T(schedule) = steps * alpha + wire_bytes / bandwidth

so that the planner chooses a schedule from the message size and the
mesh (paper §3.2).  :data:`PCIE_GEN3` and :data:`FDR_IB` are the
reference's nominals, sized to the paper's hardware generation (PCIe
gen3 GPUDirect and 56 Gb/s FDR InfiniBand), not to the H100 or to the
gloo wire the port runs on one card: they are kept so that the port's
planner makes the reference's choices.  A link fitted on the card comes
in through :mod:`repro_torch.core.calibrate` (:func:`default_links`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

#: the schedules ``comms.schedules`` implements; ties in the cost model
#: resolve to the first key (``psum``, ``ring`` and ``rsag`` tie)
SCHEDULES = ("psum", "ring", "rsag", "tree", "hier")


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """One interconnect level: per-message latency and per-device
    bandwidth."""

    latency_s: float
    bandwidth_Bps: float


# the reference's nominals (the paper's hardware); they need only be
# relatively right (intranode faster than internode) for schedule choice
PCIE_GEN3 = LinkSpec(latency_s=2e-6, bandwidth_Bps=12e9)    # GPUDirect P2P
FDR_IB = LinkSpec(latency_s=5e-6, bandwidth_Bps=6.8e9)      # 56 Gb/s FDR


@dataclasses.dataclass(frozen=True)
class Topology:
    """Fast intranode axes x slow internode axes, with link parameters."""

    intra_axes: Tuple[str, ...]
    inter_axes: Tuple[str, ...]
    axis_sizes: Dict[str, int]
    intra: LinkSpec = PCIE_GEN3
    inter: LinkSpec = FDR_IB

    @property
    def intra_size(self) -> int:
        return math.prod(self.axis_sizes[a] for a in self.intra_axes) or 1

    @property
    def inter_size(self) -> int:
        return math.prod(self.axis_sizes[a] for a in self.inter_axes) or 1

    @property
    def world_size(self) -> int:
        return self.intra_size * self.inter_size

    def level_of(self, axis: str) -> LinkSpec:
        return self.intra if axis in self.intra_axes else self.inter

    def _flat_allreduce(self, nbytes: int, n: int, link: LinkSpec,
                        steps: int, wire: float) -> float:
        del n
        return steps * link.latency_s + wire / link.bandwidth_Bps

    def allreduce_time(self, nbytes: int, schedule: str,
                       n: Optional[int] = None) -> float:
        """Estimated seconds for one all-reduce of ``nbytes`` per device.

        Flat schedules are priced on the slowest link they cross (the
        internode one whenever the group spans nodes); ``hier`` is an
        intranode reduce-scatter, an internode all-reduce of a 1/n_intra
        slice and an intranode all-gather."""
        n = n or self.world_size
        if n <= 1:
            return 0.0
        link = self.inter if self.inter_size > 1 else self.intra
        if schedule in ("psum", "ring", "rsag", "tree"):
            steps, wire = allreduce_design(nbytes, schedule, n)
            return self._flat_allreduce(nbytes, n, link, steps, wire)
        if schedule == "hier":
            # clamp the two levels to the group reducing (n may name a
            # sub-mesh group smaller than the topology)
            ni = min(self.intra_size, n)
            nn = max(1, n // ni)
            if ni <= 1 or nn <= 1:
                # one level only: a ring on that level
                return self.allreduce_time(nbytes, "ring", n)
            t = 0.0
            # intranode reduce-scatter + all-gather, each (ni-1)/ni
            t += 2 * ((ni - 1) * self.intra.latency_s
                      + nbytes * (ni - 1) / ni / self.intra.bandwidth_Bps)
            # internode all-reduce over the 1/ni slice
            slice_bytes = nbytes / ni
            t += (2 * (nn - 1) * self.inter.latency_s
                  + 2.0 * slice_bytes * (nn - 1) / nn
                  / self.inter.bandwidth_Bps)
            return t
        raise ValueError(f"unknown schedule {schedule!r}; "
                         f"expected one of {SCHEDULES}")

    def usable_schedules(self, candidates: Sequence[str] = SCHEDULES
                         ) -> Tuple[str, ...]:
        """The candidates that apply here (``hier`` needs both levels
        > 1)."""
        return tuple(s for s in candidates if s != "hier"
                     or (self.intra_size > 1 and self.inter_size > 1))

    def schedule_scores(self, nbytes: int,
                        candidates: Sequence[str] = SCHEDULES
                        ) -> Dict[str, float]:
        """Cost-model seconds per usable schedule for one all-reduce."""
        return {s: self.allreduce_time(nbytes, s)
                for s in self.usable_schedules(candidates)}

    def best_schedule(self, nbytes: int,
                      candidates: Sequence[str] = SCHEDULES) -> str:
        """argmin over the cost model: latency-bound sizes pick ``tree``,
        bandwidth-bound sizes ``psum``/``ring``/``rsag``, meshes with
        both levels ``hier``."""
        scores = self.schedule_scores(nbytes, candidates)
        return min(scores, key=scores.get)


def allreduce_design(nbytes: int, schedule: str, n: int
                     ) -> Tuple[int, float]:
    """(steps, wire_bytes) of one *flat* all-reduce: the design matrix
    :meth:`Topology.allreduce_time` prices and the calibration fitter
    (:func:`repro_torch.core.calibrate.fit_link`) regresses against.
    ``hier`` has no single row; decompose it into its flat phases."""
    if n <= 1:
        return 0, 0.0
    if schedule in ("psum", "ring", "rsag"):
        # bandwidth-optimal: 2(n-1)/n of the buffer crosses the wire
        return 2 * (n - 1), 2.0 * nbytes * (n - 1) / n
    if schedule == "tree":
        # recursive doubling: log2(n) full-buffer exchanges
        steps = max(1, math.ceil(math.log2(n)))
        return steps, float(nbytes) * steps
    raise ValueError(f"no flat design for schedule {schedule!r}; "
                     f"expected one of ('psum', 'ring', 'rsag', 'tree')")


def default_links() -> Tuple[LinkSpec, LinkSpec]:
    """(intra, inter): the active calibration table's fitted links when
    one is installed (:func:`repro_torch.core.calibrate.set_active`),
    else the reference's nominals :data:`PCIE_GEN3` / :data:`FDR_IB`."""
    from repro_torch.core import calibrate
    intra, inter = calibrate.links()
    return intra or PCIE_GEN3, inter or FDR_IB


def topology_from_mesh(mesh, intra_axes: Optional[Sequence[str]] = None,
                       intra: Optional[LinkSpec] = None,
                       inter: Optional[LinkSpec] = None) -> Topology:
    """The two-level topology of a mesh (anything with a ``shape``
    mapping of axis sizes, such as :class:`repro_torch.core.distributed.
    Mesh`).  By default ``"model"`` is the intranode axis and every other
    axis spans nodes; axes absent from the mesh are ignored.  Links left
    as None resolve through :func:`default_links`."""
    names = tuple(mesh.shape.keys())
    if intra_axes is None:
        intra_axes = tuple(a for a in names if a == "model")
    else:
        intra_axes = tuple(a for a in intra_axes if a in names)
    inter_axes = tuple(a for a in names if a not in intra_axes)
    if intra is None or inter is None:
        d_intra, d_inter = default_links()
        intra = intra or d_intra
        inter = inter or d_inter
    return Topology(intra_axes=intra_axes, inter_axes=inter_axes,
                    axis_sizes=dict(mesh.shape), intra=intra, inter=inter)
