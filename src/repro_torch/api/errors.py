"""Structured planner and memory refusals for the Session API, ported
from the reference's ``api/errors.py``.

Every refusal of the memory model is ONE exception type with ONE
formatting: :class:`PlanMemoryError` carries the budget, the per-stage
footprints of the refused cell and the per-candidate ``(dp, tp, pp, M)
-> reason`` table, so callers can branch on the structured data instead
of parsing strings.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

Candidate = Tuple[int, int, int, int]          # (dp, tp, pp, M)

_HINT = ("Raise --hbm-gib, add pipeline stages (--pp), or increase "
         "--microbatches.")


class PlanMemoryError(ValueError):
    """The memory model refused a plan (resource verdict, not a crash).

    Attributes:
        budget:     the :class:`repro_torch.core.memory.MemoryBudget` the plan
                    was priced against (may be ``None`` for bare puts).
        footprints: per-stage :class:`repro_torch.core.memory.Footprint`\\ s of
                    the refused cell (empty for sweep-level refusals).
        refused:    ``{(dp, tp, pp, M): reason}`` — every candidate the
                    planner sweep refused, with its reason.
    """

    def __init__(self, message: str, *, budget=None,
                 footprints: Sequence = (),
                 refused: Optional[Mapping[Candidate, str]] = None):
        super().__init__(message)
        self.budget = budget
        self.footprints = tuple(footprints)
        self.refused: Dict[Candidate, str] = dict(refused or {})

    # -- the one formatting every surface shares ---------------------------
    @staticmethod
    def format_refusals(refused: Mapping[Candidate, str]) -> str:
        return "; ".join(
            f"(dp={k[0]}, tp={k[1]}, pp={k[2]}, M={k[3]}): {v}"
            for k, v in sorted(refused.items()))

    @classmethod
    def for_cell(cls, footprints, budget, *,
                 refused: Optional[Mapping[Candidate, str]] = None,
                 hint: str = _HINT) -> "PlanMemoryError":
        """The launch-surface fail-fast: this cell does not fit."""
        from repro_torch.core import memory as mem_mod

        msg = (f"plan does not fit the per-device memory budget "
               f"({budget.describe()}); refusing to launch.\n"
               f"{mem_mod.footprint_table(footprints, budget)}\n{hint}")
        if refused:
            msg += ("\nEvery (dp, tp, pp, M) candidate on this device "
                    "count was also refused: "
                    + cls.format_refusals(refused))
        return cls(msg, budget=budget, footprints=footprints,
                   refused=refused)

    @classmethod
    def all_refused(cls, refused: Mapping[Candidate, str], budget,
                    n_devices: int) -> "PlanMemoryError":
        """The sweep-level refusal: no factorization of the mesh fits."""
        msg = (f"no feasible (dp, tp, pp) for {n_devices} devices — all "
               f"candidates refused by the memory model "
               f"({budget.describe()}): " + cls.format_refusals(refused))
        return cls(msg, budget=budget, refused=refused)
