"""The Session API: plan (with the memory verdict), init_state and step
on the device."""

from .errors import PlanMemoryError
from .plan import CAPABILITIES, ExecutablePlan, select_path
from .session import Session
from .state import StateEntry, StateRegistry

__all__ = ["CAPABILITIES", "ExecutablePlan", "PlanMemoryError", "Session",
           "StateEntry", "StateRegistry", "select_path"]
