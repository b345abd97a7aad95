"""The Session API: plan (with the memory verdict), init_state and step
on the device, through the one train-step dispatcher."""

from .errors import PlanMemoryError
from .plan import CAPABILITIES, ExecutablePlan, capability_table, select_path
from .session import Session, dispatch_train_step
from .state import StateEntry, StateRegistry

__all__ = ["CAPABILITIES", "ExecutablePlan", "PlanMemoryError", "Session",
           "StateEntry", "StateRegistry", "capability_table",
           "dispatch_train_step", "select_path"]
