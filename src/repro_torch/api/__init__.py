"""The Session API: plan, init_state and step on the device."""

from .plan import CAPABILITIES, ExecutablePlan, select_path
from .session import Session

__all__ = ["CAPABILITIES", "ExecutablePlan", "Session", "select_path"]
