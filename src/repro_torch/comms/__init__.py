"""Gradient synchronization over ``torch.distributed``: bucketing, the
bf16/int8 wire formats and :class:`CommsPlan`."""

from .plan import CommsPlan, sync_tree

__all__ = ["CommsPlan", "sync_tree"]
