"""Checkpoint-restart on the reference's on-disk format."""

from .manager import CheckpointManager, state_from_tree, state_tree

__all__ = ["CheckpointManager", "state_from_tree", "state_tree"]
