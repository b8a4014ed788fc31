"""Checkpoints in the JAX package's on-disk format (the port's
``repro.checkpoint``)."""
from .manager import CheckpointManager, dir_nbytes, restore_tree, save_tree

__all__ = ["CheckpointManager", "dir_nbytes", "restore_tree", "save_tree"]
