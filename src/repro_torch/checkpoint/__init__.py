"""Checkpoints and asynchronous snapshots (the JAX package's format on disk)."""
from .checkpointer import (CheckpointError, load_meta, restore, save,
                           verify)
from .snapshot import AsyncSnapshotter

__all__ = ["save", "restore", "load_meta", "verify", "CheckpointError",
           "AsyncSnapshotter"]
