"""Checkpoints of the port, on the JAX package's on-disk layout."""
from repro_torch.checkpoint.manager import (  # noqa: F401
    CheckpointManager, MemorySnapshotStore, SnapshotIntegrityError,
    step_to_window)
