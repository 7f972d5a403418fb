"""Checkpointing: async npz snapshots with keep-N and restore (port of the JAX package's ``repro.checkpoint``)."""
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
