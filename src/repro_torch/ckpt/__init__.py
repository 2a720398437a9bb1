"""Checkpointing (the port of the JAX package's ``ckpt``): atomic,
asynchronous saves in the reference's on-disk format, retention, and
restore onto the current device."""
from repro_torch.ckpt.checkpoint import CheckpointManager

__all__ = ["CheckpointManager"]
