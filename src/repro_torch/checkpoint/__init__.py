"""Atomic, async checkpoints of tensor trees (port of
``repro.checkpoint``)."""
from repro_torch.checkpoint.checkpointing import CheckpointManager

__all__ = ["CheckpointManager"]
