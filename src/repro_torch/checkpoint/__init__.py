"""Crash-safe pytree checkpointing (counterpart of ``repro.checkpoint``)."""
from repro_torch.checkpoint.checkpoint import (
    CorruptCheckpointError,
    latest_step,
    restore_latest,
    restore_pytree,
    restore_step,
    save_pytree,
    save_step,
    valid_steps,
    verify_checkpoint,
)

__all__ = [
    "CorruptCheckpointError",
    "latest_step",
    "restore_latest",
    "restore_pytree",
    "restore_step",
    "save_pytree",
    "save_step",
    "valid_steps",
    "verify_checkpoint",
]
