"""Atomic, sha256-verified checkpoints on the reference's layout."""
from repro_torch.checkpoint.checkpointer import (AsyncCheckpointer,
                                                 ChecksumError, latest_step,
                                                 restore, save)

__all__ = ["AsyncCheckpointer", "ChecksumError", "latest_step", "restore",
           "save"]
