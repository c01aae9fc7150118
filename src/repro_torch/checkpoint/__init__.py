"""Checkpointing with atomic commit and a background writer
(``repro.checkpoint``)."""

from .checkpoint import (AsyncCheckpointer, latest_step, restore_checkpoint,
                         save_checkpoint)

__all__ = ["AsyncCheckpointer", "latest_step", "restore_checkpoint",
           "save_checkpoint"]
