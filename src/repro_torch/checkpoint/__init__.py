"""Checkpoints of the port in the reference's on-disk format
(`checkpoint/ckpt.py`)."""
from repro_torch.checkpoint.ckpt import (AsyncCheckpointer, latest_step,
                                         restore_checkpoint, save_checkpoint)

__all__ = ["AsyncCheckpointer", "latest_step", "restore_checkpoint",
           "save_checkpoint"]
