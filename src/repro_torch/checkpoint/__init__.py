"""Checkpoints of the port in the JAX package's on-disk format (`ckpt`)."""
from repro_torch.checkpoint.ckpt import (AsyncCheckpointer, latest_step,
                                         restore_checkpoint, save_checkpoint)

__all__ = ["save_checkpoint", "latest_step", "restore_checkpoint",
           "AsyncCheckpointer"]
