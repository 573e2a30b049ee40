"""Step-atomic checkpoints of posit state (counterpart of
``repro.checkpoint``; the same on-disk form)."""
from repro_torch.checkpoint.store import (latest_step, restore_checkpoint,
                                          save_checkpoint)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]
