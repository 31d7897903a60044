"""Checkpoints in the reference's on-disk layout (``manager``)."""
from repro_torch.checkpoint.manager import (CheckpointManager,
                                            reshard_checkpoint, row_shardings)

__all__ = ["CheckpointManager", "reshard_checkpoint", "row_shardings"]
