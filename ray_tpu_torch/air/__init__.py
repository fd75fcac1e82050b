"""Checkpoints of the port (counterpart: ``ray_tpu/air``): the durable
checkpoint directory and the asynchronous checkpoint manager."""
from ray_tpu_torch.air.checkpoint import (Checkpoint, InvalidCheckpointError,
                                          load_manifest,
                                          verify_checkpoint_dir,
                                          write_manifest)
from ray_tpu_torch.air.checkpoint_manager import CheckpointManager

__all__ = ["Checkpoint", "CheckpointManager", "InvalidCheckpointError",
           "load_manifest", "verify_checkpoint_dir", "write_manifest"]
