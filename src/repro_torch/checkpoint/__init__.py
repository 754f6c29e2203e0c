from repro_torch.checkpoint.manager import CheckpointManager, restore, save

__all__ = ["CheckpointManager", "restore", "save"]
