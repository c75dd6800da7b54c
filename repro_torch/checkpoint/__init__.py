"""Checkpoint substrate (twin of ``repro.checkpoint``)."""

from repro_torch.checkpoint.io import latest_step, restore_checkpoint, save_checkpoint  # noqa: F401
