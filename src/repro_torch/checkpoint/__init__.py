"""Checkpoints in the reference's format: training states
(``CheckpointManager``) and GeekModels (``save_model`` / ``restore_model``)."""
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401
