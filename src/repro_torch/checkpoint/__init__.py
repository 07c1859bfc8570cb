"""Format-3 checkpoints of the port's param trees (``manager``), readable
and writable by the JAX package's ``repro.checkpoint``."""

from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401
