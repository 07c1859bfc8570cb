"""Format-3 checkpoints of the port's param trees (``manager``), readable
and writable by the JAX package's ``repro.checkpoint``."""

import repro_torch._fp32  # noqa: F401  (TF32 off before any torch work)
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401
