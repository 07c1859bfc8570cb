"""Serving entry points of the port (``serve``) and their step functions
(``steps``); counterpart of ``src/repro/launch``."""

import repro_torch._fp32  # noqa: F401  (TF32 off before any torch work)
