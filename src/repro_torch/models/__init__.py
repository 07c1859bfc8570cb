"""Model zoo of the port: llama-style dense decoder (this slice)."""

import repro_torch._fp32  # noqa: F401  (TF32 off before any torch work)
