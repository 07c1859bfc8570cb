"""Optimizers of the port: AdamW (block refinement and the trainer) and
int8 gradient compression with error feedback."""

import repro_torch._fp32  # noqa: F401  (TF32 off before any torch work)
