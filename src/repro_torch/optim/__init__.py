"""Optimizers of the port (AdamW for block refinement)."""
