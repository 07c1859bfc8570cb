"""Optimizers of the port: AdamW (block refinement and the trainer) and
int8 gradient compression with error feedback."""
