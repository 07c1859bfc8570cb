"""Model zoo of the port: llama-style dense decoder (this slice)."""
