"""whisper-base [audio] — encoder-decoder with a conv frontend (stub).

6L d_model=512 8H (MHA kv=8) d_ff=2048 vocab=51865.  [arXiv:2212.04356]
The encoder runs 6 layers over 1500 audio frames; the conv frontend is a
stub: callers hand in precomputed frame embeddings (batch, 1500, d_model).
The decoder is autoregressive with cross-attention over the encoder's
output (whisper caps its length at 448).
Field for field the JAX package's ``repro/configs/whisper_base.py``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    num_layers=6,              # decoder layers
    num_encoder_layers=6,
    encoder_seq_len=1500,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    attention="full",
    act_fn="gelu",
    norm="layernorm",
    frontend="audio",
    tie_embeddings=True,
)

SMOKE_CONFIG = CONFIG.replace(
    name="whisper-smoke",
    num_layers=2,
    num_encoder_layers=2,
    encoder_seq_len=32,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
)
