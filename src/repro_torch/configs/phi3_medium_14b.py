"""phi3-medium-14b [dense] — RoPE SwiGLU GQA.

40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352.
[arXiv:2404.14219; unverified]
Field for field the JAX package's ``repro/configs/phi3_medium_14b.py``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=10,
    d_ff=17920,
    vocab_size=100352,
    attention="full",
    act_fn="silu",
    rope_theta=10000.0,
)

SMOKE_CONFIG = CONFIG.replace(
    name="phi3-medium-smoke",
    num_layers=2,
    d_model=80,
    num_heads=4,
    num_kv_heads=2,
    head_dim=20,
    d_ff=192,
    vocab_size=256,
)
