"""granite-3-8b [dense] — GQA SwiGLU transformer.

40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155.
[hf:ibm-granite/granite-3.0-2b-base; hf]
Field for field the JAX package's ``repro/configs/granite_3_8b.py``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=12800,
    vocab_size=49155,
    attention="full",
    act_fn="silu",
    rope_theta=10000.0,
)

SMOKE_CONFIG = CONFIG.replace(
    name="granite-smoke",
    num_layers=2,
    d_model=64,
    num_heads=8,
    num_kv_heads=2,
    head_dim=8,
    d_ff=160,
    vocab_size=256,
)
