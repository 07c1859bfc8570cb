"""qwen3-0.6b [dense] — qk_norm + GQA.

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936.  head_dim=128
(explicit, as in the Qwen3 family).  [hf:Qwen/Qwen3-8B; hf]
Field for field the JAX package's ``repro/configs/qwen3_0_6b.py``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151936,
    attention="full",
    qk_norm=True,
    act_fn="silu",
    rope_theta=1000000.0,
    tie_embeddings=True,
)

SMOKE_CONFIG = CONFIG.replace(
    name="qwen3-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
)
