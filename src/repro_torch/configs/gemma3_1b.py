"""gemma3-1b [dense] — 5:1 local:global sliding-window attention, 128k.

26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144.
[hf:google/gemma-3-1b-pt; unverified]
Every 6th layer is global full attention (rope_theta 1M); the other five use
a 512-token sliding window (rope_theta 10k).  head_dim=256 (explicit),
qk-norm enabled.
Field for field the JAX package's ``repro/configs/gemma3_1b.py``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    attention="sliding_mix",
    sliding_window=512,
    global_every=6,
    qk_norm=True,
    rope_theta=10000.0,
    rope_theta_global=1000000.0,
    act_fn="silu",
    tie_embeddings=True,
)

SMOKE_CONFIG = CONFIG.replace(
    name="gemma3-smoke",
    num_layers=6,            # keep one full 5:1 local/global period
    d_model=64,
    num_heads=4,
    num_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    sliding_window=8,
)
