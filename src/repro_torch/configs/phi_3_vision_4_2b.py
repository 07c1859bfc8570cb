"""phi-3-vision-4.2b [vlm] — phi3-mini text backbone + CLIP frontend (stub).

32L d_model=3072 32H (MHA kv=32) d_ff=8192 vocab=32064.
[hf:microsoft/Phi-3-vision-128k-instruct; hf]
The vision frontend is a stub: callers hand in precomputed patch embeddings
(batch, num_patches, d_model), which the model splices in front of the
token embeddings.  Head dim 3072 / 32 = 96.
Field for field the JAX package's ``repro/configs/phi_3_vision_4_2b.py``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    attention="full",
    act_fn="silu",
    rope_theta=10000.0,
    frontend="vision",
    num_patches=256,
)

SMOKE_CONFIG = CONFIG.replace(
    name="phi-3-vision-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    num_patches=8,
)
