"""zamba2-7b [hybrid] — Mamba2 backbone + ONE shared attention block.

81L d_model=3584 32H (MHA kv=32) d_ff=14336 vocab=32000, ssm_state=64.
[arXiv:2411.15242; unverified]
Backbone layers are Mamba2 (SSD); every 6th position additionally invokes a
single weight-shared (attention + SwiGLU MLP) transformer block — the Zamba2
"shared block" design.  d_inner = 2*3584 = 7168, head_dim 64 → 112 SSD heads.
Field for field the JAX package's ``repro/configs/zamba2_7b.py``.
"""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    attention="full",          # flavour of the shared block
    hybrid_attn_every=6,
    ssm=SSMConfig(version=2, state_dim=64, conv_width=4, expand=2,
                  head_dim=64, chunk=256),
    act_fn="silu",
)

SMOKE_CONFIG = CONFIG.replace(
    name="zamba2-smoke",
    num_layers=6,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    hybrid_attn_every=3,
    ssm=SSMConfig(version=2, state_dim=8, conv_width=4, expand=2,
                  head_dim=16, chunk=16),
)
