"""kimi-k2-1t-a32b [moe] — trillion-parameter MoE (paper-table config).

61L d_model=7168 64H (GQA kv=8) d_ff=2048(routed expert) vocab=163840,
MoE 384 routed experts top-8, one shared expert, first block dense
(18432).  Field for field the JAX package's
``repro/configs/kimi_k2_1t.py``, which follows the paper table's GQA
attention (kv 8), not the released model's MLA.
"""

from repro_torch.configs.base import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=112,
    d_ff=18432,               # dense FFN of the first block
    vocab_size=163840,
    attention="full",
    moe=MoEConfig(num_experts=384, top_k=8, d_ff=2048,
                  num_shared_experts=1, first_k_dense=1, dense_d_ff=18432),
    act_fn="silu",
    rope_theta=50000.0,
)

SMOKE_CONFIG = CONFIG.replace(
    name="kimi-k2-smoke",
    num_layers=2,
    d_model=64,
    num_heads=8,
    num_kv_heads=2,
    head_dim=8,
    d_ff=128,
    vocab_size=256,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff=32,
                  num_shared_experts=1, first_k_dense=1, dense_d_ff=128),
)
