"""deepseek-v2-lite-16b [moe] — MLA attention + fine-grained MoE.

27L d_model=2048 16H d_ff=1408(routed expert) vocab=102400,
MLA kv_lora_rank=512, 2 shared + 64 routed experts top-6, first layer dense.
[arXiv:2405.04434; hf]  Field for field the JAX package's
``repro/configs/deepseek_v2_lite_16b.py``.
"""

from repro_torch.configs.base import MLAConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=192,              # qk_nope(128) + qk_rope(64)
    d_ff=10944,                # dense FFN of first_k_dense blocks
    vocab_size=102400,
    attention="mla",
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=64, top_k=6, d_ff=1408,
                  num_shared_experts=2, first_k_dense=1, dense_d_ff=10944),
    act_fn="silu",
    rope_theta=10000.0,
)

SMOKE_CONFIG = CONFIG.replace(
    name="deepseek-v2-lite-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=24,
    d_ff=128,
    vocab_size=256,
    mla=MLAConfig(kv_lora_rank=32, q_lora_rank=0,
                  qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16),
    moe=MoEConfig(num_experts=8, top_k=2, d_ff=32,
                  num_shared_experts=1, first_k_dense=1, dense_d_ff=128),
)
