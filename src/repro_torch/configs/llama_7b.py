"""LLaMA-7B — the paper's primary evaluation model (Touvron et al. 2023)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=11008,
    vocab_size=32000,
    attention="full",
    act_fn="silu",
    rope_theta=10000.0,
)

SMOKE_CONFIG = CONFIG.replace(
    name="llama-7b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=160,
    vocab_size=256,
)
