"""falcon-mamba-7b [ssm] — attention-free Mamba1 architecture.

64L d_model=4096 (attn-free) vocab=65024, ssm_state=16.
[arXiv:2410.05355; unverified]
d_inner = 2*4096 = 8192, dt_rank = ceil(4096/16) = 256, conv width 4.
Field for field the JAX package's ``repro/configs/falcon_mamba_7b.py``.
"""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=1,          # unused (attention-free)
    num_kv_heads=1,
    head_dim=1,
    d_ff=0,
    vocab_size=65024,
    attention="none",
    ssm=SSMConfig(version=1, state_dim=16, conv_width=4, expand=2, chunk=256),
)

SMOKE_CONFIG = CONFIG.replace(
    name="falcon-mamba-smoke",
    num_layers=2,
    d_model=64,
    vocab_size=256,
    ssm=SSMConfig(version=1, state_dim=4, conv_width=4, expand=2, dt_rank=8,
                  chunk=16),
)
