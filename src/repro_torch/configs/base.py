"""Model configuration dataclasses (jax-free copy of ``src/repro/configs/base.py``).

One frozen dataclass describes every architecture in the zoo.  Family-specific
fields default to "off" (0 / None) so a single Model implementation can branch
on them without isinstance checks.  Every ported architecture gets its own
module in this package exporting ``CONFIG`` (full size) and ``SMOKE_CONFIG``
(reduced, CPU-runnable).  The fields and defaults stay identical to the JAX
package's so configs compare field by field.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class SSMConfig:
    """State-space (Mamba) block hyperparameters."""

    version: int = 1                 # 1 = Mamba1 selective scan, 2 = Mamba2 SSD
    state_dim: int = 16              # N: per-channel state size
    conv_width: int = 4              # depthwise causal conv width
    expand: int = 2                  # d_inner = expand * d_model
    head_dim: int = 64               # Mamba2 only: channels per SSD head
    dt_rank: int = 0                 # Mamba1 only: 0 -> ceil(d_model / 16)
    chunk: int = 256                 # scan chunk length (remat / SSD block)


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN hyperparameters."""

    num_experts: int = 0             # routed experts (0 = dense FFN)
    top_k: int = 0
    d_ff: int = 0                    # per-expert hidden size
    num_shared_experts: int = 0      # always-on experts (deepseek style)
    first_k_dense: int = 0           # leading blocks keep a dense FFN
    dense_d_ff: int = 0              # hidden size of those dense blocks
    router_noise: float = 0.0
    aux_loss_coef: float = 0.001
    # dispatch = how routed tokens reach their experts:
    #   capacity — Switch-style fixed (E, C, d) buffer; tokens past the
    #              per-expert capacity C = ceil(T·k/E · capacity_factor)
    #              are DROPPED, so outputs depend on batch size;
    #   dropfree — sort + segment-sum over a ragged (T·k, d) layout; no
    #              drops, outputs exactly batch-size-invariant (the
    #              property that lets calibration fold microbatches by dp).
    dispatch: str = "capacity"       # capacity | dropfree
    capacity_factor: float = 1.25    # capacity dispatch only


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2) hyperparameters."""

    kv_lora_rank: int = 0            # 0 = plain GQA attention
    q_lora_rank: int = 0             # 0 = dense q projection
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0                # 0 -> d_model // num_heads
    # --- attention flavour ----------------------------------------------
    attention: str = "full"          # full | sliding_mix | mla | none
    sliding_window: int = 0
    global_every: int = 0            # sliding_mix: every k-th layer is global
    qk_norm: bool = False
    rope_theta: float = 10000.0
    rope_theta_global: float = 0.0   # sliding_mix: theta for global layers
    attn_logit_softcap: float = 0.0
    # --- block wiring -----------------------------------------------------
    act_fn: str = "silu"             # silu (SwiGLU) | gelu (plain MLP)
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # --- sub-configs --------------------------------------------------------
    ssm: Optional[SSMConfig] = None
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    # --- hybrid (zamba2): mamba backbone + shared attention block ----------
    hybrid_attn_every: int = 0       # every k-th position invokes shared block
    # --- encoder-decoder (whisper) ------------------------------------------
    num_encoder_layers: int = 0
    encoder_seq_len: int = 0         # fixed encoder length (audio frames)
    # --- modality frontend stub ---------------------------------------------
    frontend: str = "none"           # none | vision | audio
    num_patches: int = 0             # vision: patch embeddings prepended
    # --- compression (the paper's technique, first-class) --------------------
    compress_ratio: float = 1.0      # 1.0 = dense; <1 = factorized linears
    compress_remap: bool = False     # Dobi-style remapped ratio (App. B.4)
    # --- numerics -------------------------------------------------------------
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True               # checkpoint each block in training
    scan_layers: bool = True         # stack homogeneous layers with lax.scan
    logits_chunk: int = 512          # chunked cross-entropy seq tile

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.ssm is not None and self.ssm.version == 1 and self.ssm.dt_rank == 0:
            object.__setattr__(
                self, "ssm",
                dataclasses.replace(self.ssm, dt_rank=-(-self.d_model // 16)))

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
