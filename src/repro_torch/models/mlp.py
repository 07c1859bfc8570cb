"""Dense feed-forward layer (gated silu / plain gelu MLP).

Counterpart of ``src/repro/models/mlp.py`` ``ffn_init`` / ``ffn_apply``
(:39, :52).  Mixture-of-experts layers come with the MoE slice.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models import layers as L


def ffn_init(gen: torch.Generator, d: int, d_ff: int, act_fn: str,
             num_layers: int, *, lead=(), dtype=torch.float32, device="cpu"):
    kw = dict(lead=lead, dtype=dtype, device=device)
    p = {}
    if act_fn == "silu":
        p["gate"] = L.linear_init(gen, d, d_ff, **kw)
    p["up"] = L.linear_init(gen, d, d_ff, **kw)
    p["down"] = L.linear_init(gen, d_ff, d, **kw,
                              scale=1.0 / math.sqrt(d_ff * 2 * num_layers))
    return p


def ffn_apply(p, x, act_fn: str):
    L.sow("in", x)
    up = L.linear(p["up"], x)
    if "gate" in p:
        up = L.act(act_fn, L.linear(p["gate"], x)) * up
    else:
        up = L.act(act_fn, up)
    L.sow("down_in", up)
    return L.linear(p["down"], up)
