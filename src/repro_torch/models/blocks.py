"""Block assembly: stage programs and the dense attention sub-block.

Counterpart of ``src/repro/models/blocks.py`` (``stage_program`` :43,
``apply_sub_block`` :150) for the dense family's ``"attn"`` kind.  A stage
with ``scan=True`` and ``n > 1`` stacks its sub-block params on a leading
axis, as the JAX package does; the port walks that axis in a Python loop.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mlp as M


@dataclasses.dataclass(frozen=True)
class Stage:
    kinds: Tuple[str, ...]   # sub-block kinds applied per iteration
    n: int                   # iterations (stacked on a leading axis if > 1)
    scan: bool = True


def _not_ported(what: str, slice_name: str):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (comes with the "
        f"{slice_name} slice)")


def stage_program(cfg) -> List[Stage]:
    if cfg.family in ("hybrid", "ssm"):
        raise _not_ported(f"family {cfg.family!r}", "SSM / hybrid")
    if cfg.attention == "sliding_mix":
        raise _not_ported("sliding-window attention", "dense-archs")
    if cfg.moe is not None and cfg.moe.num_experts:
        raise _not_ported("mixture of experts", "MoE")
    if cfg.family == "encdec":
        raise _not_ported("encoder-decoder models", "multimodal")
    if cfg.attention == "mla":
        raise _not_ported("multi-head latent attention", "MoE")
    return [Stage(("attn",), cfg.num_layers)]


def init_sub_block(kind: str, gen: torch.Generator, cfg, *, lead=(),
                   device="cpu"):
    if kind != "attn":
        raise _not_ported(f"sub-block kind {kind!r}", "later")
    kw = dict(lead=lead, device=device)
    return {
        "ln1": L.norm_init(cfg.d_model, cfg.norm, **kw),
        "ln2": L.norm_init(cfg.d_model, cfg.norm, **kw),
        "attn": A.gqa_init(gen, cfg, **kw),
        "ffn": M.ffn_init(gen, cfg.d_model, cfg.d_ff, cfg.act_fn,
                          cfg.num_layers, **kw),
    }


def apply_sub_block(kind: str, p, x, cfg, ctx):
    """x: (B, L, d) -> (x, aux_loss)."""
    if kind != "attn":
        raise _not_ported(f"sub-block kind {kind!r}", "later")
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    h = L.apply_norm(p["ln1"], x, eps=cfg.norm_eps)
    with L.scope("attn"):
        attn_out = A.gqa_prefill(p["attn"], h, cfg, ctx["cos"], ctx["sin"])
    x = x + attn_out
    h2 = L.apply_norm(p["ln2"], x, eps=cfg.norm_eps)
    with L.scope("ffn"):
        return x + M.ffn_apply(p["ffn"], h2, cfg.act_fn), zero
