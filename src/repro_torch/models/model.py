"""Top-level model: embed → stage program → final norm → head.

Counterpart of ``src/repro/models/model.py`` (``init_params`` :35,
``make_ctx`` :100, ``_embed_inputs`` :150, ``forward_hidden`` :169,
``loss_fn`` :192).  Batches are dicts: ``tokens`` (B, L) and ``labels``
(B, L) integer tensors.  Serving (caches, prefill, decode) comes with the
serving slice.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.device import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.tree import tree_map

PyTree = Any

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


# ---------------------------------------------------------------------------
# init


def init_params(cfg, seed: int = 0, *, device=None) -> PyTree:
    """Random params with the JAX package's layout and distributions
    (normal·1/sqrt(d_in) linears, normal·0.02 embedding, unit norm scales),
    drawn from a ``torch.Generator`` seeded with ``seed`` on ``device``
    (default: the card).  The numbers differ from ``jax.random``'s."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.param_dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params: Dict[str, Any] = {
        "embed": L.embedding_init(gen, cfg.vocab_size, cfg.d_model,
                                  dtype=dtype, device=dev),
        "final_norm": L.norm_init(cfg.d_model, cfg.norm, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.linear_init(gen, cfg.d_model, cfg.vocab_size,
                                          dtype=dtype, device=dev)
    stages = []
    for st in B.stage_program(cfg):
        lead = (st.n,) if (st.scan and st.n > 1) else ()
        stages.append([B.init_sub_block(kind, gen, cfg, lead=lead, device=dev)
                       for kind in st.kinds])
    params["stages"] = stages
    return tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t,
                    params)


# ---------------------------------------------------------------------------
# context (rope tables)


def make_ctx(cfg, positions) -> Dict[str, Any]:
    ctx: Dict[str, Any] = {}
    ctx["cos"], ctx["sin"] = L.rope_table(positions, cfg.head_dim,
                                          cfg.rope_theta)
    return ctx


# ---------------------------------------------------------------------------
# forward


def _run_stage_forward(stage: B.Stage, stage_params, x, cfg, ctx):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    iters = stage.n if (stage.scan and stage.n > 1) else 1
    for it in range(iters):
        for kind, p in zip(stage.kinds, stage_params):
            if iters > 1:
                p = tree_map(lambda a: a[it], p)
            x, a = B.apply_sub_block(kind, p, x, cfg, ctx)
            aux = aux + a
    return x, aux


def _embed_inputs(params, cfg, batch):
    return L.embed(params["embed"], batch["tokens"], torch_dtype(cfg.dtype))


def forward_hidden(params, cfg, batch):
    """Returns (hidden (B, L, d), aux_loss)."""
    x = _embed_inputs(params, cfg, batch)
    ctx = make_ctx(cfg, torch.arange(x.shape[1], device=x.device))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for st, sp in zip(B.stage_program(cfg), params["stages"]):
        x, a = _run_stage_forward(st, sp, x, cfg, ctx)
        aux = aux + a
    return L.apply_norm(params["final_norm"], x, eps=cfg.norm_eps), aux


def _head_params(params, cfg):
    if cfg.tie_embeddings:
        return {"w": params["embed"]["table"].T}
    return params["lm_head"]


def loss_fn(params, cfg, batch):
    """(mean CE + aux, {"ce", "aux"}) of next-token prediction."""
    hidden, aux = forward_hidden(params, cfg, batch)
    ce = L.chunked_cross_entropy(hidden, _head_params(params, cfg),
                                 batch["labels"], chunk=cfg.logits_chunk)
    return ce + aux, {"ce": ce, "aux": aux}
