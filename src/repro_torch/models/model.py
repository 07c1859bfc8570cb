"""Top-level model: embed → stage program → final norm → head.

Counterpart of ``src/repro/models/model.py`` (``init_params`` :35,
``_rope_dim`` :94, ``make_ctx`` :100, ``_embed_inputs`` :150,
``forward_hidden`` :169, ``loss_fn`` :192, ``logits_from_hidden`` :200, ``init_cache`` :209,
``cache_slot_take`` :236, ``cache_slot_put`` :252, ``_run_stage_cached``
:269, ``prefill`` :323, ``decode_step`` :358).  Batches are dicts:
``tokens`` (B, L) and ``labels`` (B, L) integer tensors.

Caches keep the JAX package's tree — per stage, per kind, a leading layer
axis on scanned stages — so the two compare leaf for leaf.  ``prefill`` and
``decode_step`` write into the given cache buffers IN PLACE and return the
same tree; the JAX package returns a new tree and its serving loop donates
the old one.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
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


def _rope_dim(cfg) -> int:
    """RoPE runs over the whole head, or over MLA's qk_rope part."""
    if cfg.mla is not None and cfg.mla.kv_lora_rank:
        return cfg.mla.qk_rope_head_dim
    return cfg.head_dim


def make_ctx(cfg, positions) -> Dict[str, Any]:
    ctx: Dict[str, Any] = {}
    ctx["cos"], ctx["sin"] = L.rope_table(positions, _rope_dim(cfg),
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


def logits_from_hidden(params, cfg, hidden):
    return L.linear(_head_params(params, cfg), hidden.float(),
                    dtype=torch.float32)


def loss_fn(params, cfg, batch):
    """(mean CE + aux, {"ce", "aux"}) of next-token prediction."""
    hidden, aux = forward_hidden(params, cfg, batch)
    ce = L.chunked_cross_entropy(hidden, _head_params(params, cfg),
                                 batch["labels"], chunk=cfg.logits_chunk)
    return ce + aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# cache


def init_cache(cfg, batch: int, max_len: int, *,
               params: Optional[PyTree] = None, device=None) -> PyTree:
    """Zero decode cache on ``device`` (default: the params' device when
    ``params`` is given, else the card).  With ``params``, attention
    sub-blocks whose kv projections are factorized get the latent
    {"lk", "lv"} layout (rank-r floats per token), which the flash_decode
    kernel up-projects; without ``params`` the layout is always dense."""
    if device is None and params is not None:
        device = params["embed"]["table"].device
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    cache = []
    for si, st in enumerate(B.stage_program(cfg)):
        per_kind = []
        for ki, kind in enumerate(st.kinds):
            p = None if params is None else params["stages"][si][ki]
            c = B.init_sub_cache(kind, cfg, batch, max_len, dtype, params=p,
                                 device=dev)
            if st.scan and st.n > 1:
                c = tree_map(lambda x, n=st.n: x.new_zeros((n,) + x.shape),
                             c)
            per_kind.append(c)
        cache.append(per_kind)
    return cache


def _batch_axis(stage: B.Stage) -> int:
    """Scanned stages stack cache leaves on a leading layer axis, so the
    batch axis is 1 there and 0 on unrolled leaves."""
    return 1 if (stage.scan and stage.n > 1) else 0


def cache_slot_take(cfg, cache, slot: int) -> PyTree:
    """Copy ONE scheduler slot's cache out as a batch=1 cache tree."""
    return [[tree_map(lambda x, a=_batch_axis(st): x.narrow(a, slot, 1)
                      .clone(), c) for c in per_kind]
            for st, per_kind in zip(B.stage_program(cfg), cache)]


def cache_slot_put(cfg, cache, slot_cache, slot: int) -> PyTree:
    """Write a batch=1 slot cache back into slot ``slot`` of the full cache,
    in place (inverse of :func:`cache_slot_take`); returns ``cache``."""
    for st, per_kind, per_new in zip(B.stage_program(cfg), cache,
                                     slot_cache):
        for c, cn in zip(per_kind, per_new):
            tree_map(lambda buf, upd, a=_batch_axis(st):
                     buf.narrow(a, slot, 1).copy_(upd), c, cn)
    return cache


# ---------------------------------------------------------------------------
# prefill / decode


def _run_stage_cached(stage: B.Stage, stage_params, x, stage_cache, cfg,
                      ctx, fn):
    """Run one stage over its cache; returns x.  ``fn`` is
    ``B.prefill_sub_block`` (returns x, cache, aux) or
    ``B.decode_sub_block`` (x, cache); both write into the cache buffers
    they are given.  Stacked layers hand each sub-block a view of its
    layer's slice of the stacked cache (where the JAX package carries the
    stacked cache through a ``fori_loop``)."""
    stacked = stage.scan and stage.n > 1
    for it in range(stage.n if stacked else 1):
        for kind, p, c in zip(stage.kinds, stage_params, stage_cache):
            if stacked:
                p = tree_map(lambda a: a[it], p)
                c = tree_map(lambda a: a[it], c)
            x = fn(kind, p, x, c, cfg, ctx)[0]
    return x


def prefill(params, cfg, batch, cache, *, pos: int = 0,
            chunked: bool = False, last_idx: Optional[int] = None):
    """Run the prompt and fill the cache (in place).  Returns (logits of
    one row (B, V) fp32, cache).

    ``pos`` is the absolute position of batch["tokens"][:, 0].
    ``chunked=True`` attends against the whole cache with absolute-position
    masking, so a prompt can be prefilled in chunks.  ``last_idx`` picks
    the logits row (a prompt right-padded to a chunk width); default: the
    last row.  Runs under ``ops.batch_invariant``, so every chunking of a
    prompt gives the logits and cache of whole prefill."""
    with ops.batch_invariant():
        return _prefill(params, cfg, batch, cache, pos, chunked, last_idx)


def _prefill(params, cfg, batch, cache, pos, chunked, last_idx):
    x = _embed_inputs(params, cfg, batch)
    l = x.shape[1]
    ctx = make_ctx(cfg, pos + torch.arange(l, device=x.device))
    ctx["pos"] = pos
    if chunked:
        ctx["chunked"] = True
    for st, sp, sc in zip(B.stage_program(cfg), params["stages"], cache):
        x = _run_stage_cached(st, sp, x, sc, cfg, ctx, B.prefill_sub_block)
    hidden = L.apply_norm(params["final_norm"], x, eps=cfg.norm_eps)
    row = l - 1 if last_idx is None else last_idx
    logits = logits_from_hidden(params, cfg, hidden[:, row:row + 1])[:, 0]
    return logits, cache


def decode_step(params, cfg, cache, tokens, pos):
    """One decode step.  tokens: (B, 1) integer; pos: an int (0-based
    absolute position of this token, every slot alike) or a per-slot (B,)
    tensor.  Returns (logits (B, V) fp32, cache updated in place)."""
    x = L.embed(params["embed"], tokens, torch_dtype(cfg.dtype))
    if torch.is_tensor(pos) and pos.dim() == 1:
        positions = pos[:, None]
    else:
        positions = torch.tensor([int(pos)], device=x.device)
    ctx = make_ctx(cfg, positions)
    ctx["pos"] = pos
    for st, sp, sc in zip(B.stage_program(cfg), params["stages"], cache):
        x = _run_stage_cached(st, sp, x, sc, cfg, ctx, B.decode_sub_block)
    hidden = L.apply_norm(params["final_norm"], x, eps=cfg.norm_eps)
    return logits_from_hidden(params, cfg, hidden)[:, 0], cache
