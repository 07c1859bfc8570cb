"""Top-level model: embed → stage program → final norm → head.

Counterpart of ``src/repro/models/model.py`` (``init_params`` :35,
``_rope_dim`` :94, ``make_ctx`` :100, ``sinusoid_positions`` :110,
``_run_stage_forward`` :121 (remat :141), ``_embed_inputs`` :150,
``_run_encoder`` :158, ``forward_hidden`` :169,
``loss_fn`` :192, ``logits_from_hidden`` :200, ``init_cache`` :209,
``cache_slot_take`` :236, ``cache_slot_put`` :252, ``_run_stage_cached``
:269, ``prefill`` :323, ``decode_step`` :358).  Batches are dicts:
``tokens`` (B, L) and ``labels`` integer tensors; phi-3-vision adds
``patches`` (B, P, d), precomputed patch embeddings spliced before the
tokens (its labels span patches + tokens, (B, P + L), as the JAX package's
data makes them); whisper adds ``frames`` (B, Le, d), precomputed audio
frame embeddings that the encoder runs over (its decoder attends to the
encoder's normed output through cross-attention, and both its streams get
sinusoid positions).

Caches keep the JAX package's tree — per stage, per kind, a leading layer
axis on scanned stages — so the two compare leaf for leaf.  A weight-shared
kind (zamba2's ``"shared_attn"``) holds ``None`` in its stage slot and
reads ``params["shared"][kind]`` at every site; each site keeps its own
cache.  ``prefill`` and
``decode_step`` write into the given cache buffers IN PLACE and return the
same tree; the JAX package returns a new tree and its serving loop donates
the old one.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.tree import flatten, tree_map, unflatten

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
    program = B.stage_program(cfg)
    for st in program:
        lead = (st.n,) if (st.scan and st.n > 1) else ()
        stages.append([None if kind in B.SHARED_KINDS
                       else B.init_sub_block(kind, gen, cfg, lead=lead,
                                             device=dev)
                       for kind in st.kinds])
    params["stages"] = stages
    shared = sorted({k for st in program for k in st.kinds
                     if k in B.SHARED_KINDS})
    if shared:
        params["shared"] = {kind: B.init_sub_block(kind, gen, cfg,
                                                   device=dev)
                            for kind in shared}
    enc_stages = B.encoder_stages(cfg)
    if enc_stages:
        params["encoder"] = {
            "stages": [[B.init_sub_block(
                kind, gen, cfg, lead=(st.n,) if (st.scan and st.n > 1)
                else (), device=dev) for kind in st.kinds]
                for st in enc_stages],
            "final_norm": L.norm_init(cfg.d_model, cfg.norm, device=dev)}
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
    """RoPE tables at ``positions``: {"cos", "sin"}, plus {"cos_global",
    "sin_global"} at ``rope_theta_global`` when the config sets one
    (gemma3's global layers; ``blocks._tables`` picks them)."""
    ctx: Dict[str, Any] = {}
    rd = _rope_dim(cfg)
    ctx["cos"], ctx["sin"] = L.rope_table(positions, rd, cfg.rope_theta)
    if cfg.rope_theta_global:
        ctx["cos_global"], ctx["sin_global"] = L.rope_table(
            positions, rd, cfg.rope_theta_global)
    return ctx


def sinusoid_positions(positions, d: int):
    """(len(positions), d) fp32 table [sin(p·f) | cos(p·f)], f_i =
    10000^(-i / (d/2)): whisper's absolute positions, added to the encoder's
    frames and the decoder's tokens.  The frequencies are rounded to fp32
    and the fp32 angles p·f taken through sin / cos in fp64: the JAX
    package's fp32 table to ~1e-8, where fp32 ``torch.sin`` on the CPU is
    off by up to 1.5e-4 at whisper's angles (up to 1500 rad)."""
    half = d // 2
    freqs = (10000.0 ** (-torch.arange(half, dtype=torch.float64,
                                       device=positions.device) / half)
             ).float()
    ang = (positions.float()[:, None] * freqs).double()
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).float()


# ---------------------------------------------------------------------------
# forward


def _unstack(p, n: int):
    """A stacked sub-block's params as ``n`` per-layer trees of views (one
    ``unbind`` a leaf); ``None`` (a shared kind's slot) stays ``None``."""
    if p is None:
        return [None] * n
    leaves, treedef = flatten(p)
    cols = [t.unbind(0) for t in leaves]
    return [unflatten(treedef, [c[i] for c in cols]) for i in range(n)]


def _stage_layers(stage: B.Stage, stage_params):
    """Each sub-block's params as a list over the stage's iterations: a
    stacked stage's unbound once a leaf (its backward stacks the layers'
    grads once, where indexing ``a[it]`` would scatter each into a
    zero-filled copy of the whole stack, once a layer), else ``[p]``."""
    if stage.scan and stage.n > 1:
        return [_unstack(p, stage.n) for p in stage_params]
    return [[p] for p in stage_params]


def _site_params(kind: str, layers, shared, it: int):
    """A sub-block's params at iteration ``it`` of its stage: the shared
    slot for a weight-shared kind, else its own layer's (``layers`` from
    :func:`_stage_layers`)."""
    return shared[kind] if kind in B.SHARED_KINDS else layers[it]


def _run_stage_forward(stage: B.Stage, stage_params, shared, x, cfg, ctx,
                       train: bool = False):
    """One stage's sub-blocks over ``x``: (x, aux summed over iterations).
    With ``train`` and ``cfg.remat``, each iteration of a stacked stage is
    checkpointed (its activations recomputed in the backward), where the
    JAX package wraps its scan body in ``jax.checkpoint``; nothing changes
    while autograd is off."""
    layers = _stage_layers(stage, stage_params)

    def iteration(x, it):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for kind, lay in zip(stage.kinds, layers):
            x, a = B.apply_sub_block(kind, _site_params(kind, lay, shared,
                                                         it), x, cfg, ctx)
            aux = aux + a
        return x, aux

    if not (stage.scan and stage.n > 1):
        return iteration(x, 0)
    remat = train and cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for it in range(stage.n):
        if remat:
            x, a = checkpoint(iteration, x, it, use_reentrant=False)
        else:
            x, a = iteration(x, it)
        aux = aux + a
    return x, aux


def _embed_inputs(params, cfg, batch):
    """Token embeddings, with a vision model's ``patches`` spliced before
    them (B, P + L, d)."""
    dtype = torch_dtype(cfg.dtype)
    x = L.embed(params["embed"], batch["tokens"], dtype)
    if cfg.frontend == "vision" and "patches" in batch:
        x = torch.cat([torch.as_tensor(batch["patches"]).to(x.device, dtype),
                       x], dim=1)
    return x


def _with_positions(cfg, x, positions):
    """x + its sinusoid positions (B, L, d): whisper's frames and tokens.
    ``positions`` is (L,), or (B, 1) per slot."""
    se = sinusoid_positions(positions.reshape(-1), cfg.d_model).to(x.dtype)
    return x + (se[:, None] if positions.dim() == 2 else se[None])


def _run_encoder(params, cfg, frames, train: bool = False):
    """The encoder over ``frames`` (B, Le, d) with sinusoid positions:
    non-causal self-attention without RoPE, then its final norm."""
    frames = torch.as_tensor(frames).to(params["embed"]["table"].device)
    le = frames.shape[1]
    positions = torch.arange(le, device=frames.device)
    x = _with_positions(cfg, frames.to(torch_dtype(cfg.dtype)), positions)
    ctx = make_ctx(cfg, positions)
    for st, sp in zip(B.encoder_stages(cfg), params["encoder"]["stages"]):
        x, _ = _run_stage_forward(st, sp, {}, x, cfg, ctx, train)
    return L.apply_norm(params["encoder"]["final_norm"], x, eps=cfg.norm_eps)


def forward_hidden(params, cfg, batch, *, train: bool = False):
    """Returns (hidden (B, L, d), aux_loss).  ``train`` turns on remat
    (``cfg.remat``) under autograd."""
    x = _embed_inputs(params, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    ctx = make_ctx(cfg, positions)
    if cfg.family == "encdec":
        ctx["enc_out"] = _run_encoder(params, cfg, batch["frames"], train)
        x = _with_positions(cfg, x, positions)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for st, sp in zip(B.stage_program(cfg), params["stages"]):
        x, a = _run_stage_forward(st, sp, params.get("shared", {}), x, cfg,
                                  ctx, train)
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
    """(mean CE + aux, {"ce", "aux"}) of next-token prediction; the
    forward runs with ``train=True``, as the JAX package's does."""
    hidden, aux = forward_hidden(params, cfg, batch, train=True)
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
    kernel up-projects; without ``params`` the layout is dense.  MLA
    sub-blocks always get their compressed {"c", "kr"} cache, gemma3's
    ``"attn_local"`` ones a dense ring of min(sliding_window, max_len)
    slots, the mamba kinds their {"h", "conv"} state.  A weight-shared
    kind's layout follows ``params["shared"]``; each of its sites gets its
    own buffers."""
    if device is None and params is not None:
        device = params["embed"]["table"].device
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    cache = []
    for si, st in enumerate(B.stage_program(cfg)):
        per_kind = []
        for ki, kind in enumerate(st.kinds):
            p = None
            if params is not None:
                p = (params.get("shared", {}).get(kind)
                     if kind in B.SHARED_KINDS else params["stages"][si][ki])
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
    """Copy ONE scheduler slot's cache out as a batch=1 cache tree.  Every
    leaf is cut on its batch axis alone, so the state leaves of the mamba
    kinds (no sequence axis) are taken like the rest."""
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


def _run_stage_cached(stage: B.Stage, stage_params, shared, x, stage_cache,
                      cfg, ctx, fn):
    """Run one stage over its cache; returns x.  ``fn`` is
    ``B.prefill_sub_block`` (returns x, cache, aux) or
    ``B.decode_sub_block`` (x, cache); both write into the cache buffers
    they are given.  Stacked layers hand each sub-block a view of its
    layer's slice of the stacked cache (where the JAX package carries the
    stacked cache through a ``fori_loop``)."""
    stacked = stage.scan and stage.n > 1
    layers = _stage_layers(stage, stage_params)
    for it in range(stage.n if stacked else 1):
        for kind, lay, c in zip(stage.kinds, layers, stage_cache):
            p = _site_params(kind, lay, shared, it)
            if stacked:
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
    last row.  Runs under ``ops.batch_invariant``, so for ``"attn"`` blocks
    every chunking of a prompt gives the logits and cache of whole
    prefill.  Not for MLA blocks, whose chunked path (absorbed) and whole
    path (expanded) are different arithmetic and agree to a tolerance, nor
    under the capacity MoE dispatch, whose outputs depend on the tokens
    routed together (in the JAX package too)."""
    with ops.batch_invariant():
        return _prefill(params, cfg, batch, cache, pos, chunked, last_idx)


def _prefill(params, cfg, batch, cache, pos, chunked, last_idx):
    x = _embed_inputs(params, cfg, batch)
    l = x.shape[1]
    positions = pos + torch.arange(l, device=x.device)
    ctx = make_ctx(cfg, positions)
    ctx["pos"] = pos
    if chunked:
        ctx["chunked"] = True
    if cfg.family == "encdec":
        ctx["enc_out"] = _run_encoder(params, cfg, batch["frames"])
        x = _with_positions(cfg, x, positions)
    for st, sp, sc in zip(B.stage_program(cfg), params["stages"], cache):
        x = _run_stage_cached(st, sp, params.get("shared", {}), x, sc, cfg,
                              ctx, B.prefill_sub_block)
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
        positions = torch.full((1,), int(pos), device=x.device)
    ctx = make_ctx(cfg, positions)
    ctx["pos"] = pos
    if cfg.family == "encdec":
        x = _with_positions(cfg, x, positions)
    for st, sp, sc in zip(B.stage_program(cfg), params["stages"], cache):
        x = _run_stage_cached(st, sp, params.get("shared", {}), x, sc, cfg,
                              ctx, B.decode_sub_block)
    hidden = L.apply_norm(params["final_norm"], x, eps=cfg.norm_eps)
    return logits_from_hidden(params, cfg, hidden)[:, 0], cache
