"""Block assembly: stage programs and every sub-block kind.

Counterpart of ``src/repro/models/blocks.py`` (``stage_program`` :43,
``encoder_stages`` :75, ``init_sub_block`` :100, ``_tables`` / ``_window`` / ``_theta`` :130-143,
``apply_sub_block`` :150, ``latent_layout`` :190, ``init_sub_cache`` :207,
``_write_ring`` :244, ``prefill_sub_block`` :256, ``decode_sub_block``
:334) for the dense family's ``"attn"`` kind, gemma3's sliding-window
``"attn_local"`` / ``"attn_global"`` kinds, deepseek's
``"mla_dense_first"`` / ``"mla_moe"`` kinds (MLA attention; a dense FFN or
a MoE under either dispatch) and kimi-k2's ``"attn_dense_first"`` /
``"attn_moe"`` kinds (GQA attention; the same two FFN tails), and the SSM
family: falcon-mamba's ``"mamba1"`` and zamba2's ``"mamba2"`` backbone
with its weight-shared ``"shared_attn"`` block (attention + SwiGLU, the
``"attn"`` arithmetic), and whisper's encoder-decoder kinds:
``"enc_attn"`` (non-causal self-attention without RoPE, a gelu MLP; the
encoder's stages, ``encoder_stages``) and ``"dec_attn"`` (causal
self-attention without RoPE, then cross-attention over the encoder's
output, then the MLP).  Every kind has its cache paths: ``"attn"``,
``"attn_global"``, ``"shared_attn"``, ``"dec_attn"`` and the GQA MoE kinds
a dense {"k", "v"} or latent {"lk", "lv"} cache (``"dec_attn"`` also the
dense cross-attention keys and values {"xk", "xv"} of the encoder's
frames), ``"enc_attn"`` none, ``"attn_local"`` a ring of
``sliding_window`` dense slots, the MLA kinds their own compressed {"c",
"kr"} cache (expanded whole prefill, absorbed chunked prefill and decode),
the mamba kinds their recurrent state {"h", "conv"} (whole prefill only).
A stage with ``scan=True`` and ``n > 1`` stacks its sub-block params (and
caches) on a leading axis, as the JAX package does; the port walks that
axis in a Python loop.  Weight-shared kinds (``SHARED_KINDS``) read their
params from the model's ``shared`` slot; their caches stay per invocation
site, stacked along the stage axis.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mlp as M
from repro_torch.models import ssm as S


@dataclasses.dataclass(frozen=True)
class Stage:
    kinds: Tuple[str, ...]   # sub-block kinds applied per iteration
    n: int                   # iterations (stacked on a leading axis if > 1)
    scan: bool = True


def _not_ported(what: str, slice_name: str):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (comes with the "
        f"{slice_name} slice)")


FORWARD_KINDS = ("attn", "attn_local", "attn_global", "attn_dense_first",
                 "attn_moe", "mla_dense_first", "mla_moe", "mamba1",
                 "mamba2", "shared_attn", "enc_attn", "dec_attn")
SHARED_KINDS = ("shared_attn",)
SSM_KINDS = ("mamba1", "mamba2")
NO_ROPE_KINDS = ("enc_attn", "dec_attn")   # whisper: sinusoid positions


def stage_program(cfg) -> List[Stage]:
    if cfg.family == "hybrid":
        # zamba2: ``every`` mamba2 layers, then the shared block, scanned
        # over the groups; the remainder layers are mamba2
        every = cfg.hybrid_attn_every
        groups, rem = divmod(cfg.num_layers, every)
        stages = [Stage(("mamba2",) * every + ("shared_attn",), groups)]
        if rem:
            stages.append(Stage(("mamba2",), rem))
        return stages
    if cfg.family == "ssm":
        kind = "mamba1" if cfg.ssm.version == 1 else "mamba2"
        return [Stage((kind,), cfg.num_layers)]
    if cfg.attention == "sliding_mix":
        # gemma3: (global_every - 1) local layers, then a global one, scanned
        # over the groups; the remainder layers are local
        period = cfg.global_every
        groups, rem = divmod(cfg.num_layers, period)
        stages = [Stage(("attn_local",) * (period - 1) + ("attn_global",),
                        groups)]
        if rem:
            stages.append(Stage(("attn_local",), rem))
        return stages
    if cfg.family == "encdec":
        # whisper's decoder; its encoder is ``encoder_stages``
        return [Stage(("dec_attn",), cfg.num_layers)]
    if cfg.moe is not None and cfg.moe.num_experts:
        # deepseek (MLA) and kimi-k2 (GQA): the leading dense-FFN blocks,
        # then the MoE ones
        attn = "mla" if cfg.attention == "mla" else "attn"
        stages = []
        if cfg.moe.first_k_dense:
            stages.append(Stage((f"{attn}_dense_first",),
                                cfg.moe.first_k_dense,
                                scan=cfg.moe.first_k_dense > 1))
        stages.append(Stage((f"{attn}_moe",),
                            cfg.num_layers - cfg.moe.first_k_dense))
        return stages
    if cfg.attention == "mla":
        raise _not_ported("MLA attention without MoE", "later")
    return [Stage(("attn",), cfg.num_layers)]


def encoder_stages(cfg) -> List[Stage]:
    """The encoder's stages (whisper: ``num_encoder_layers`` stacked
    ``"enc_attn"`` layers); none for a decoder-only model."""
    if cfg.num_encoder_layers:
        return [Stage(("enc_attn",), cfg.num_encoder_layers)]
    return []


def _check_kind(kind: str) -> None:
    if kind not in FORWARD_KINDS:
        raise _not_ported(f"sub-block kind {kind!r}", "later")


def init_sub_block(kind: str, gen: torch.Generator, cfg, *, lead=(),
                   device="cpu"):
    _check_kind(kind)
    kw = dict(lead=lead, device=device)
    if kind in SSM_KINDS:
        init = S.mamba1_init if kind == "mamba1" else S.mamba2_init
        return {"ln": L.norm_init(cfg.d_model, cfg.norm, **kw),
                "mixer": init(gen, cfg, **kw)}
    p = {
        "ln1": L.norm_init(cfg.d_model, cfg.norm, **kw),
        "ln2": L.norm_init(cfg.d_model, cfg.norm, **kw),
        "attn": (A.mla_init(gen, cfg, **kw) if kind.startswith("mla")
                 else A.gqa_init(gen, cfg, **kw)),
    }
    if kind.endswith("_moe"):
        p["ffn"] = M.moe_init(gen, cfg, **kw)
    else:
        d_ff = (cfg.moe.dense_d_ff if kind.endswith("_dense_first")
                else cfg.d_ff)
        p["ffn"] = M.ffn_init(gen, cfg.d_model, d_ff, cfg.act_fn,
                              cfg.num_layers, **kw)
    if kind == "dec_attn":
        p["ln_x"] = L.norm_init(cfg.d_model, cfg.norm, **kw)
        p["xattn"] = A.gqa_init(gen, cfg, **kw)
    return p


# ---------------------------------------------------------------------------
# rope table, window and theta per kind


def _tables(kind: str, ctx):
    if kind == "attn_global" and "cos_global" in ctx:
        return ctx["cos_global"], ctx["sin_global"]
    return ctx["cos"], ctx["sin"]


def _window(kind: str, cfg) -> int:
    return cfg.sliding_window if kind == "attn_local" else 0


def _theta(kind: str, cfg) -> float:
    if kind == "attn_global" and cfg.rope_theta_global:
        return cfg.rope_theta_global
    return cfg.rope_theta


def apply_sub_block(kind: str, p, x, cfg, ctx):
    """x: (B, L, d) -> (x, aux_loss)."""
    _check_kind(kind)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind in SSM_KINDS:
        fwd = S.mamba1_forward if kind == "mamba1" else S.mamba2_forward
        with L.scope("mixer"):
            out = fwd(p["mixer"], L.apply_norm(p["ln"], x, eps=cfg.norm_eps),
                      cfg)
        return x + out, zero
    cos, sin = _tables(kind, ctx)
    h = L.apply_norm(p["ln1"], x, eps=cfg.norm_eps)
    with L.scope("attn"):
        if kind.startswith("mla"):
            attn_out = A.mla_prefill(p["attn"], h, cfg, cos, sin)
        else:
            attn_out = A.gqa_prefill(p["attn"], h, cfg, cos, sin,
                                     causal=kind != "enc_attn",
                                     window=_window(kind, cfg),
                                     rope=kind not in NO_ROPE_KINDS)
    x = x + attn_out
    if kind == "dec_attn":
        hx = L.apply_norm(p["ln_x"], x, eps=cfg.norm_eps)
        with L.scope("xattn"):
            ek, ev = A.cross_attention_kv(p["xattn"], ctx["enc_out"], cfg)
            x = x + A.cross_attention(p["xattn"], hx, ek, ev, cfg)
    h2 = L.apply_norm(p["ln2"], x, eps=cfg.norm_eps)
    with L.scope("ffn"):
        if kind.endswith("_moe"):
            y, aux = M.moe_apply(p["ffn"], h2, cfg)
            return x + y, aux
        return x + M.ffn_apply(p["ffn"], h2, cfg.act_fn), zero


# ---------------------------------------------------------------------------
# caches


def latent_layout(kind: str, params, cfg) -> Optional[Tuple[int, int]]:
    """(rank_k, rank_v) when this sub-block can store the factorized rank-r
    kv latent instead of dense k/v: bias-free factorized wk AND wv, no
    qk-norm (applied after the up-projection, so it cannot be absorbed) and
    no logit softcap (the decode kernel has none), and an absolute-position
    cache: MLA kinds keep their own compressed cache, ``"attn_local"`` its
    ring and the mamba kinds their state, and ``"enc_attn"`` keeps no
    cache, so all give ``None``."""
    _check_kind(kind)
    if (params is None or kind.startswith("mla") or kind == "attn_local"
            or kind == "enc_attn" or kind in SSM_KINDS or cfg.qk_norm
            or cfg.attn_logit_softcap):
        return None
    return A.latent_ranks(params.get("attn")) if isinstance(params, dict) \
        else None


def init_sub_cache(kind: str, cfg, batch: int, max_len: int, dtype,
                   params=None, *, device="cpu"):
    """Zero cache for one sub-block: MLA's compressed {"c", "kr"}
    (kv_lora_rank + qk_rope_head_dim floats per token); ``"attn_local"``'s
    ring of min(sliding_window, max_len) dense slots; for ``"attn"`` and
    ``"attn_global"``, ``"shared_attn"``, ``"dec_attn"`` and the GQA MoE
    kinds the latent {"lk", "lv"} layout (rank-r floats per token) when
    ``params`` has factorized kv projections, else dense {"k", "v"}
    (``"dec_attn"`` adds the dense cross-attention {"xk", "xv"} of
    (B, encoder_seq_len, KV, D) whatever the layout); ``"enc_attn"``
    nothing; the mamba kinds their state: ``h`` fp32, ``conv`` in
    ``dtype``."""
    kw = dict(dtype=dtype, device=device)
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    if kind in SSM_KINDS:
        init = (S.mamba1_init_state if kind == "mamba1"
                else S.mamba2_init_state)
        return init(None, cfg, batch, dtype, device=device)
    if kind == "attn_local":
        w = min(cfg.sliding_window, max_len)
        return {"k": torch.zeros((batch, w, kv, hd), **kw),
                "v": torch.zeros((batch, w, kv, hd), **kw)}
    if kind.startswith("mla"):
        m = cfg.mla
        return {"c": torch.zeros((batch, max_len, m.kv_lora_rank), **kw),
                "kr": torch.zeros((batch, max_len, m.qk_rope_head_dim),
                                  **kw)}
    if kind == "enc_attn":
        return {}
    ranks = latent_layout(kind, params, cfg)
    if ranks is not None:
        base = {"lk": torch.zeros((batch, max_len, ranks[0]), **kw),
                "lv": torch.zeros((batch, max_len, ranks[1]), **kw)}
    else:
        base = {"k": torch.zeros((batch, max_len, kv, hd), **kw),
                "v": torch.zeros((batch, max_len, kv, hd), **kw)}
    if kind == "dec_attn":
        le = cfg.encoder_seq_len
        base["xk"] = torch.zeros((batch, le, kv, hd), **kw)
        base["xv"] = torch.zeros((batch, le, kv, hd), **kw)
    return base


def _write_ring(cache, new, start: int):
    """Write new (B, L, ...) into the ring cache (B, W, ...) at absolute
    position ``start``, in place: key p lands in slot p % W, and of a
    prompt longer than the ring only its last W keys are kept."""
    w, l = cache.shape[1], new.shape[1]
    if l >= w:
        slots = (start + l - w + torch.arange(w, device=cache.device)) % w
        cache[:, slots] = new[:, l - w:].to(cache.dtype)
    else:
        slots = (start + torch.arange(l, device=cache.device)) % w
        cache[:, slots] = new.to(cache.dtype)
    return cache


def _copy_state(cache, state) -> None:
    """Write a mamba block's new {"h", "conv"} into its cache buffers (the
    caller's views of a stacked cache included), in place."""
    for key in ("h", "conv"):
        cache[key].copy_(state[key])


def prefill_sub_block(kind: str, p, x, cache, cfg, ctx):
    """Forward over the prompt, filling the cache (in place) from
    ``ctx["pos"]``.  ``ctx["chunked"]`` attends against the WHOLE cache with
    absolute-position masking, so a prompt can be prefilled chunk by chunk
    (not into a ring cache, as in the JAX package).  Returns (x, cache,
    aux).  MLA's chunked path (absorbed) and whole path (expanded) are
    different arithmetic, equal to a tolerance.  The mamba kinds run the
    whole prompt from a zero state and copy the final state into the cache
    (chunked prefill raises: a state cannot resume mid-sequence here, as in
    the JAX package)."""
    _check_kind(kind)
    if kind in SSM_KINDS:
        if ctx.get("chunked"):
            raise ValueError("chunked prefill unsupported for SSM blocks")
        fwd = S.mamba1_forward if kind == "mamba1" else S.mamba2_forward
        y, state = fwd(p["mixer"], L.apply_norm(p["ln"], x, eps=cfg.norm_eps),
                       cfg, return_state=True)
        _copy_state(cache, state)
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        return x + y, cache, zero
    start = ctx.get("pos", 0)
    rope = kind not in NO_ROPE_KINDS
    cos, sin = _tables(kind, ctx)
    h = L.apply_norm(p["ln1"], x, eps=cfg.norm_eps)
    cache = dict(cache)
    if kind.startswith("mla"):
        if ctx.get("chunked"):
            attn_out, cache["c"], cache["kr"] = A.mla_prefill_cached(
                p["attn"], h, cache["c"], cache["kr"], start, cfg, cos, sin)
        else:
            attn_out, (c, kr) = A.mla_prefill(p["attn"], h, cfg, cos, sin,
                                              return_cache=True)
            cache["c"] = A._write_at(cache["c"], c, start)
            cache["kr"] = A._write_at(cache["kr"], kr, start)
    elif "lk" in cache:
        attn_out, cache["lk"], cache["lv"] = A.gqa_prefill_latent(
            p["attn"], h, cache["lk"], cache["lv"], start, cfg, cos, sin,
            theta=_theta(kind, cfg), rope=rope)
    elif ctx.get("chunked"):
        if kind == "attn_local":
            raise ValueError("chunked prefill unsupported for ring caches")
        attn_out, cache["k"], cache["v"] = A.gqa_prefill_cached(
            p["attn"], h, cache["k"], cache["v"], start, cfg, cos, sin,
            rope=rope)
    else:
        attn_out, (k, v) = A.gqa_prefill(p["attn"], h, cfg, cos, sin,
                                         window=_window(kind, cfg),
                                         return_kv=True, rope=rope)
        write = _write_ring if kind == "attn_local" else A._write_at
        cache["k"] = write(cache["k"], k, start)
        cache["v"] = write(cache["v"], v, start)
    x = x + attn_out
    if kind == "dec_attn":
        hx = L.apply_norm(p["ln_x"], x, eps=cfg.norm_eps)
        ek, ev = A.cross_attention_kv(p["xattn"], ctx["enc_out"], cfg)
        cache["xk"].copy_(ek)
        cache["xv"].copy_(ev)
        x = x + A.cross_attention(p["xattn"], hx, ek, ev, cfg)
    h2 = L.apply_norm(p["ln2"], x, eps=cfg.norm_eps)
    if kind.endswith("_moe"):
        y, aux = M.moe_apply(p["ffn"], h2, cfg)
        return x + y, cache, aux
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + M.ffn_apply(p["ffn"], h2, cfg.act_fn), cache, zero


def decode_sub_block(kind: str, p, x, cache, cfg, ctx):
    """x: (B, 1, d) -> (x, cache), the cache updated in place at
    ``ctx["pos"]`` (an int or a per-slot (B,) tensor); the mamba kinds
    advance their state by one token, in place; ``"dec_attn"`` attends
    across to its cached {"xk", "xv"}."""
    _check_kind(kind)
    if kind in SSM_KINDS:
        dec = S.mamba1_decode if kind == "mamba1" else S.mamba2_decode
        y, state = dec(p["mixer"], L.apply_norm(p["ln"], x, eps=cfg.norm_eps),
                       cache, cfg)
        _copy_state(cache, state)
        return x + y, cache
    pos = ctx["pos"]
    cos, sin = _tables(kind, ctx)
    h = L.apply_norm(p["ln1"], x, eps=cfg.norm_eps)
    cache = dict(cache)
    if kind.startswith("mla"):
        attn_out, cache["c"], cache["kr"] = A.mla_decode(
            p["attn"], h, cache["c"], cache["kr"], pos, cfg, cos, sin)
    elif kind == "attn_local":
        attn_out, cache["k"], cache["v"] = A.ring_decode(
            p["attn"], h, cache["k"], cache["v"], pos, cfg, cos, sin,
            window=cfg.sliding_window)
    elif "lk" in cache:
        attn_out, cache["lk"], cache["lv"] = A.gqa_decode_latent(
            p["attn"], h, cache["lk"], cache["lv"], pos, cfg, cos, sin,
            theta=_theta(kind, cfg), rope=kind not in NO_ROPE_KINDS)
    else:
        attn_out, cache["k"], cache["v"] = A.gqa_decode(
            p["attn"], h, cache["k"], cache["v"], pos, cfg, cos, sin,
            rope=kind not in NO_ROPE_KINDS)
    x = x + attn_out
    if kind == "dec_attn":
        hx = L.apply_norm(p["ln_x"], x, eps=cfg.norm_eps)
        x = x + A.cross_attention(p["xattn"], hx, cache["xk"], cache["xv"],
                                  cfg)
    h2 = L.apply_norm(p["ln2"], x, eps=cfg.norm_eps)
    if kind.endswith("_moe"):
        return x + M.moe_apply(p["ffn"], h2, cfg)[0], cache
    return x + M.ffn_apply(p["ffn"], h2, cfg.act_fn), cache
