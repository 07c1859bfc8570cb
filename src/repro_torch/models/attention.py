"""GQA attention: prefill / training, decode against a dense or latent cache.

Counterpart of ``src/repro/models/attention.py``: ``flash_attention`` :31,
``gqa_init`` / ``_project_qkv`` / ``gqa_prefill`` :116-158, the dense-cache
decode paths ``_cache_write`` :161, ``gqa_decode`` :174,
``gqa_prefill_cached`` :186 and ``_decode_attention`` :204 (without its
sequence-parallel mesh branch), and the factorized latent-cache paths
``latent_ranks`` :528, ``_latent_kv`` :546, ``gqa_prefill_latent`` :554 and
``gqa_decode_latent`` :583, the sliding-window ring cache's
``ring_decode`` :311, whisper's cross-attention ``cross_attention_kv`` /
``cross_attention`` :354-371, and MLA: the expanded prefill path ``mla_init``
/ ``_mla_q`` / ``_mla_ckv`` / ``mla_prefill`` / ``_pad_last`` :378-449 and
the compressed-cache paths over {"c", "kr"} ``_mla_absorbed_attend`` :451,
``mla_decode`` :481 and ``mla_prefill_cached`` :499.

Every attention product goes through the hand-written kernels on the card:
``flash_attention`` (prefill, MLA prefill at head dim 192, chunked and
latent prefill, dense-cache decode, the forwards of compression, and
non-causal: whisper's encoder and its decoder's cross-attention, prefill
and decode) and ``flash_decode`` (decode
against the latent {"lk", "lv"} cache).  On the CPU their plain versions
run (``kernels.ref``).  ``ring_decode`` and MLA's absorbed path are plain
fp32 torch ops, as the JAX package leaves them to XLA.

Layouts: q (B, Lq, H, D); k, v (B, Lk, KV, D) with H % KV == 0; dense
caches (B, Lmax, KV, D); latent caches (B, Lmax, r).  The cache functions
write into the given buffers IN PLACE and return them (the JAX package
returns fresh arrays; its serving loop donates the old ones).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers as L

NEG_INF = -1e30


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset=0, chunk: int = 512, softcap: float = 0.0):
    """Online-softmax attention; ``q_offset`` is the absolute position of
    q[:, 0] — an int, or a (B,) tensor when every slot sits at its own
    position.  ``window`` > 0 keeps keys in (q_pos - window, q_pos].
    Returns (B, Lq, H, D) in q's dtype; differentiable."""
    return ops.flash_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset, chunk=chunk,
                               softcap=softcap)


def _per_slot(pos) -> bool:
    return torch.is_tensor(pos) and pos.dim() == 1


# ---------------------------------------------------------------------------
# GQA attention layer


def gqa_init(gen: torch.Generator, cfg, *, lead=(), dtype=torch.float32,
             device="cpu"):
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kw = dict(lead=lead, dtype=dtype, device=device)
    p = {
        "wq": L.linear_init(gen, d, h * hd, **kw),
        "wk": L.linear_init(gen, d, kv * hd, **kw),
        "wv": L.linear_init(gen, d, kv * hd, **kw),
        "wo": L.linear_init(gen, h * hd, d, **kw,
                            scale=1.0 / math.sqrt(h * hd * 2 * cfg.num_layers)),
    }
    if cfg.qk_norm:
        p["q_norm"] = L.norm_init(hd, lead=lead, device=device)
        p["k_norm"] = L.norm_init(hd, lead=lead, device=device)
    return p


def _project_qkv(p, x, cfg, cos, sin, *, rope: bool = True):
    b, l, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    L.sow("qkv_in", x)
    q = L.linear(p["wq"], x).reshape(b, l, h, hd)
    k = L.linear(p["wk"], x).reshape(b, l, kv, hd)
    v = L.linear(p["wv"], x).reshape(b, l, kv, hd)
    if cfg.qk_norm:
        q = L.apply_norm(p["q_norm"], q, eps=cfg.norm_eps)
        k = L.apply_norm(p["k_norm"], k, eps=cfg.norm_eps)
    if rope:
        q = L.apply_rope(q, cos, sin)
        k = L.apply_rope(k, cos, sin)
    return q, k, v


def gqa_prefill(p, x, cfg, cos, sin, *, causal=True, window: int = 0,
                chunk: int = 512, return_kv: bool = False, rope: bool = True):
    q, k, v = _project_qkv(p, x, cfg, cos, sin, rope=rope)
    o = flash_attention(q, k, v, causal=causal, window=window, chunk=chunk,
                        softcap=cfg.attn_logit_softcap)
    o = o.reshape(*x.shape[:2], -1)
    L.sow("o_in", o)
    out = L.linear(p["wo"], o)
    if return_kv:
        return out, (k, v)
    return out


# ---------------------------------------------------------------------------
# dense cache


def _write_at(cache, new, start: int):
    """cache[:, start:start + L] = new (in place)."""
    cache[:, start:start + new.shape[1]] = new.to(cache.dtype)
    return cache


def _cache_write(cache, new, pos):
    """Write one decode step into a (B, Lmax, ...) cache, in place.

    ``new`` is (B, 1, ...); ``pos`` is an int (every slot at the same
    position) or a (B,) tensor of per-slot positions."""
    if _per_slot(pos):
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, pos.long()] = new[:, 0].to(cache.dtype)
        return cache
    return _write_at(cache, new, pos)


def _decode_attention(q, cache_k, cache_v, pos, cfg, *, window: int = 0,
                      chunk: int = 1024):
    """Attention of the step's queries against the whole dense cache with
    absolute-position masking (keys past ``pos`` are causally masked).  The
    JAX package's sequence-parallel branch for an L-sharded cache is not
    ported (it needs a mesh)."""
    return flash_attention(q, cache_k, cache_v, causal=True, window=window,
                           q_offset=pos, chunk=chunk,
                           softcap=cfg.attn_logit_softcap)


def gqa_decode(p, x, cache_k, cache_v, pos, cfg, cos, sin, *,
               window: int = 0, chunk: int = 1024, rope: bool = True):
    """One-token decode.  x: (B, 1, d); caches (B, Lmax, KV, D); pos is an
    int or a per-slot (B,) tensor."""
    q, k, v = _project_qkv(p, x, cfg, cos, sin, rope=rope)
    cache_k = _cache_write(cache_k, k, pos)
    cache_v = _cache_write(cache_v, v, pos)
    o = _decode_attention(q, cache_k, cache_v, pos, cfg, window=window,
                          chunk=chunk)
    return L.linear(p["wo"], o.reshape(*x.shape[:2], -1)), cache_k, cache_v


def gqa_prefill_cached(p, x, cache_k, cache_v, start: int, cfg, cos, sin, *,
                       chunk: int = 1024, rope: bool = True):
    """Chunked prefill: write this chunk's k/v into the dense cache at
    ``start`` and attend against the WHOLE cache with absolute positions;
    unwritten future positions are causally masked, so chunk-by-chunk
    prefill gives the logits of whole-prompt prefill."""
    q, k, v = _project_qkv(p, x, cfg, cos, sin, rope=rope)
    cache_k = _write_at(cache_k, k, start)
    cache_v = _write_at(cache_v, v, start)
    o = flash_attention(q, cache_k, cache_v, causal=True, q_offset=start,
                        chunk=chunk, softcap=cfg.attn_logit_softcap)
    out = L.linear(p["wo"], o.reshape(*x.shape[:2], -1))
    return out, cache_k, cache_v


def ring_decode(p, x, cache_k, cache_v, pos, cfg, cos, sin, *,
                window: int):
    """One-token decode against a ring-buffer sliding-window cache of W
    slots (B, W, KV, D).  pos is an int or a per-slot (B,) tensor; this
    token's k / v go to slot pos % W.  Slot i holds the key written at
    absolute position p_i = pos - ((pos - i) mod W); slots with p_i < 0 (not
    yet written) or p_i <= pos - window are masked.  RoPE was applied at
    write time with absolute positions, so scores are taken against the
    stored keys: fp32 einsums and a masked softmax."""
    b = x.shape[0]
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = h // kv
    w = cache_k.shape[1]
    q, k, v = _project_qkv(p, x, cfg, cos, sin)
    slot = pos % w
    cache_k = _cache_write(cache_k, k, slot)
    cache_v = _cache_write(cache_v, v, slot)
    slots = torch.arange(w, device=x.device)
    if _per_slot(pos):
        posb = pos.long()[:, None]                           # (B, 1)
        key_pos = posb - torch.remainder(posb - slots[None], w)
        valid = (key_pos >= 0) & (key_pos > posb - window)  # (B, W)
        vmask = valid[:, None, None, None, :]
    else:
        key_pos = pos - torch.remainder(pos - slots, w)
        valid = (key_pos >= 0) & (key_pos > pos - window)
        vmask = valid[None, None, None, None]
    qg = q.reshape(b, 1, kv, g, hd).float() / math.sqrt(hd)
    s = torch.einsum("bqkgd,bwkd->bkgqw", qg, cache_k.float())
    if cfg.attn_logit_softcap:
        s = torch.tanh(s / cfg.attn_logit_softcap) * cfg.attn_logit_softcap
    s = torch.where(vmask, s, NEG_INF)
    pattn = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqw,bwkd->bqkgd", pattn, cache_v.float())
    o = o.reshape(b, 1, h * hd).to(x.dtype)
    return L.linear(p["wo"], o), cache_k, cache_v


# ---------------------------------------------------------------------------
# cross-attention (whisper's decoder): keys and values of the encoder's
# output, made once a prompt


def cross_attention_kv(p, enc_out, cfg):
    """(k, v) (B, Le, KV, D) of the encoder's output; tap ``kv_in``."""
    b, le, _ = enc_out.shape
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    L.sow("kv_in", enc_out)
    k = L.linear(p["wk"], enc_out).reshape(b, le, kv, hd)
    v = L.linear(p["wv"], enc_out).reshape(b, le, kv, hd)
    return k, v


def cross_attention(p, x, k, v, cfg, *, chunk: int = 512):
    """x (B, L, d) attends to every encoder frame: ``flash_attention`` with
    no causal mask (Lq 1 at decode); taps ``q_in`` and ``o_in``."""
    b, l, _ = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    L.sow("q_in", x)
    q = L.linear(p["wq"], x).reshape(b, l, h, hd)
    o = flash_attention(q, k, v, causal=False, chunk=chunk)
    o = o.reshape(b, l, -1)
    L.sow("o_in", o)
    return L.linear(p["wo"], o)


# ---------------------------------------------------------------------------
# factorized latent KV cache (AA-SVD serving path)
#
# When the k/v projections are factorized (w = v @ u, bias-free), the
# per-token cache state the model needs is the rank-r latent l = x @ v.
# Decode stores only (B, Lmax, r_k) + (B, Lmax, r_v), and the flash_decode
# kernel up-projects keys in the kernel while keeping the value accumulator
# in latent space (U_v applied once per head in the epilogue).


def latent_ranks(p):
    """(rank_k, rank_v) when BOTH k/v projections are bias-free factorized
    pairs — the layout the latent KV cache requires; else ``None``.  Works
    on plain and stacked (leading layer axis) param leaves."""
    def rank(w):
        if isinstance(w, dict) and "w" not in w and "b" not in w and "u" in w:
            return int(w["v"].shape[-1])
        return None
    if not isinstance(p, dict):
        return None
    rk, rv = rank(p.get("wk")), rank(p.get("wv"))
    if rk is None or rv is None:
        return None
    return rk, rv


def _latent_kv(p, x):
    """Down-projected kv latents x @ V — the only per-token state the
    factorized cache stores; U is applied at attention time.  Through
    ``lowrank_matmul``'s kernel, so a prompt's latents do not depend on how
    it was chunked."""
    x = x.contiguous()
    return tuple(ops.lowrank_down(x, p[w]["v"].to(x.dtype).contiguous())
                 for w in ("wk", "wv"))


def gqa_prefill_latent(p, x, cache_lk, cache_lv, start: int, cfg, cos, sin,
                       *, theta: float, rope: bool = True,
                       chunk: int = 1024):
    """Prefill into the latent cache: write this chunk's rank-r latents at
    ``start``, up-project the whole cache once (``ops.lowrank_up``), and
    attend with absolute-position masking.  Used for whole prompts (start
    0) and for chunked prefill alike."""
    b, l, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = L.linear(p["wq"], x).reshape(b, l, h, hd)
    if rope:
        q = L.apply_rope(q, cos, sin)
    lk_c, lv_c = _latent_kv(p, x)
    cache_lk = _write_at(cache_lk, lk_c, start)
    cache_lv = _write_at(cache_lv, lv_c, start)
    lmax = cache_lk.shape[1]
    # through the kernel's t @ U, as the dense layout's k and v are made, so
    # the two layouts round them alike
    k_all = ops.lowrank_up(cache_lk, p["wk"]["u"].to(cache_lk.dtype)
                           .contiguous()).reshape(b, lmax, kv, hd)
    v_all = ops.lowrank_up(cache_lv, p["wv"]["u"].to(cache_lv.dtype)
                           .contiguous()).reshape(b, lmax, kv, hd)
    if rope:
        cos_all, sin_all = L.rope_table(
            torch.arange(lmax, device=x.device), hd, theta)
        k_all = L.apply_rope(k_all, cos_all, sin_all)
    o = flash_attention(q, k_all, v_all, causal=True, q_offset=start,
                        chunk=chunk)
    return L.linear(p["wo"], o.reshape(b, l, -1)), cache_lk, cache_lv


def gqa_decode_latent(p, x, cache_lk, cache_lv, pos, cfg, cos, sin, *,
                      theta: float, rope: bool = True):
    """One-token decode against the factorized latent cache through the
    ``flash_decode`` kernel, with per-slot lengths = pos + 1.

    x: (B, 1, d); caches (B, Lmax, r_k / r_v); pos an int or a (B,)
    tensor.  The "u" leaves go to the kernel as stored (fp32 params)."""
    b = x.shape[0]
    h, hd = cfg.num_heads, cfg.head_dim
    q = L.linear(p["wq"], x).reshape(b, 1, h, hd)
    if rope:
        q = L.apply_rope(q, cos, sin)
    lk_t, lv_t = _latent_kv(p, x)
    cache_lk = _cache_write(cache_lk, lk_t, pos)
    cache_lv = _cache_write(cache_lv, lv_t, pos)
    if _per_slot(pos):
        lengths = (pos + 1).to(torch.int32)
    else:
        lengths = torch.full((b,), pos + 1, dtype=torch.int32,
                             device=x.device)
    lmax = cache_lk.shape[1]
    cos_all, sin_all = L.rope_table(torch.arange(lmax, device=x.device), hd,
                                    theta)
    o = ops.flash_decode(q[:, 0].contiguous(), cache_lk, cache_lv,
                         p["wk"]["u"], p["wv"]["u"], lengths, cos_all,
                         sin_all, rope=rope)
    return (L.linear(p["wo"], o.reshape(b, 1, h * hd).to(x.dtype)),
            cache_lk, cache_lv)


# ---------------------------------------------------------------------------
# MLA — multi-head latent attention (DeepSeek-V2), expanded prefill path


def mla_init(gen: torch.Generator, cfg, *, lead=(), dtype=torch.float32,
             device="cpu"):
    d, h = cfg.d_model, cfg.num_heads
    m = cfg.mla
    qd = m.qk_nope_head_dim + m.qk_rope_head_dim
    kw = dict(lead=lead, dtype=dtype, device=device)
    return {
        # q projection (dense — V2-Lite has no q-lora)
        "wq": L.linear_init(gen, d, h * qd, **kw),
        # compressed kv + shared rope key
        "wkv_a": L.linear_init(gen, d, m.kv_lora_rank + m.qk_rope_head_dim,
                               **kw),
        "kv_norm": L.norm_init(m.kv_lora_rank, lead=lead, device=device),
        # decompression: kv_lora -> per-head (nope key | value)
        "wk_b": L.linear_init(gen, m.kv_lora_rank, h * m.qk_nope_head_dim,
                              **kw),
        "wv_b": L.linear_init(gen, m.kv_lora_rank, h * m.v_head_dim, **kw),
        "wo": L.linear_init(gen, h * m.v_head_dim, d, **kw,
                            scale=1.0 / math.sqrt(h * m.v_head_dim * 2
                                                  * cfg.num_layers)),
    }


def _mla_q(p, x, cfg, cos, sin):
    b, l, _ = x.shape
    h, m = cfg.num_heads, cfg.mla
    qd = m.qk_nope_head_dim + m.qk_rope_head_dim
    L.sow("qkv_in", x)
    q = L.linear(p["wq"], x).reshape(b, l, h, qd)
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    return q_nope, L.apply_rope(q_rope, cos, sin)


def _mla_ckv(p, x, cfg, cos, sin):
    m = cfg.mla
    ckv = L.linear(p["wkv_a"], x)
    c, k_rope = ckv[..., :m.kv_lora_rank], ckv[..., m.kv_lora_rank:]
    c = L.apply_norm(p["kv_norm"], c, eps=cfg.norm_eps)
    k_rope = L.apply_rope(k_rope[:, :, None, :], cos, sin)[:, :, 0, :]
    return c, k_rope  # (B, L, r), (B, L, rope_dim)


def _pad_last(x, to: int):
    pad = to - x.shape[-1]
    return x if pad == 0 else F.pad(x, (0, pad))


def mla_prefill(p, x, cfg, cos, sin, *, chunk: int = 512,
                return_cache: bool = False):
    """Expanded path: decompress per-token k/v from the latent, run
    ``flash_attention`` as MHA at head dim qk_nope + qk_rope (v zero-padded
    to it, the padded output columns sliced away).  ``cos`` / ``sin`` are
    tables over ``qk_rope_head_dim``.  ``return_cache`` also returns the
    compressed cache entries (c (B, L, kv_lora_rank) after ``kv_norm``,
    k_rope (B, L, qk_rope_head_dim) after RoPE)."""
    b, l, _ = x.shape
    h, m = cfg.num_heads, cfg.mla
    q_nope, q_rope = _mla_q(p, x, cfg, cos, sin)
    c, k_rope = _mla_ckv(p, x, cfg, cos, sin)
    L.sow("kvb_in", c)
    k_nope = L.linear(p["wk_b"], c).reshape(b, l, h, m.qk_nope_head_dim)
    v = L.linear(p["wv_b"], c).reshape(b, l, h, m.v_head_dim)
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        b, l, h, m.qk_rope_head_dim)], -1)
    o = flash_attention(q, k, _pad_last(v, q.shape[-1]), causal=True,
                        chunk=chunk)[..., :m.v_head_dim]
    o = o.reshape(b, l, -1)
    L.sow("o_in", o)
    out = L.linear(p["wo"], o)
    if return_cache:
        return out, (c, k_rope)
    return out


# ---------------------------------------------------------------------------
# MLA against the compressed {"c", "kr"} cache (absorbed path)


def _composed(lin):
    """A kv up-projection's dense (r, out) matrix: its "w", or v @ u of a
    factorized pair (a plain matmul, as the JAX package composes it)."""
    return lin["w"] if "w" in lin else torch.matmul(lin["v"], lin["u"])


def _mla_absorbed_attend(p, q_nope, q_rope, cache_c, cache_kr, q_pos, cfg):
    """Attend against the compressed cache with W_uk / W_uv absorbed.

    q_nope / q_rope: (B, Lq, H, ·); caches (B, Lmax, r / rope_dim).
    ``q_pos`` is a (1|B, Lq) tensor of absolute query positions: (1, 1) for
    one position, (B, 1) per slot, (1, Lq) for a chunk; keys past a query's
    position are masked.  W_uk folds into the query and W_uv into the
    context, so the cache stays compressed.  Every product is fp32 over the
    whole cache.  Returns (B, Lq, H, v_head_dim) fp32."""
    h, m = cfg.num_heads, cfg.mla
    r = m.kv_lora_rank
    f32 = torch.float32
    wk_b = _composed(p["wk_b"]).reshape(r, h, m.qk_nope_head_dim)
    q_eff = torch.einsum("bqhd,rhd->bqhr", q_nope.to(f32), wk_b.to(f32))
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    c = cache_c.to(f32)
    s = (torch.einsum("bqhr,blr->bhql", q_eff, c)
         + torch.einsum("bqhd,bld->bhql", q_rope.to(f32),
                        cache_kr.to(f32))) * scale
    keys = torch.arange(cache_c.shape[1], device=cache_c.device)
    valid = keys[None, None] <= q_pos[..., None]      # (1|B, Lq, Lmax)
    s = s.masked_fill(~valid[:, None], NEG_INF)
    pattn = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhql,blr->bqhr", pattn, c)
    wv_b = _composed(p["wv_b"]).reshape(r, h, m.v_head_dim)
    return torch.einsum("bqhr,rhd->bqhd", ctx, wv_b.to(f32))


def mla_decode(p, x, cache_c, cache_kr, pos, cfg, cos, sin):
    """Absorbed decode: write this token's {c, kr} at ``pos`` (an int, or a
    per-slot (B,) tensor) and score against the compressed cache.
    x: (B, 1, d); cache_c (B, Lmax, r); cache_kr (B, Lmax, rope_dim)."""
    b = x.shape[0]
    q_nope, q_rope = _mla_q(p, x, cfg, cos, sin)
    c_t, kr_t = _mla_ckv(p, x, cfg, cos, sin)
    cache_c = _cache_write(cache_c, c_t, pos)
    cache_kr = _cache_write(cache_kr, kr_t, pos)
    if _per_slot(pos):
        q_pos = pos[:, None]
    else:
        q_pos = torch.full((1, 1), int(pos), device=x.device)
    o = _mla_absorbed_attend(p, q_nope, q_rope, cache_c, cache_kr, q_pos,
                             cfg)
    out = L.linear(p["wo"], o.reshape(b, 1, -1).to(x.dtype))
    return out, cache_c, cache_kr


def mla_prefill_cached(p, x, cache_c, cache_kr, start: int, cfg, cos, sin):
    """Chunked prefill for MLA: write this chunk's {c, kr} at ``start``,
    then run the absorbed path against the whole cache (unwritten future
    positions masked).  Absorbed and expanded prefill are different
    arithmetic: they agree to fp32 rounding, not bit for bit."""
    b, l, _ = x.shape
    q_nope, q_rope = _mla_q(p, x, cfg, cos, sin)
    c, kr = _mla_ckv(p, x, cfg, cos, sin)
    cache_c = _write_at(cache_c, c, start)
    cache_kr = _write_at(cache_kr, kr, start)
    q_pos = (start + torch.arange(l, device=x.device))[None]
    o = _mla_absorbed_attend(p, q_nope, q_rope, cache_c, cache_kr, q_pos,
                             cfg)
    out = L.linear(p["wo"], o.reshape(b, l, -1).to(x.dtype))
    return out, cache_c, cache_kr
