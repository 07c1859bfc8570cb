"""GQA attention: prefill / training, decode against a dense or latent cache.

Counterpart of ``src/repro/models/attention.py``: ``flash_attention`` :31,
``gqa_init`` / ``_project_qkv`` / ``gqa_prefill`` :116-158, the dense-cache
decode paths ``_cache_write`` :161, ``gqa_decode`` :174,
``gqa_prefill_cached`` :186 and ``_decode_attention`` :204 (without its
sequence-parallel mesh branch), and the factorized latent-cache paths
``latent_ranks`` :528, ``_latent_kv`` :546, ``gqa_prefill_latent`` :554 and
``gqa_decode_latent`` :583, and the MLA prefill path ``mla_init`` /
``_mla_q`` / ``_mla_ckv`` / ``mla_prefill`` / ``_pad_last`` :378-449.  MLA's
cache paths (``mla_decode``, ``mla_prefill_cached``,
``_mla_absorbed_attend``) come with the deepseek serving slice.

Every attention product goes through the hand-written kernels on the card:
``flash_attention`` (prefill, MLA prefill at head dim 192, chunked and
latent prefill, dense-cache decode, and the forwards of compression) and ``flash_decode`` (decode
against the latent {"lk", "lv"} cache).  On the CPU their plain versions
run (``kernels.ref``).

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
    ``start``, up-project the whole cache once, and attend with
    absolute-position masking.  Used for whole prompts (start 0) and for
    chunked prefill alike."""
    b, l, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = L.linear(p["wq"], x).reshape(b, l, h, hd)
    if rope:
        q = L.apply_rope(q, cos, sin)
    lk_c, lv_c = _latent_kv(p, x)
    cache_lk = _write_at(cache_lk, lk_c, start)
    cache_lv = _write_at(cache_lv, lv_c, start)
    lmax = cache_lk.shape[1]
    k_all = (cache_lk @ p["wk"]["u"].to(cache_lk.dtype)).reshape(b, lmax, kv,
                                                                 hd)
    v_all = (cache_lv @ p["wv"]["u"].to(cache_lv.dtype)).reshape(b, lmax, kv,
                                                                 hd)
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


def mla_prefill(p, x, cfg, cos, sin, *, chunk: int = 512):
    """Expanded path: decompress per-token k/v from the latent, run
    ``flash_attention`` as MHA at head dim qk_nope + qk_rope (v zero-padded
    to it, the padded output columns sliced away).  ``cos`` / ``sin`` are
    tables over ``qk_rope_head_dim``."""
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
    return L.linear(p["wo"], o)
