"""GQA attention for prefill / training (no cache).

Counterpart of ``src/repro/models/attention.py`` (``flash_attention`` :31,
``gqa_init`` / ``_project_qkv`` / ``gqa_prefill`` :116-158).  The attention
itself is the JAX package's pure-JAX online-softmax scan over key chunks,
written as torch ops: fp32 scores, ``NEG_INF`` masking, probabilities cast
to the value dtype for the PV product, running (max, denom, acc) in fp32.
It is not a Pallas kernel in the JAX package and stays plain torch in this
slice; the ``flash_attention`` CUDA kernel replaces it in a later slice.

Layouts: q (B, Lq, H, D); k, v (B, Lk, KV, D) with H % KV == 0.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models import layers as L

NEG_INF = -1e30


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, chunk: int = 512,
                    softcap: float = 0.0):
    """Online-softmax attention over key chunks.  ``window`` > 0 keeps keys
    in (q_pos - window, q_pos].  Returns (B, Lq, H, D) in q's dtype."""
    b, lq, h, d = q.shape
    lk, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = 1.0 / math.sqrt(d)
    chunk = min(chunk, lk)
    n_chunks = -(-lk // chunk)
    dev = q.device
    q_pos = q_offset + torch.arange(lq, device=dev)
    qf = q.float()
    m = torch.full((b, h, lq), NEG_INF, dtype=torch.float32, device=dev)
    l_sum = torch.zeros((b, h, lq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, lq, d), dtype=torch.float32, device=dev)
    for idx in range(n_chunks):
        k_c = k[:, idx * chunk:(idx + 1) * chunk]
        v_c = v[:, idx * chunk:(idx + 1) * chunk]
        width = k_c.shape[1]
        if g > 1:
            k_c = k_c.repeat_interleave(g, dim=2)
            v_c = v_c.repeat_interleave(g, dim=2)
        key_pos = idx * chunk + torch.arange(width, device=dev)
        s = torch.einsum("bqhd,bchd->bhqc", qf, k_c.float()) * scale
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        mask = torch.ones((lq, width), dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (key_pos[None, :] <= q_pos[:, None])
        if window:
            mask = mask & (key_pos[None, :] > q_pos[:, None] - window)
        s = torch.where(mask[None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_sum = l_sum * corr + p.sum(-1)
        pv = torch.einsum("bhqc,bchd->bhqd", p.to(v_c.dtype).float(),
                          v_c.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l_sum, min=1e-20)[..., None]
    return out.transpose(1, 2).to(q.dtype)


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
                chunk: int = 512, rope: bool = True):
    q, k, v = _project_qkv(p, x, cfg, cos, sin, rope=rope)
    o = flash_attention(q, k, v, causal=causal, window=window, chunk=chunk,
                        softcap=cfg.attn_logit_softcap)
    o = o.reshape(*x.shape[:2], -1)
    L.sow("o_in", o)
    return L.linear(p["wo"], o)
