"""Plain PyTorch versions of the hand-written kernels.

They define what each kernel computes.  The wrappers in ``kernels.ops`` use
them for tensors on the CPU, and ``chip_smoke.py`` holds each kernel against
them on the card.  Counterpart of ``src/repro/kernels/ref.py``.
"""

from __future__ import annotations

import math

import torch


def lowrank_matmul_ref(x, v, u):
    """y = (x @ v) @ u with fp32 accumulation; the rank-k intermediate is
    rounded to ``u.dtype`` before the second product."""
    t = torch.matmul(x.float(), v.float()).to(u.dtype)
    return torch.matmul(t.float(), u.float()).to(x.dtype)


def cov_accum_ref(x, xp):
    """x, xp: (T, n) -> (xᵀx, xᵀxp, xpᵀxp), each (n, n) fp32."""
    xf = x.float()
    xpf = xp.float()
    return xf.T @ xf, xf.T @ xpf, xpf.T @ xpf


def cov_accum_banked_ref(x, xp):
    """Per-expert covariance triple, the counterpart of the JAX package's
    ``ref.cov_accum_banked_ref``.  x, xp: (E, C, n) routed capacity
    buffers -> (xx, xxp, xpxp), each (E, n, n) fp32.  Zero-padded capacity
    slots add zero outer products."""
    xf = x.float()
    xpf = xp.float()

    def upd(a, b):
        return torch.einsum("etn,etm->enm", a, b)

    return upd(xf, xf), upd(xf, xpf), upd(xpf, xpf)


def cov_accum_grouped_ref(x, xp, ids, experts: int):
    """Routed-rows covariance triple oracle, the counterpart of the JAX
    package's ``ref.cov_accum_grouped_ref``.  x, xp: (R, n) choice-major
    rows of the original / shifted stream, paired per (token, choice); ids:
    (R,) expert id of each row from the ORIGINAL stream -> (xx, xxp, xpxp),
    each (E, n, n) fp32.  All three bin by the same ids."""
    oh = torch.nn.functional.one_hot(ids.long(), experts).float()   # (R, E)
    xf = x.float()
    xpf = xp.float()

    def upd(a, b):
        return torch.einsum("re,rn,rm->enm", oh, a, b)

    return upd(xf, xf), upd(xf, xpf), upd(xpf, xpf)


def grouped_matmul_ref(x, w, group_sizes):
    """Grouped expert GEMM: x (M, d) rows sorted by group, w (E, d, f),
    group_sizes (E,) integers -> (M, f) fp32.  Rows
    [sum(sizes[:e]), sum(sizes[:e+1])) multiply w[e]; rows past the sizes'
    sum are zero (as ``jax.lax.ragged_dot`` gives them).  A loop over the
    segments with fp32 products; it reads the sizes on the host."""
    m, f = x.shape[0], w.shape[-1]
    pieces = []
    start = 0
    for e, n in enumerate(group_sizes.tolist()):
        n = max(0, min(int(n), m - start))
        pieces.append(x[start:start + n].float() @ w[e].float())
        start += n
    if start < m:
        pieces.append(torch.zeros((m - start, f), dtype=torch.float32,
                                  device=x.device))
    return torch.cat(pieces)


NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        q_offset=0, chunk: int = 512, softcap: float = 0.0,
                        scale=None):
    """Online-softmax attention over key chunks — the JAX model path's
    ``models/attention.py:31`` (``flash_attention``), op for op.

    q: (B, Lq, H, D); k/v: (B, Lk, KV, D) with H % KV == 0.  ``q_offset``
    is the absolute position of q[:, 0]: an int, or a (B,) integer tensor
    when every slot sits at its own position.  ``window`` > 0 keeps keys in
    (q_pos - window, q_pos].  Scores are q·kᵀ with fp32 accumulation times
    ``scale`` (default 1/√D), optionally soft-capped as tanh(s/c)·c; masked
    scores are -1e30; running (max, denominator, accumulator) are fp32 and
    the probabilities are cast to v's dtype before the PV product.  Returns
    (B, Lq, H, D) in q's dtype."""
    b, lq, h, d = q.shape
    lk, kv = k.shape[1], k.shape[2]
    g = h // kv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    dev = q.device
    per_slot = torch.is_tensor(q_offset) and q_offset.dim() == 1
    chunk = min(chunk, lk)
    n_chunks = -(-lk // chunk)
    rows = torch.arange(lq, device=dev)
    q_pos = (q_offset.to(dev).long()[:, None] + rows if per_slot
             else q_offset + rows)                # (B, Lq) or (Lq,)
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
        mask = torch.ones(q_pos.shape + (width,), dtype=torch.bool,
                          device=dev)
        if causal:
            mask = mask & (key_pos <= q_pos[..., None])
        if window:
            mask = mask & (key_pos > q_pos[..., None] - window)
        mask = mask[:, None] if per_slot else mask[None, None]
        s = torch.where(mask, s, NEG_INF)
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


def flash_decode_ref(q, lk, lv, uk, uv, lengths, cos, sin, *,
                     rope: bool = True):
    """One decode step against the factorized latent KV cache, all in fp32 —
    the counterpart of the JAX oracle ``src/repro/kernels/ref.py:82``.

    q: (B, H, D); lk/lv: (B, L, r_k / r_v); uk/uv: the "u" factor leaves in
    their STORED layout (r_k / r_v, KV·D) (the JAX oracle takes them
    transposed to (KV, r, D)); lengths: (B,) live prefix per slot; cos/sin:
    (L, D/2) rope tables at absolute positions.  Keys are up-projected and
    RoPE'd (rotate-half at the true D); the value side stays in latent
    space until U_v is applied per head.  Returns (B, H, D) in q's dtype."""
    b, h, d = q.shape
    l = lk.shape[1]
    kv = uk.shape[-1] // d
    g = h // kv
    k = torch.matmul(lk.float(), uk.float()).reshape(b, l, kv, d)
    if rope:
        half = d // 2
        c = cos.float()[None, :, None, :]
        s_ = sin.float()[None, :, None, :]
        k1, k2 = k[..., :half], k[..., half:]
        k = torch.cat([k1 * c - k2 * s_, k2 * c + k1 * s_], dim=-1)
    k = k.repeat_interleave(g, dim=2)                         # (B, L, H, D)
    s = torch.einsum("bhd,blhd->bhl", q.float(), k) / math.sqrt(d)
    valid = (torch.arange(l, device=q.device)[None, None, :]
             < lengths.to(q.device).long()[:, None, None])
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhl,blr->bhr", p, lv.float())
    uv3 = uv.float().reshape(uv.shape[0], kv, d)              # (r_v, KV, D)
    ctx = ctx.reshape(b, kv, g, -1)
    out = torch.einsum("bkgr,rkd->bkgd", ctx, uv3).reshape(b, h, d)
    return out.to(q.dtype)
