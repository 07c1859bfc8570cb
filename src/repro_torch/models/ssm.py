"""State-space blocks: Mamba1 (chunk-recurrent selective scan) and Mamba2
(SSD, chunked matmul form).

Counterpart of ``src/repro/models/ssm.py`` (``causal_conv`` :28,
``causal_conv_step`` :38, ``mamba1_init`` :50, ``_mamba1_inputs`` :73,
``_tail_conv_state`` :92, ``_mamba1_scan_chunk`` :101, ``mamba1_forward``
:117, ``mamba1_init_state`` :157, ``mamba1_decode`` :166, ``mamba2_init``
:194, ``_mamba2_inputs`` :215, ``_ssd_chunk_body`` :227, ``mamba2_forward``
:250, ``mamba2_init_state`` :293, ``mamba2_decode`` :303).  The JAX package
leaves the scans to XLA (no Pallas kernel), so here they are torch ops on
the tensors' own device; the linears go through ``layers.linear`` (the
``lowrank_matmul`` kernel once factorized).

The arithmetic follows the reference's order where the two could round
apart: the depthwise conv sums its ``width`` shifted products in order (not
``F.conv1d``), softplus is ``logaddexp(x, 0)`` (``jax.nn.softplus``; not
``F.softplus``, which returns x past its threshold), and chunks are padded
with ``dt = 0`` (identity decay, zero input) so the returned state is the
state after the last real token.  One departure: the reference's SSD body
forms exp(cums_i − cums_j) over the whole chunk square and applies the
causal mask after, so once a chunk's Σ dt·|A| passes ~88 the masked
entries (j > i) overflow to inf and inf · 0 makes the output NaN.  Here
the exponent of a masked entry is −inf before the exp (its factor is
exactly 0): every entry the mask keeps, and every product and sum, is the
reference formula's, so wherever that formula is finite the masked one
gives the same bits; where it is NaN this gives the finite value of the
recurrence.  Refinement at published widths pushes zamba2's dt that far
(one sign-like Adam step on the in_proj factors).
Mamba1's recurrence is a Python loop over a chunk's tokens; under autograd
each chunk is recomputed in the backward pass (``torch.utils.checkpoint``,
the reference's ``jax.checkpoint``), so refinement holds one chunk's
intermediates at a time.  States: ``h`` fp32, ``conv`` the activation
dtype.

Shapes: x (B, L, d).  Decode carries {"h", "conv"} per layer.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L


def _softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _pad_len(t, pad: int):
    """Zero-pad axis 1 (the sequence) of ``t`` by ``pad`` at the end."""
    if not pad:
        return t
    shape = list(t.shape)
    shape[1] = pad
    return torch.cat([t, t.new_zeros(shape)], dim=1)


def _chunks(fn, carry, xs, n: int, chunk: int):
    """Run ``fn(carry, *xs_c) -> (carry, y_c)`` over ``n`` chunks of axis 1
    of every tensor in ``xs``; each chunk recomputed in the backward pass
    when autograd records.  Returns (carry, [y_c])."""
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (carry,) + tuple(xs))
    ys = []
    for c in range(n):
        xs_c = tuple(t[:, c * chunk:(c + 1) * chunk] for t in xs)
        if grad:
            carry, y = checkpoint(fn, carry, *xs_c, use_reentrant=False)
        else:
            carry, y = fn(carry, *xs_c)
        ys.append(y)
    return carry, ys


# ---------------------------------------------------------------------------
# shared: causal depthwise conv


def causal_conv(x, w, b):
    """x: (B, L, C); w: (C, W); left-padded causal depthwise conv + silu,
    the ``W`` shifted products summed in order."""
    wdt = w.to(x.dtype)
    width = w.shape[1]
    pads = torch.cat([x.new_zeros((x.shape[0], width - 1, x.shape[2])), x],
                     dim=1)
    l = x.shape[1]
    out = sum(pads[:, i:i + l] * wdt[:, i] for i in range(width))
    return F.silu(out + b.to(x.dtype))


def causal_conv_step(x_t, conv_state, w, b):
    """x_t: (B, C); conv_state: (B, W-1, C) past inputs.  Returns (y_t,
    new_state)."""
    wdt = w.to(x_t.dtype)
    window = torch.cat([conv_state.to(x_t.dtype), x_t[:, None]], dim=1)
    y = torch.einsum("bwc,cw->bc", window, wdt) + b.to(x_t.dtype)
    return F.silu(y), window[:, 1:]


def _tail_conv_state(pre_conv, width: int):
    """Last (width-1) pre-conv inputs, left-padded when L < width-1."""
    b, l, c = pre_conv.shape
    w = width - 1
    if l >= w:
        return pre_conv[:, l - w:]
    return torch.cat([pre_conv.new_zeros((b, w - l, c)), pre_conv], dim=1)


# ---------------------------------------------------------------------------
# Mamba1


def mamba1_init(gen: torch.Generator, cfg, *, lead=(), dtype=torch.float32,
                device="cpu"):
    """The reference's layout and distributions; ``lead`` prepends stacked
    layer axes."""
    d, s = cfg.d_model, cfg.ssm
    di = s.expand * d
    kw = dict(lead=lead, dtype=dtype, device=device)
    a_init = torch.arange(1, s.state_dim + 1, dtype=torch.float32,
                          device=device).expand(*lead, di, s.state_dim)
    return {
        "in_proj": L.linear_init(gen, d, 2 * di, **kw),
        "conv_w": (torch.randn(*lead, di, s.conv_width, generator=gen,
                               device=device)
                   / math.sqrt(s.conv_width)).to(dtype),
        "conv_b": torch.zeros(*lead, di, dtype=dtype, device=device),
        "x_proj": L.linear_init(gen, di, s.dt_rank + 2 * s.state_dim, **kw),
        "dt_proj": L.linear_init(gen, s.dt_rank, di, **kw,
                                 scale=s.dt_rank ** -0.5),
        "dt_bias": torch.full((*lead, di), -4.6, dtype=dtype, device=device),
        "A_log": torch.log(a_init).to(dtype).contiguous(),
        "D": torch.ones(*lead, di, dtype=dtype, device=device),
        "out_proj": L.linear_init(gen, di, d, **kw,
                                  scale=1.0 / math.sqrt(
                                      di * 2 * cfg.num_layers)),
    }


def _mamba1_inputs(p, x, cfg):
    s = cfg.ssm
    di = s.expand * cfg.d_model
    L.sow("in_proj_in", x)
    xz = L.linear(p["in_proj"], x)
    xp, z = xz[..., :di], xz[..., di:]
    xc = causal_conv(xp, p["conv_w"], p["conv_b"])
    L.sow("x_proj_in", xc)
    xdb = L.linear(p["x_proj"], xc)
    dt_low = xdb[..., :s.dt_rank]
    bs = xdb[..., s.dt_rank:s.dt_rank + s.state_dim]
    cs = xdb[..., s.dt_rank + s.state_dim:]
    L.sow("dt_proj_in", dt_low)
    dt = _softplus(L.linear(p["dt_proj"], dt_low).float()
                   + p["dt_bias"].float())
    return xp, xc, z, dt, bs.float(), cs.float()


def _mamba1_scan_chunk(a, h, xc, dt, bs, cs):
    """Sequential scan within one chunk, token by token.  h: (B, di, N)
    fp32; xc, dt: (B, c, di); bs, cs: (B, c, N)."""
    ys = []
    for t in range(xc.shape[1]):
        decay = torch.exp(dt[:, t, :, None] * a)                # (B, di, N)
        h = h * decay + (dt[:, t] * xc[:, t])[..., None] * bs[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, cs[:, t]))
    return h, torch.stack(ys, dim=1)                            # (B, c, di)


def mamba1_forward(p, x, cfg, *, return_state: bool = False):
    """x: (B, L, d) -> (B, L, d).  Chunked scan; with ``return_state`` also
    the state after the last token ({"h", "conv"})."""
    s = cfg.ssm
    b, l, d = x.shape
    xp, xc, z, dt, bs, cs = _mamba1_inputs(p, x, cfg)
    di = xc.shape[-1]
    a = -torch.exp(p["A_log"].float())

    chunk = min(s.chunk, l)
    n = -(-l // chunk)
    pad = n * chunk - l
    xs = tuple(_pad_len(t, pad) for t in (xc.float(), dt, bs, cs))
    h0 = torch.zeros((b, di, s.state_dim), dtype=torch.float32,
                     device=x.device)
    h_final, ys = _chunks(lambda h, *xs_c: _mamba1_scan_chunk(a, h, *xs_c),
                          h0, xs, n, chunk)
    y = torch.cat(ys, dim=1)[:, :l]
    y = y + p["D"].float() * xc.float()
    y = y.to(x.dtype) * F.silu(z)
    L.sow("out_proj_in", y)
    out = L.linear(p["out_proj"], y)
    if return_state:
        # padded steps carry dt = 0 (identity decay, zero input), so h_final
        # is exactly the state after the last real token
        return out, {"h": h_final, "conv": _tail_conv_state(xp, s.conv_width)}
    return out


def mamba1_init_state(p, cfg, batch: int, dtype=torch.float32, *,
                      device="cpu"):
    s = cfg.ssm
    di = s.expand * cfg.d_model
    return {
        "h": torch.zeros((batch, di, s.state_dim), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, s.conv_width - 1, di), dtype=dtype,
                            device=device),
    }


def mamba1_decode(p, x_t, state, cfg):
    """x_t: (B, 1, d) -> ((B, 1, d), the new state)."""
    s = cfg.ssm
    di = s.expand * cfg.d_model
    xz = L.linear(p["in_proj"], x_t[:, 0])
    xp, z = xz[..., :di], xz[..., di:]
    xc, conv = causal_conv_step(xp, state["conv"], p["conv_w"], p["conv_b"])
    xdb = L.linear(p["x_proj"], xc)
    dt_low = xdb[..., :s.dt_rank]
    b_t = xdb[..., s.dt_rank:s.dt_rank + s.state_dim].float()
    c_t = xdb[..., s.dt_rank + s.state_dim:].float()
    dt = _softplus(L.linear(p["dt_proj"], dt_low).float()
                   + p["dt_bias"].float())
    a = -torch.exp(p["A_log"].float())
    h = state["h"] * torch.exp(dt[..., None] * a) \
        + (dt * xc.float())[..., None] * b_t[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, c_t) + p["D"].float() * xc.float()
    y = y.to(x_t.dtype) * F.silu(z)
    out = L.linear(p["out_proj"], y)[:, None]
    return out, {"h": h, "conv": conv}


# ---------------------------------------------------------------------------
# Mamba2 (SSD)


def mamba2_init(gen: torch.Generator, cfg, *, lead=(), dtype=torch.float32,
                device="cpu"):
    d, s = cfg.d_model, cfg.ssm
    di = s.expand * d
    nh = di // s.head_dim
    conv_dim = di + 2 * s.state_dim
    kw = dict(lead=lead, dtype=dtype, device=device)
    return {
        "in_proj": L.linear_init(gen, d, 2 * di + 2 * s.state_dim + nh,
                                 **kw),
        "conv_w": (torch.randn(*lead, conv_dim, s.conv_width, generator=gen,
                               device=device)
                   / math.sqrt(s.conv_width)).to(dtype),
        "conv_b": torch.zeros(*lead, conv_dim, dtype=dtype, device=device),
        "A_log": torch.zeros(*lead, nh, dtype=dtype, device=device),
        "D": torch.ones(*lead, nh, dtype=dtype, device=device),
        "dt_bias": torch.full((*lead, nh), -4.6, dtype=dtype, device=device),
        "gate_norm": L.norm_init(di, lead=lead, device=device),
        "out_proj": L.linear_init(gen, di, d, **kw,
                                  scale=1.0 / math.sqrt(
                                      di * 2 * cfg.num_layers)),
    }


def _mamba2_inputs(p, x, cfg):
    s = cfg.ssm
    di = s.expand * cfg.d_model
    nh = di // s.head_dim
    L.sow("in_proj_in", x)
    proj = L.linear(p["in_proj"], x)
    z = proj[..., :di]
    xbc = proj[..., di:di + di + 2 * s.state_dim]
    dt_raw = proj[..., di + di + 2 * s.state_dim:]
    return z, xbc, dt_raw, di, nh


def _ssd_chunk_body(a, d_skip, s_state, x_c, b_c, c_c, dt_c):
    """One SSD chunk.  s_state: (B, nh, hp, N) fp32; x_c (B, c, nh, hp),
    b_c / c_c (B, c, N), dt_c (B, c, nh)."""
    da = dt_c * a                                              # (B, c, nh)
    cums = torch.cumsum(da, dim=1)
    # intra-chunk (attention-like): w[i,j] = (C_i·B_j)·exp(cums_i-cums_j)·dt_j
    cb = torch.einsum("bin,bjn->bij", c_c, b_c)                 # (B, c, c)
    ii = torch.arange(x_c.shape[1], device=x_c.device)
    keep = ii[:, None] >= ii[None, :]
    # a masked entry's exponent is -inf (its factor 0), not cums_i - cums_j
    # (> 0, which overflows once a chunk's decay passes ~88)
    dec = torch.exp((cums[:, :, None, :] - cums[:, None, :, :]).masked_fill(
        ~keep[None, :, :, None], float("-inf")))                # (B,c,c,nh)
    causal = keep.to(dec.dtype)
    w = cb[..., None] * dec * causal[None, :, :, None] * dt_c[:, None, :, :]
    y = torch.einsum("bijh,bjhp->bihp", w, x_c)
    # inter-chunk: contribution of the carried state
    y = y + torch.einsum("bin,bhpn->bihp", c_c, s_state) \
        * torch.exp(cums)[..., None]
    # state update
    decay_out = torch.exp(cums[:, -1:, :] - cums) * dt_c        # (B, c, nh)
    s_new = s_state * torch.exp(cums[:, -1])[:, :, None, None] \
        + torch.einsum("bjn,bjh,bjhp->bhpn", b_c, decay_out, x_c)
    y = y + d_skip[None, None, :, None] * x_c
    return s_new, y


def mamba2_forward(p, x, cfg, *, return_state: bool = False):
    """x: (B, L, d) -> (B, L, d) via the SSD chunked matmul decomposition;
    with ``return_state`` also the state after the last token."""
    s = cfg.ssm
    b, l, d = x.shape
    z, xbc_raw, dt_raw, di, nh = _mamba2_inputs(p, x, cfg)
    xbc = causal_conv(xbc_raw, p["conv_w"], p["conv_b"])
    xx = xbc[..., :di].float()
    bs = xbc[..., di:di + s.state_dim].float()
    cs = xbc[..., di + s.state_dim:].float()
    dt = _softplus(dt_raw.float() + p["dt_bias"].float())       # (B, L, nh)
    a = -torch.exp(p["A_log"].float())                          # (nh,)
    d_skip = p["D"].float()
    hp = s.head_dim

    chunk = min(s.chunk, l)
    n = -(-l // chunk)
    pad = n * chunk - l
    xx, bs, cs, dt = (_pad_len(t, pad) for t in (xx, bs, cs, dt))
    xh = xx.reshape(b, n * chunk, nh, hp)
    s0 = torch.zeros((b, nh, hp, s.state_dim), dtype=torch.float32,
                     device=x.device)
    s_final, ys = _chunks(
        lambda st, *xs_c: _ssd_chunk_body(a, d_skip, st, *xs_c),
        s0, (xh, bs, cs, dt), n, chunk)
    y = torch.cat(ys, dim=1).reshape(b, n * chunk, di)[:, :l]

    y = y.to(x.dtype) * F.silu(z)
    y = L.apply_norm(p["gate_norm"], y, eps=cfg.norm_eps)
    L.sow("out_proj_in", y)
    out = L.linear(p["out_proj"], y)
    if return_state:
        # padded steps carry dt = 0 -> identity state updates; state exact
        return out, {"h": s_final,
                     "conv": _tail_conv_state(xbc_raw, s.conv_width)}
    return out


def mamba2_init_state(p, cfg, batch: int, dtype=torch.float32, *,
                      device="cpu"):
    s = cfg.ssm
    di = s.expand * cfg.d_model
    nh = di // s.head_dim
    return {
        "h": torch.zeros((batch, nh, s.head_dim, s.state_dim),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, s.conv_width - 1, di + 2 * s.state_dim),
                            dtype=dtype, device=device),
    }


def mamba2_decode(p, x_t, state, cfg):
    """x_t: (B, 1, d) -> ((B, 1, d), the new state)."""
    s = cfg.ssm
    z, xbc, dt_raw, di, nh = _mamba2_inputs(p, x_t[:, 0:1], cfg)
    z, xbc, dt_raw = z[:, 0], xbc[:, 0], dt_raw[:, 0]
    xbc, conv = causal_conv_step(xbc, state["conv"], p["conv_w"],
                                 p["conv_b"])
    xx = xbc[..., :di].float()
    b_t = xbc[..., di:di + s.state_dim].float()
    c_t = xbc[..., di + s.state_dim:].float()
    dt = _softplus(dt_raw.float() + p["dt_bias"].float())       # (B, nh)
    a = -torch.exp(p["A_log"].float())
    xh = xx.reshape(-1, nh, s.head_dim)
    h = state["h"] * torch.exp(dt * a)[..., None, None] \
        + (dt[..., None] * xh)[..., None] * b_t[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", h, c_t) \
        + p["D"].float()[None, :, None] * xh
    y = y.reshape(-1, di).to(x_t.dtype) * F.silu(z)
    y = L.apply_norm(p["gate_norm"], y, eps=cfg.norm_eps)
    out = L.linear(p["out_proj"], y)[:, None]
    return out, {"h": h, "conv": conv}
