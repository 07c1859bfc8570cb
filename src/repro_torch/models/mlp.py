"""Feed-forward layers: gated silu / plain gelu MLP and mixture-of-experts.

Counterpart of ``src/repro/models/mlp.py``: ``ffn_init`` / ``ffn_apply``
(:39, :52), ``moe_init`` (:67), ``moe_apply`` (:91) with the capacity
dispatch (:162-196, ``bank_apply`` :274) and the drop-free dispatch
``_dispatch_dropfree`` (:210, ``grouped_bank_apply`` :262).

Capacity dispatch (Switch): each expert takes at most C = max(⌈T·k/E ·
capacity_factor⌉, k) of the (T, k) routed choices, in choice-major order
(a one-hot cumsum gives each choice its slot); later choices drop and
contribute zero.  Kept choices are copied into an (E, C, d) buffer (each
slot has one source row; dropped choices go to a spare row past E·C),
the three expert GEMMs run batched over E (``torch.einsum``: plain
products, as the JAX package leaves them to XLA), and each token's k
gate-weighted choices are gathered back and summed in fp32 in choice
order, choice 0 first from zeros: no atomics, so two runs give the same
bits.  C comes from the shapes and nothing of the routing is read on the
host.

Drop-free dispatch: the (T, k) routed choices are laid out choice-major as
(k·T, d) rows, stably sorted by expert id into contiguous segments, run
through the grouped expert GEMM (``kernels.ops.grouped_matmul``, the
hand-written kernel on the card), unsorted, and summed per token in fixed
choice order in fp32.  No token is dropped and every output row is a
per-row function of (token, expert weights), so the layer is
batch-size invariant.  Nothing of the routing is read on the host.

Not ported: the mesh / expert-parallel branches (:125-141, with
``torch.distributed``).
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops
from repro_torch.models import layers as L


def ffn_init(gen: torch.Generator, d: int, d_ff: int, act_fn: str,
             num_layers: int, *, lead=(), dtype=torch.float32, device="cpu"):
    kw = dict(lead=lead, dtype=dtype, device=device)
    p = {}
    if act_fn == "silu":
        p["gate"] = L.linear_init(gen, d, d_ff, **kw)
    p["up"] = L.linear_init(gen, d, d_ff, **kw)
    p["down"] = L.linear_init(gen, d_ff, d, **kw,
                              scale=1.0 / math.sqrt(d_ff * 2 * num_layers))
    return p


def ffn_apply(p, x, act_fn: str):
    L.sow("in", x)
    up = L.linear(p["up"], x)
    if "gate" in p:
        up = L.act(act_fn, L.linear(p["gate"], x)) * up
    else:
        up = L.act(act_fn, up)
    L.sow("down_in", up)
    return L.linear(p["down"], up)


# ---------------------------------------------------------------------------
# mixture of experts


def moe_init(gen: torch.Generator, cfg, *, lead=(), dtype=torch.float32,
             device="cpu"):
    """Router (fp32), an expert bank {gate, up, down} stacked on an expert
    axis ((E, d, d_ff) / (E, d_ff, d) after ``lead``), and the shared
    experts as one dense FFN of width d_ff · num_shared_experts."""
    d, m = cfg.d_model, cfg.moe
    scale_in = 1.0 / math.sqrt(d)
    scale_out = 1.0 / math.sqrt(m.d_ff * 2 * cfg.num_layers)

    def bank(shape, scale):
        w = torch.randn(*lead, *shape, generator=gen, device=device) * scale
        return {"w": w.to(dtype)}

    e = m.num_experts
    p = {
        "router": L.linear_init(gen, d, e, lead=lead, dtype=torch.float32,
                                device=device),
        "experts": {"gate": bank((e, d, m.d_ff), scale_in),
                    "up": bank((e, d, m.d_ff), scale_in),
                    "down": bank((e, m.d_ff, d), scale_out)},
    }
    if m.num_shared_experts:
        p["shared"] = ffn_init(gen, d, m.d_ff * m.num_shared_experts,
                               cfg.act_fn, cfg.num_layers, lead=lead,
                               dtype=dtype, device=device)
    return p


def moe_apply(p, x, cfg, *, capacity_factor=None, dispatch=None):
    """x: (B, L, d) -> ((B, L, d), aux load-balance loss, fp32 scalar).

    Router in fp32: softmax, top-k, gates renormalized over the k choices;
    the Switch aux loss E · Σ_e f_e · p_e times ``aux_loss_coef``.
    ``dispatch`` and ``capacity_factor`` override ``cfg.moe``'s per call."""
    m = cfg.moe
    if dispatch is None:
        dispatch = m.dispatch
    if dispatch not in ("capacity", "dropfree"):
        raise ValueError(f"unknown moe dispatch {dispatch!r} "
                         "(capacity | dropfree)")
    if capacity_factor is None:
        capacity_factor = m.capacity_factor
    b, l, d = x.shape
    t = b * l
    e, k = m.num_experts, m.top_k

    xt = x.reshape(t, d)
    logits = L.linear(p["router"], xt.float(), dtype=torch.float32)
    probs = torch.softmax(logits, dim=-1)                         # (T, E)
    gate_vals, expert_ids = torch.topk(probs, k, dim=-1)          # (T, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    # aux loss (Switch): E * sum_e f_e * p_e
    me = probs.mean(0)
    ce = torch.nn.functional.one_hot(expert_ids, e).float().sum(1).mean(0)
    aux = m.aux_loss_coef * e * torch.sum(me * ce)

    if dispatch == "dropfree":
        y = _dispatch_dropfree(p["experts"], xt, gate_vals, expert_ids, cfg)
    else:
        y = _dispatch_capacity(p["experts"], xt, gate_vals, expert_ids, cfg,
                               capacity_factor)
    y = y.to(x.dtype)
    if "shared" in p:
        with L.scope("shared"):
            y = y + ffn_apply(p["shared"], xt, cfg.act_fn)
    return y.reshape(b, l, d), aux


def _dispatch_capacity(w, xt, gate_vals, expert_ids, cfg, capacity_factor):
    """Capacity-routed expert compute for one flat token matrix; returns
    the combined (T, d) routed output in fp32.  Sows ``experts_dropped``
    ([dropped, total] routed choices) and the (E, C, n) buffers
    ``experts_in`` / ``experts_down_in`` that calibration reads."""
    t, d = xt.shape
    k = cfg.moe.top_k
    e = cfg.moe.num_experts
    cap = max(int(math.ceil(t * k / e * capacity_factor)), k)

    # slot of each choice within its expert, choice-major priority
    flat_ids = expert_ids.T.reshape(-1)                          # (kT,)
    onehot = torch.nn.functional.one_hot(flat_ids, e)            # (kT, E)
    slot = ((torch.cumsum(onehot, dim=0) - 1) * onehot).sum(1)
    keep = slot < cap
    # dropped choices land on the spare row e·cap, sliced away
    dest = torch.where(keep, flat_ids * cap + slot,
                       torch.full_like(slot, e * cap))
    gates_flat = gate_vals.T.reshape(-1) * keep.float()
    if L.tapping():
        L.sow("experts_dropped", torch.stack(
            [(1.0 - keep.float()).sum(),
             torch.full((), float(k * t), device=xt.device)]))

    rows = xt.repeat(k, 1)                                       # (kT, d)
    buf = xt.new_zeros((e * cap + 1, d)).index_copy(0, dest, rows)
    buf = buf[:e * cap].reshape(e, cap, d)
    L.sow("experts_in", buf)
    h = L.act(cfg.act_fn, bank_apply(w["gate"], buf)) \
        * bank_apply(w["up"], buf)
    L.sow("experts_down_in", h)
    y_buf = bank_apply(w["down"], h).reshape(e * cap, d)

    # gather-combine: the spare row reads zeros; k choices in order
    y_buf = torch.cat([y_buf, y_buf.new_zeros((1, d))])
    y_rows = y_buf.index_select(0, dest).float() * gates_flat[:, None]
    y = xt.new_zeros((t, d), dtype=torch.float32)
    for j in range(k):
        y = y + y_rows[j * t:(j + 1) * t]
    return y


def bank_apply(bp, x):
    """Batched expert GEMM.  x: (E, C, d_in); bank dense {"w": (E, d_in,
    d_out)} or factorized {"u": (E, k, d_out), "v": (E, d_in, k)}; the bank
    is cast to the buffer's dtype first, as the JAX package does."""
    if "w" in bp:
        return torch.einsum("ecd,edf->ecf", x, bp["w"].to(x.dtype))
    t = torch.einsum("ecd,edk->eck", x, bp["v"].to(x.dtype))
    return torch.einsum("eck,ekf->ecf", t, bp["u"].to(x.dtype))


def _dispatch_dropfree(w, xt, gate_vals, expert_ids, cfg):
    """Drop-free routed expert compute for one flat token matrix; returns
    the combined (T, d) routed output in fp32.

    Taps are sown in the ORIGINAL choice-major order together with the
    expert ids, so original- and shifted-stream rows pair per (token,
    choice) and calibration bins per-expert covariances by the original
    stream's ids.  The group sizes are counted with ``scatter_add_`` (CUDA's
    ``bincount`` reads the largest id on the host) and the inverse
    permutation with ``scatter_``: no host sync."""
    t, d = xt.shape
    k = cfg.moe.top_k
    e = cfg.moe.num_experts
    kt = k * t

    flat_ids = expert_ids.T.reshape(-1).to(torch.int32)          # choice-major
    rows = xt.repeat(k, 1)                                       # (kT, d)
    L.sow("experts_in", rows)
    L.sow("experts_ids", flat_ids)

    order = torch.sort(flat_ids, stable=True).indices            # (kT,)
    iota = torch.arange(kt, device=xt.device)
    inv = torch.empty_like(order).scatter_(0, order, iota)
    group_sizes = torch.zeros(e, dtype=torch.int32, device=xt.device)
    group_sizes.scatter_add_(0, flat_ids.long(),
                             torch.ones_like(flat_ids))

    xs = rows.index_select(0, order)                             # sorted
    h = L.act(cfg.act_fn, grouped_bank_apply(w["gate"], xs, group_sizes)) \
        * grouped_bank_apply(w["up"], xs, group_sizes)
    if L.tapping():
        L.sow("experts_down_in", h.index_select(0, inv))
    y_rows = grouped_bank_apply(w["down"], h, group_sizes)
    y_rows = y_rows.index_select(0, inv)                         # choice-major

    gates_flat = gate_vals.T.reshape(-1)
    return torch.sum((y_rows.float() * gates_flat[:, None]).reshape(k, t, d),
                     dim=0)


def grouped_bank_apply(bp, xs, group_sizes):
    """Grouped expert GEMM over segment-sorted rows.  xs: (R, d_in); bank
    dense {"w": (E, d_in, d_out)} or factorized {"u": (E, k, d_out),
    "v": (E, d_in, k)}; the bank is cast to the rows' dtype first, as the
    JAX package does."""
    if "w" in bp:
        return ops.grouped_matmul(xs, bp["w"].to(xs.dtype), group_sizes)
    t = ops.grouped_matmul(xs, bp["v"].to(xs.dtype), group_sizes)
    return ops.grouped_matmul(t, bp["u"].to(xs.dtype), group_sizes)
