"""Shared primitives: norms, RoPE, linear (dense or factorized), CE, taps.

Counterpart of ``src/repro/models/layers.py``.  Params are plain nested
dicts of tensors with the JAX package's layout.  A "linear" param dict holds
either

  {"w": (in, out)}                      dense
  {"u": (k, out), "v": (in, k)}         AA-SVD factorized, y = (x @ v) @ u

optionally plus {"b": (out,)}.  The factorized product goes through the
hand-written ``lowrank_matmul`` kernel (``kernels.ops``) on the card.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

# ---------------------------------------------------------------------------
# activation taps ("sow"): calibration capture for AA-SVD.
#
# Forward functions call ``sow(name, x)`` at every linear-layer input.  When a
# ``sowing(store)`` context is active the activation is recorded under
# "<scope>/<name>".  No cost when no store is active.

_SOW_STORE: Optional[Dict[str, torch.Tensor]] = None
_SCOPE: list = []


@contextlib.contextmanager
def sowing(store: Dict[str, torch.Tensor]):
    global _SOW_STORE
    prev = _SOW_STORE
    _SOW_STORE = store
    try:
        yield store
    finally:
        _SOW_STORE = prev


@contextlib.contextmanager
def scope(name: str):
    _SCOPE.append(name)
    try:
        yield
    finally:
        _SCOPE.pop()


def sow(name: str, x) -> None:
    if _SOW_STORE is not None:
        _SOW_STORE["/".join(_SCOPE + [name])] = x


def tapping() -> bool:
    """Whether a ``sowing`` store is active: callers skip building a tap
    that only calibration reads (where JAX's tracer would drop it)."""
    return _SOW_STORE is not None


# ---------------------------------------------------------------------------
# linear


def linear_init(gen: torch.Generator, d_in: int, d_out: int, *,
                lead=(), dtype=torch.float32, device="cpu",
                scale: Optional[float] = None):
    """Normal(0, 1)·scale weights (scale 1/sqrt(d_in) by default); ``lead``
    prepends stacked-layer axes."""
    scale = (1.0 / math.sqrt(d_in)) if scale is None else scale
    w = torch.randn(*lead, d_in, d_out, generator=gen, device=device) * scale
    return {"w": w.to(dtype)}


def linear(p, x, *, dtype=None):
    """y = x @ W (+ b); W dense or factorized (u, v).  The factors are cast
    to the compute dtype first, as the JAX package does, so the kernel
    receives exactly what the reference would multiply."""
    if dtype is None:
        dtype = x.dtype
    if "w" in p:
        y = x @ p["w"].to(dtype)
    else:
        y = ops.lowrank_matmul(x.contiguous(), p["v"].to(dtype).contiguous(),
                               p["u"].to(dtype).contiguous())
    if "b" in p:
        y = y + p["b"].to(dtype)
    return y


# ---------------------------------------------------------------------------
# norms


def norm_init(d: int, kind: str = "rmsnorm", *, lead=(),
              dtype=torch.float32, device="cpu"):
    p = {"scale": torch.ones(*lead, d, dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros(*lead, d, dtype=dtype, device=device)
    return p


def apply_norm(p, x, *, eps: float = 1e-6):
    """RMSNorm (or LayerNorm when ``p`` has a bias), computed in fp32 and
    cast back to x's dtype."""
    xf = x.float()
    if "bias" in p:
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings


def rope_table(positions, head_dim: int, theta: float):
    """fp32 cos/sin tables for integer positions -> (L, head_dim//2) each."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    # a Python base: no host-to-device copy (which synchronizes)
    freqs = torch.pow(float(theta), exps)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x, cos, sin):
    """x: (..., L, H, D); cos/sin: (L, D//2) — rotate-half convention."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# activations


def act(name: str, x):
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        return F.gelu(x, approximate="tanh")   # jax.nn.gelu's default
    raise ValueError(name)


# ---------------------------------------------------------------------------
# cross-entropy, chunked over the sequence


def chunked_cross_entropy(hidden, head_p, targets, *, chunk: int = 512):
    """Mean next-token CE (fp32), computed ``chunk`` positions at a time so
    the (B, chunk, V) fp32 logits stay bounded.

    The JAX version zero-pads the vocabulary to a multiple of 512 for TPU
    sharding and masks the pad columns before the logsumexp; that equals
    this unpadded form exactly."""
    b, l, _ = hidden.shape
    chunk = min(chunk, l)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for s in range(0, l, chunk):
        logits = linear(head_p, hidden[:, s:s + chunk].float(),
                        dtype=torch.float32)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            targets[:, s:s + chunk, None].long())[..., 0]
        total = total + torch.sum(logz - gold)
    return total / (b * l)


# ---------------------------------------------------------------------------
# embedding


def embedding_init(gen: torch.Generator, vocab: int, d: int, *,
                   dtype=torch.float32, device="cpu"):
    table = torch.randn(vocab, d, generator=gen, device=device) * 0.02
    return {"table": table.to(dtype)}


def embed(p, tokens, dtype):
    return p["table"].to(dtype)[tokens.long()]
