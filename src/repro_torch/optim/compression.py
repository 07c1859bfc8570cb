"""int8 block quantization of gradients with error feedback.

Counterpart of ``src/repro/optim/compression.py`` (:29-77): each leaf is
quantized to int8 with one fp32 scale per block of 128 elements (max |x| /
127, floored at 1e-12), rounded half to even (``torch.round`` and
``jnp.round`` agree), and the quantization residual is carried into the
next step.  It is meant to shrink the data-parallel all-reduce; on one
card there is none, so the trainer accepts the flag and leaves it unwired,
as the JAX package's does.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.tree import flatten, tree_leaves, tree_map, unflatten

BLOCK = 128


def _pad_to_block(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    flat = x.reshape(-1)
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.reshape(-1, BLOCK), pad


def quantize(g: torch.Tensor, err: torch.Tensor):
    """Returns (q int8 blocks, scales fp32 (blocks, 1), new_err); ``err``
    has g's shape."""
    target = g.float() + err
    blocks, _ = _pad_to_block(target)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    deq = (q.float() * scale).reshape(-1)[: g.numel()].reshape(g.shape)
    return q, scale, target - deq


def dequantize(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    deq = (q.float() * scale).reshape(-1)
    return deq[: int(torch.Size(shape).numel())].reshape(shape)


def apply_error_feedback(grads, err_state):
    """Quantize and dequantize every leaf with error feedback: returns
    (grads_hat in each leaf's dtype, new_err_state); ``err_state`` None
    starts from zeros."""
    if err_state is None:
        err_state = tree_map(lambda g: torch.zeros(
            g.shape, dtype=torch.float32, device=g.device), grads)

    def one(g, e):
        q, s, new_e = quantize(g, e)
        return dequantize(q, s, g.shape).to(g.dtype), new_e

    leaves, treedef = flatten(grads)
    outs = [one(g, e) for g, e in zip(leaves, tree_leaves(err_state))]
    return (unflatten(treedef, [o[0] for o in outs]),
            unflatten(treedef, [o[1] for o in outs]))


def compressed_ratio() -> float:
    """Bytes of int8 payload + fp32 scales over fp32 (the roofline's
    adjustment)."""
    return (1.0 + 4.0 / BLOCK) / 4.0
