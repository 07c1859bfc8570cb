"""Launcher of the CUDA flash-attention kernel (``csrc/flash_attention.cu``).

Replaces the Pallas TPU kernel
``src/repro/kernels/flash_attention.py::flash_attention`` and computes what
the JAX model path's ``models/attention.py:31`` computes: blockwise
online-softmax attention with causal, sliding-window and key-padding masks,
an optional soft cap, a scalar or per-slot query offset, and GQA through
the head map.  One block per (batch·head, 64 query rows) walks 64-key tiles
of its KV head in shared memory; bf16 products run on the tensor cores
through WMMA, fp32 ones on the FMA units.

Bound on the card: max(4·B·H·Lq·Lk_live·D flops / peak, (q + k + v + o)
bytes / bandwidth) — operations for prefill, bytes for one-token decode.
Callers go through ``kernels.ops.flash_attention``, which checks, pads the
head dim and owns the autograd rule; this module only launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# head dims the kernel is compiled for; the wrapper zero-pads up to one
# (192: MLA prefill, qk_nope 128 + qk_rope 64)
HEAD_DIMS = (16, 32, 64, 128, 192)


def launch(q, k, v, o, q_off, q_off0: int, *, causal: bool, window: int,
           scale: float, softcap: float) -> None:
    """q, o (B, Lq, H, D); k, v (B, Lk, KV, D), checked and padded;
    ``q_off`` a (B,) int32 tensor or None (every slot at ``q_off0``)."""
    b, lq, h, d = q.shape
    lk, kv = k.shape[1], k.shape[2]
    lib = build.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if q_off is None else q_off.data_ptr(), int(q_off0),
        b, lq, lk, h, kv, d, int(causal), int(window), float(scale),
        float(softcap), DTYPES[q.dtype], stream)
    build.check(rc, "flash_attention")
