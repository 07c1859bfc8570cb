"""Launcher of the CUDA grouped expert GEMM (``csrc/grouped_matmul.cu``).

Replaces the Pallas TPU kernel
``src/repro/kernels/grouped_matmul.py::grouped_matmul``: y[i] = x[i] @ W[g(i)]
over rows sorted by expert, with fp32 accumulation.  The TPU kernel walks a
scalar-prefetched list of (row block x expert) tiles; here every block owns
one (row tile x column tile) of y, finds the expert segments that overlap
its rows from the device-side segment offsets, and accumulates each
segment's masked rows against that expert's weights before one store.

Bound on the card: max(2·M·d·f flops / peak, (M·d + E·d·f + M·f)·eb bytes /
bandwidth).  bf16 operands (the main path's) run on the tensor cores
through WMMA, fp32 operands on the FMA units (TF32 stays off).  Callers go
through ``kernels.ops.grouped_matmul``, which pads, checks, builds the
offsets and owns the autograd rule; this module only launches.

Backward (the TPU kernel has none): dx runs this kernel again on Wᵀ made
contiguous; dW[e] = x_eᵀ dy_e is one plain ``torch.matmul`` per expert
segment, which reads the group sizes on the host — in backward only.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# d and f must be multiples of this (16-byte vectors of bf16); the wrapper
# zero-pads to it.  Rows need no padding: the kernel masks them.
MULTIPLE = 8
# row tile per dtype: the grid has ceil(M / rows) <= 65535 row tiles
ROW_TILE = {torch.float32: 64, torch.bfloat16: 128}


def launch(x, w, offs, y) -> None:
    """x (M, d), w (E, d, f), y (M, f), padded and checked; ``offs`` the
    (E + 1,) int32 segment offsets on the device."""
    m, d = x.shape
    e, _, f = w.shape
    lib = build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.grouped_matmul_launch(
        x.data_ptr(), w.data_ptr(), offs.data_ptr(), y.data_ptr(), m, d, f, e,
        DTYPES[x.dtype], stream)
    build.check(rc, "grouped_matmul")
