"""Launcher of the CUDA factorized-linear kernel (``csrc/lowrank_matmul.cu``).

Replaces the Pallas TPU kernel
``src/repro/kernels/lowrank_matmul.py::lowrank_matmul``: y = (x @ V) @ U
(+ bias + residual) with fp32 accumulation.  The TPU kernel keeps the rank-k
intermediate in VMEM; this first Hopper version runs two launches of one
tiled GEMM from one C call — t = x @ V stored in U's dtype, then y = t @ U
with the bias/residual epilogue fused into the second launch — at the cost of
2·T·k·eb extra bytes.  Keeping t on chip is a later PR's redesign.

Bound on the card: max(2·T·k·(n + m) flops / peak, (T·n + n·k + k·m + T·m)·eb
bytes / bandwidth) — arithmetic at every main-path shape.  bf16 operands
(the main path's) run on the tensor cores through WMMA, fp32 operands on
the FMA units (TF32 stays off).  Callers go through
``kernels.ops.lowrank_matmul``, which pads, checks and owns the autograd
rule; this module only launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# (rows, depth) per dtype: T, k and m must be multiples of rows (the block
# tile edge), n of depth (the contraction step)
MULTIPLES = {torch.float32: (64, 16), torch.bfloat16: (128, 32)}


def launch(x, v, u, t, y, bias, residual) -> None:
    """Run both GEMMs on padded, checked operands; ``t`` is the (T, k)
    scratch for the intermediate, ``y`` the (T, m) output."""
    rows, n = x.shape
    k, m = u.shape
    lib = build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.lowrank_matmul_launch(
        x.data_ptr(), v.data_ptr(), u.data_ptr(), t.data_ptr(), y.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if residual is None else residual.data_ptr(),
        rows, n, k, m, DTYPES[x.dtype], stream)
    build.check(rc, "lowrank_matmul")
