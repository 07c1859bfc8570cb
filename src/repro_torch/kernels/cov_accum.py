"""Launcher of the CUDA covariance-triple kernel (``csrc/cov_accum.cu``).

Replaces the Pallas TPU kernel ``src/repro/kernels/cov_accum.py::cov_accum``:
one pass over (T, n) token rows X, X' gives XᵀX, XᵀX', X'ᵀX' in fp32, each
staged tile feeding all three products.  Each CUDA block owns one
(BI x BI) tile of the three outputs and loops over T itself.  When there are
too few output tiles to fill the card, T is split across blocks and the
partials meet in the outputs through ``atomicAdd``: the summation order then
varies from run to run, so two runs agree to fp32 tolerance, not bitwise.

Bound on the card: max((2·T·n² + 2·T·n·(n+1)) flops / peak,
(2·T·n·eb + 3·n²·4) bytes / bandwidth) — xxp plus the distinct halves of the
symmetric xx and xpxp; arithmetic at every main-path shape.  The kernel
computes both halves (6·T·n² flops), so its best is 1.5x the bound.  bf16 inputs (the main
path's activations) run on the tensor cores through WMMA, fp32 inputs on
the FMA units (TF32 stays off).  See the source for the design notes.
Callers go through ``kernels.ops.cov_accum``, which pads and checks; this
module only plans the grid and launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

BI = 64            # output tile edge; n must be a multiple
BT = 32            # token rows per step; T must be a multiple
TARGET_BLOCKS = 2 * 132   # two blocks per SM of an H100
MIN_STEPS_PER_SPLIT = 4   # never split below 4 token steps (128 rows) a block

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def plan_splits(t_rows: int, n: int):
    """(splits, rows_per_split) for a (t_rows, n) problem: split T only when
    the (n/BI)² output tiles leave the card under-filled."""
    tiles = (n // BI) ** 2
    steps = t_rows // BT
    if tiles >= TARGET_BLOCKS or steps <= MIN_STEPS_PER_SPLIT:
        return 1, t_rows
    splits = min(-(-TARGET_BLOCKS // tiles), steps // MIN_STEPS_PER_SPLIT)
    per = -(-steps // max(splits, 1))
    return -(-steps // per), per * BT


def launch(x, xp, xx, xxp, xpxp, *, accumulate: bool) -> None:
    """Run the kernel on padded, checked (T, n) inputs into (n, n) fp32
    outputs: ``accumulate`` adds into them in place, else they are
    overwritten."""
    t_rows, n = x.shape
    splits, rows = plan_splits(t_rows, n)
    if splits > 1:
        mode = 2
        if not accumulate:
            for o in (xx, xxp, xpxp):
                o.zero_()
    else:
        mode = 1 if accumulate else 0
    lib = build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.cov_accum_launch(
        x.data_ptr(), xp.data_ptr(), xx.data_ptr(), xxp.data_ptr(),
        xpxp.data_ptr(), t_rows, n, splits, rows, mode, DTYPES[x.dtype],
        stream)
    build.check(rc, "cov_accum")
