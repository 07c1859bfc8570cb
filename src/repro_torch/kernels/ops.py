"""Dispatch wrappers around the hand-written kernels.

Counterpart of ``src/repro/kernels/ops.py``.  Each wrapper:

* takes the plain PyTorch version (``kernels.ref``) for tensors on the CPU —
  and only there;
* for CUDA tensors checks device, dtype, shape and contiguity, zero-pads to
  the kernel's multiples (exact: zero rows / columns add nothing), launches
  the kernel, slices back, and raises on anything the kernel does not take.
  There is no fallback from a CUDA tensor to the plain version;
* counts its launches in ``LAUNCHES`` (one per wrapper call that launched
  its kernel, nowhere else), so a run can show that its path went through
  the kernels.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from repro_torch.kernels import cov_accum as _cov
from repro_torch.kernels import lowrank_matmul as _lowrank
from repro_torch.kernels import ref

LAUNCHES: Dict[str, int] = {"cov_accum": 0, "lowrank_matmul": 0}

KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def pad_dim(x: torch.Tensor, axis: int, multiple: int) -> torch.Tensor:
    """Zero-pad ``axis`` of ``x`` up to a multiple of ``multiple``."""
    pad = (-x.shape[axis]) % multiple
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """The kernels load 16 bytes at a time: a contiguous view that starts
    off a 16-byte boundary is copied to a fresh allocation."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _check_cuda(name: str, tensors: Sequence[Optional[torch.Tensor]],
                dtype: torch.dtype) -> None:
    device = tensors[0].device
    if device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {device}")
    if dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name}: kernel takes float32 or bfloat16, "
                        f"got {dtype}")
    for t in tensors:
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name}: operands on {t.device} and {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: mixed dtypes {t.dtype} and {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operand of shape {tuple(t.shape)} "
                             "is not contiguous")


# ---------------------------------------------------------------------------
# covariance triple


def cov_accum(x, xp, *, acc=None):
    """(T, n) x2 -> (xx, xxp, xpxp) fp32 (leading axes flatten into T).

    ``acc`` is an existing fp32 (xx, xxp, xpxp) triple to accumulate into.
    The wrapper owns that update and does it IN PLACE — the caller's
    tensors are modified and returned — which on the card lets the kernel
    add straight into them and saves a fresh 3·n²·4-byte triple per call
    (when n is not a multiple of the tile the kernel writes a padded triple
    and the slice is added in)."""
    n = x.shape[-1]
    x = x.reshape(-1, n)
    xp = xp.reshape(-1, n)
    if x.shape != xp.shape:
        raise ValueError(f"cov_accum: shapes {tuple(x.shape)} and "
                         f"{tuple(xp.shape)} differ")
    if x.device.type == "cpu" and xp.device.type == "cpu":
        outs = ref.cov_accum_ref(x, xp)
        if acc is None:
            return outs
        for a, o in zip(acc, outs):
            a.add_(o)
        return acc
    _check_cuda("cov_accum", [x, xp], x.dtype)
    if acc is not None:
        for a in acc:
            if (a.device != x.device or a.dtype != torch.float32
                    or tuple(a.shape) != (n, n) or not a.is_contiguous()):
                raise ValueError("cov_accum: acc= must be contiguous (n, n) "
                                 f"float32 on {x.device}")
    xk = _aligned(pad_dim(pad_dim(x, 0, _cov.BT), 1, _cov.BI))
    xpk = _aligned(pad_dim(pad_dim(xp, 0, _cov.BT), 1, _cov.BI))
    npad = xk.shape[1]
    if acc is not None and npad == n:
        _cov.launch(xk, xpk, *acc, accumulate=True)
        LAUNCHES["cov_accum"] += 1
        return acc
    outs = tuple(torch.empty((npad, npad), dtype=torch.float32,
                             device=x.device) for _ in range(3))
    _cov.launch(xk, xpk, *outs, accumulate=False)
    LAUNCHES["cov_accum"] += 1
    if npad != n:
        outs = tuple(o[:n, :n].contiguous() for o in outs)
    if acc is None:
        return outs
    for a, o in zip(acc, outs):
        a.add_(o)
    return acc


# ---------------------------------------------------------------------------
# factorized linear


def _lowrank_kernel(x, v, u, bias, residual):
    """Padded launch on 2D operands; returns (y (T, m), t (T, k))."""
    _check_cuda("lowrank_matmul", [x, v, u, bias, residual], x.dtype)
    t0, n = x.shape
    k, m = u.shape
    if v.shape != (n, k):
        raise ValueError(f"lowrank_matmul: v {tuple(v.shape)} does not match "
                         f"x {tuple(x.shape)} and u {tuple(u.shape)}")
    rows, depth = _lowrank.MULTIPLES[x.dtype]
    xk = _aligned(pad_dim(pad_dim(x, 0, rows), 1, depth))
    vk = _aligned(pad_dim(pad_dim(v, 0, depth), 1, rows))
    uk = _aligned(pad_dim(pad_dim(u, 0, rows), 1, rows))
    bk = None
    if bias is not None:
        bk = _aligned(pad_dim(bias.reshape(-1), 0, rows))
    rk = None
    if residual is not None:
        rk = _aligned(pad_dim(pad_dim(residual, 0, rows), 1, rows))
    t = torch.empty((xk.shape[0], uk.shape[0]), dtype=x.dtype,
                    device=x.device)
    y = torch.empty((xk.shape[0], uk.shape[1]), dtype=x.dtype,
                    device=x.device)
    _lowrank.launch(xk, vk, uk, t, y, bk, rk)
    LAUNCHES["lowrank_matmul"] += 1
    return y[:t0, :m].contiguous(), t[:t0, :k]


class _LowRankMatmul(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the plain version (CPU).  Backward: the
    plain products with ``torch.matmul`` — the TPU kernel has no backward
    and the JAX package differentiates this product in XLA."""

    @staticmethod
    def forward(ctx, x, v, u, bias, residual):
        if x.device.type == "cpu":
            y = ref.lowrank_matmul_ref(x, v, u)
            if bias is not None:
                y = y + bias.reshape(-1)
            if residual is not None:
                y = y + residual
            t = None
        else:
            y, t = _lowrank_kernel(x, v, u, bias, residual)
        ctx.save_for_backward(x, v, u, t)
        ctx.bias_shape = None if bias is None else bias.shape
        return y

    @staticmethod
    def backward(ctx, dy):
        x, v, u, t = ctx.saved_tensors
        if t is None:
            t = torch.matmul(x.float(), v.float()).to(u.dtype)
        dt = torch.matmul(dy.to(u.dtype), u.T)
        need = ctx.needs_input_grad
        dx = torch.matmul(dt.to(v.dtype), v.T).to(x.dtype) if need[0] else None
        dv = torch.matmul(x.T.to(dt.dtype), dt).to(v.dtype) if need[1] else None
        du = torch.matmul(t.T, dy.to(t.dtype)).to(u.dtype) if need[2] else None
        db = None
        if ctx.bias_shape is not None and need[3]:
            db = dy.sum(0).reshape(ctx.bias_shape)
        dr = dy if need[4] else None
        return dx, dv, du, db, dr


def lowrank_matmul(x, v, u, *, bias=None, residual=None):
    """y = (x @ v) @ u (+ bias + residual).  x: (..., n); v: (n, k);
    u: (k, m); bias: (m,) or (1, m); residual: (..., m).  Differentiable.

    On the card the bias and residual adds run in fp32 inside the kernel's
    epilogue; the plain version adds them after the cast to x's dtype, as
    the JAX wrapper's reference branch does (identical in fp32)."""
    lead = x.shape[:-1]
    xf = x.reshape(-1, x.shape[-1])
    rf = None if residual is None else residual.reshape(-1, u.shape[-1])
    y = _LowRankMatmul.apply(xf, v, u, bias, rf)
    return y.reshape(*lead, u.shape[-1])
