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

import collections
import contextlib
import math
from typing import Dict, Optional, Sequence

import torch

from repro_torch.kernels import cov_accum as _cov
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import grouped_matmul as _gm
from repro_torch.kernels import lowrank_matmul as _lowrank
from repro_torch.kernels import ref

LAUNCHES: Dict[str, int] = {"cov_accum": 0, "lowrank_matmul": 0,
                            "flash_attention": 0, "flash_decode": 0,
                            "grouped_matmul": 0}
# lowrank_matmul's launches by row count T (its plan's body depends on T)
LOWRANK_ROWS: Dict[int, int] = collections.Counter()

KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    LOWRANK_ROWS.clear()


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


def cov_accum_grouped(x, xp, ids, experts: int, *, acc=None):
    """Drop-free routed covariance triple: (R, n) choice-major rows x2 and
    (R,) expert ids of the ORIGINAL stream -> (xx, xxp, xpxp), each
    (E, n, n) fp32; ``acc`` an existing triple to add into IN PLACE.

    The rows are sorted by id (stable) and each expert's segment goes
    through ``cov_accum`` with ``acc=`` that expert's slices, so on the card
    the hand-written kernel adds straight into them; ids outside [0, E) are
    dropped, as the one-hot of the reference drops them.  The segment sizes
    are read on the host once per call — calibration only, never a model
    forward.  Not a kernel of its own: the JAX package computes it with
    XLA's ``segment_sum``, and ``LAUNCHES`` counts the ``cov_accum`` calls."""
    n = x.shape[-1]
    x = x.reshape(-1, n)
    xp = xp.reshape(-1, n)
    ids = ids.reshape(-1)
    if acc is None:
        acc = tuple(torch.zeros((experts, n, n), dtype=torch.float32,
                                device=x.device) for _ in range(3))
    order = torch.sort(ids, stable=True).indices
    ids_sorted = ids.index_select(0, order)
    bounds = torch.searchsorted(
        ids_sorted, torch.arange(experts + 1, dtype=ids_sorted.dtype,
                                 device=ids.device)).tolist()
    xs = x.index_select(0, order)
    xps = xp.index_select(0, order)
    for e in range(experts):
        lo, hi = bounds[e], bounds[e + 1]
        if hi > lo:
            cov_accum(xs[lo:hi], xps[lo:hi],
                      acc=(acc[0][e], acc[1][e], acc[2][e]))
    return acc


# ---------------------------------------------------------------------------
# factorized linear


# set by ``batch_invariant``: lowrank_matmul takes the large-T body at any T
_BATCH_INVARIANT = False


@contextlib.contextmanager
def batch_invariant():
    """Inside it ``lowrank_matmul`` runs its large-T body at every row count
    T, whose rows' results do not depend on T, so a prompt prefilled in
    chunks (a last chunk of any length) gives the bits of whole prefill.
    Outside it T <= ``SMALL_T_MAX`` (decode) takes the small-T body, which
    rounds t differently.  Prefill (``models.model.prefill``) runs in it."""
    global _BATCH_INVARIANT
    before, _BATCH_INVARIANT = _BATCH_INVARIANT, True
    try:
        yield
    finally:
        _BATCH_INVARIANT = before


def _lowrank_kernel(x, v, u, bias, residual, body=None):
    """Checked launch of the call's plan (``kernels.lowrank_matmul.plan``;
    ``body`` forces one, else ``batch_invariant`` may) on 2D operands;
    returns (y (T, m), t (T, k)).  T is never padded; n, k, m only to what
    the plan's body loads (zeros, exact)."""
    _check_cuda("lowrank_matmul", [x, v, u, bias, residual], x.dtype)
    t0, n = x.shape
    k, m = u.shape
    if v.shape != (n, k):
        raise ValueError(f"lowrank_matmul: v {tuple(v.shape)} does not match "
                         f"x {tuple(x.shape)} and u {tuple(u.shape)}")
    if t0 == 0:
        return x.new_zeros((0, m)), x.new_zeros((0, k))
    if body is None and _BATCH_INVARIANT:
        body = _lowrank.LARGE_T_BODY[x.dtype]
    p = _lowrank.plan(t0, n, k, m, x.dtype, body=body)
    an, ak, am = p.align
    xk = _aligned(pad_dim(x, 1, an))
    vk = _aligned(pad_dim(pad_dim(v, 0, an), 1, ak))
    uk = _aligned(pad_dim(pad_dim(u, 0, ak), 1, am))
    bk = None if bias is None else _aligned(pad_dim(bias.reshape(-1), 0, am))
    rk = None if residual is None else _aligned(pad_dim(residual, 1, am))
    t = torch.empty((t0, p.k), dtype=x.dtype, device=x.device)
    y = torch.empty((t0, p.m), dtype=x.dtype, device=x.device)
    scratch = (torch.empty(p.scratch_floats, dtype=torch.float32,
                           device=x.device) if p.scratch_floats else None)
    _lowrank.launch(p, xk, vk, uk, t, y, bk, rk, scratch)
    LAUNCHES["lowrank_matmul"] += 1
    LOWRANK_ROWS[t0] += 1
    return (y if p.m == m else y[:, :m].contiguous()), t[:, :k]


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


def lowrank_down(x, v):
    """t = x @ v, summed in fp32 and rounded once to x's dtype: the first
    product of ``lowrank_matmul`` alone.  x: (..., n); v: (n, k).  On the
    card it runs the kernel's plan with no second product, so its rows'
    bits follow the plan's body (``batch_invariant`` holds for it too); on
    the CPU it is ``x @ v``.  No autograd: the serving paths' latents."""
    lead = x.shape[:-1]
    xf = x.reshape(-1, x.shape[-1])
    if xf.device.type == "cpu":
        t = xf @ v
    else:
        t = _lowrank_kernel(xf, v, v.new_empty((v.shape[1], 0)), None,
                            None)[1]
    return t.reshape(*lead, v.shape[1])


# ---------------------------------------------------------------------------
# flash attention


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _padded_head_dim(d: int) -> int:
    """The smallest head dim ``flash_attention`` is compiled for that holds
    ``d``."""
    for dp in _fa.HEAD_DIMS:
        if dp >= d:
            return dp
    raise ValueError(f"flash_attention: head dim {d} > {_fa.HEAD_DIMS[-1]} "
                     "has no kernel")


def _flash_attention_kernel(q, k, v, q_offset, causal, window, softcap):
    """Checked launch; the head dim is zero-padded to a compiled one (exact:
    zero dims add nothing to q·k or to the output columns kept) with the
    scale of the true one."""
    _check_cuda("flash_attention", [q, k, v], q.dtype)
    b, lq, h, d = q.shape
    if (k.dim() != 4 or k.shape != v.shape or k.shape[0] != b
            or k.shape[3] != d or h % k.shape[2]):
        raise ValueError(f"flash_attention: q {tuple(q.shape)} with k "
                         f"{tuple(k.shape)} / v {tuple(v.shape)}")
    dp = _padded_head_dim(d)
    q_off, q_off0 = None, 0
    if torch.is_tensor(q_offset) and q_offset.dim() == 1:
        if q_offset.shape != (b,) or q_offset.device != q.device:
            raise ValueError("flash_attention: per-slot q_offset must be a "
                             f"({b},) tensor on {q.device}")
        q_off = q_offset.to(torch.int32).contiguous()
    else:
        q_off0 = int(q_offset)
    q, k, v = (_aligned(pad_dim(t, 3, dp)) for t in (q, k, v))
    out = torch.empty((b, lq, h, dp), dtype=q.dtype, device=q.device)
    _fa.launch(q, k, v, out, q_off, q_off0, causal=causal, window=window,
               scale=1.0 / math.sqrt(d), softcap=softcap)
    LAUNCHES["flash_attention"] += 1
    return out if dp == d else out[..., :d].contiguous()


class _FlashAttention(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the plain version (CPU).  Backward:
    recompute the plain version and differentiate it — the TPU kernel has
    no backward, and the JAX package differentiates its model-path scan in
    XLA."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, causal, window, chunk, softcap):
        if _on_cpu(q, k, v):
            out = ref.flash_attention_ref(q, k, v, causal=causal,
                                          window=window, q_offset=q_offset,
                                          chunk=chunk, softcap=softcap)
        else:
            out = _flash_attention_kernel(q, k, v, q_offset, causal, window,
                                          softcap)
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, q_offset=q_offset,
                        chunk=chunk, softcap=softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        leaves = [t.detach().requires_grad_(need) for t, need
                  in zip(ctx.saved_tensors, ctx.needs_input_grad[:3])]
        with torch.enable_grad():
            out = ref.flash_attention_ref(*leaves, **ctx.opts)
            wanted = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, dout))
        dq, dk, dv = (next(grads) if t.requires_grad else None
                      for t in leaves)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset=0, chunk: int = 512, softcap: float = 0.0):
    """q (B, Lq, H, D); k/v (B, Lk, KV, D) -> (B, Lq, H, D) in q's dtype;
    differentiable.  ``q_offset``: the absolute position of q[:, 0], an int
    or a (B,) integer tensor (one per slot).  ``chunk`` is the key chunk of
    the plain version; the kernel always walks 64-key tiles."""
    return _FlashAttention.apply(q, k, v, q_offset, causal, window, chunk,
                                 softcap)


# ---------------------------------------------------------------------------
# latent-cache decode


def _check_decode(q, lk, lv, uk, uv, lengths, cos, sin, rope):
    """The kernel takes mixed dtypes, so it has its own check: q, lk, lv in
    one kernel dtype (the cache's), uk / uv / cos / sin fp32, lengths
    int32, everything contiguous on one CUDA device."""
    name = "flash_decode"
    tensors = [q, lk, lv, uk, uv, lengths] + ([cos, sin] if rope else [])
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {device}")
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{name}: operands on {t.device} and {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operand of shape {tuple(t.shape)} is "
                             "not contiguous")
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name}: kernel takes float32 or bfloat16 queries "
                        f"and latents, got {q.dtype}")
    if lk.dtype != q.dtype or lv.dtype != q.dtype:
        raise TypeError(f"{name}: q {q.dtype}, lk {lk.dtype} and lv "
                        f"{lv.dtype} must share one dtype")
    for label, t in (("uk", uk), ("uv", uv)) + ((("cos", cos), ("sin", sin))
                                                 if rope else ()):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {label} must be float32, got {t.dtype}")
    if lengths.dtype != torch.int32:
        raise TypeError(f"{name}: lengths must be int32, got {lengths.dtype}")
    b, h, d = q.shape
    l = lk.shape[1]
    if d not in _fd.HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} has no kernel (RoPE pairs "
                         f"the true dims, so it is not padded); compiled: "
                         f"{_fd.HEAD_DIMS}")
    kv = uk.shape[-1] // d if uk.dim() == 2 else 0
    ok = (lk.dim() == 3 and lv.dim() == 3 and lk.shape[0] == b
          and lv.shape[:2] == (b, l) and uk.dim() == 2 and uv.dim() == 2
          and kv > 0 and uk.shape == (lk.shape[2], kv * d)
          and uv.shape == (lv.shape[2], kv * d) and h % kv == 0
          and lengths.shape == (b,))
    if rope:
        ok = ok and cos.shape == (l, d // 2) and sin.shape == cos.shape
    if not ok:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, lk "
                         f"{tuple(lk.shape)}, lv {tuple(lv.shape)}, uk "
                         f"{tuple(uk.shape)}, uv {tuple(uv.shape)}, lengths "
                         f"{tuple(lengths.shape)} do not fit")
    need = _fd.smem_bytes(h, kv, d, lv.shape[2])
    if need > _fd.MAX_SMEM:
        raise ValueError(f"{name}: {need} bytes of shared memory for r_v "
                         f"{lv.shape[2]} and {h // kv} heads per KV head "
                         f"exceed {_fd.MAX_SMEM}")


def flash_decode(q, lk, lv, uk, uv, lengths, cos, sin, *, rope: bool = True):
    """One decode step against the factorized latent KV cache.

    q: (B, H, D) current-step queries (already RoPE'd); lk/lv: (B, L,
    r_k / r_v) latent caches; uk/uv: (r_k, KV·D) / (r_v, KV·D), the "u"
    factor leaves exactly as stored in params (read by stride, never
    transposed); lengths: (B,) live prefix per slot; cos/sin: (L, D/2)
    rope tables at absolute positions.  Returns (B, H, D) in q's dtype.
    Positions at or past ``lengths[b]`` are masked, so L needs no padding;
    ranks are taken as they are."""
    if _on_cpu(q, lk, lv, uk, uv, lengths, cos, sin):
        return ref.flash_decode_ref(q, lk, lv, uk, uv, lengths, cos, sin,
                                    rope=rope)
    _check_decode(q, lk, lv, uk, uv, lengths, cos, sin, rope)
    out = torch.empty_like(q)
    _fd.launch(q, lk, lv, uk, uv, lengths, cos, sin, out, rope=rope)
    LAUNCHES["flash_decode"] += 1
    return out


# ---------------------------------------------------------------------------
# grouped (ragged) expert GEMM


def _check_grouped(x, w, group_sizes) -> None:
    if (x.dim() != 2 or w.dim() != 3 or w.shape[1] != x.shape[1]
            or group_sizes.shape != (w.shape[0],)):
        raise ValueError(f"grouped_matmul: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)} and group_sizes "
                         f"{tuple(group_sizes.shape)} do not fit")
    if group_sizes.is_floating_point() or group_sizes.is_complex():
        raise TypeError("grouped_matmul: group_sizes must be integers, got "
                        f"{group_sizes.dtype}")


def grouped_operands(x, w):
    """Zero-pad the contraction dim d (x's columns, w's rows) and the output
    dim f (w's columns) to the kernel's multiple: zero columns add nothing
    to a row's product and zero output columns are sliced away, so the
    padding is exact.  Rows need none (the kernel masks them)."""
    mult = _gm.MULTIPLE
    return pad_dim(x, 1, mult), pad_dim(pad_dim(w, 1, mult), 2, mult)


def _grouped_kernel(x, w, group_sizes):
    """Checked launch.  The segment offsets are an exclusive cumsum of the
    group sizes made on the device: nothing of the routing is read on the
    host, so a forward through here never synchronizes."""
    _check_cuda("grouped_matmul", [x, w], x.dtype)
    if group_sizes.device != x.device:
        raise ValueError(f"grouped_matmul: group_sizes on "
                         f"{group_sizes.device}, operands on {x.device}")
    m, f = x.shape[0], w.shape[2]
    if m == 0:
        return x.new_zeros((0, f))
    if -(-m // _gm.ROW_TILE[x.dtype]) > 65535:
        raise ValueError(f"grouped_matmul: {m} rows exceed the kernel's grid")
    offs = torch.cat([torch.zeros(1, dtype=torch.int32, device=x.device),
                      torch.cumsum(group_sizes, 0, dtype=torch.int32)])
    xk, wk = (_aligned(t) for t in grouped_operands(x, w))
    y = torch.empty((m, wk.shape[2]), dtype=x.dtype, device=x.device)
    _gm.launch(xk, wk, offs, y)
    LAUNCHES["grouped_matmul"] += 1
    return y if wk.shape[2] == f else y[:, :f].contiguous()


def _grouped_forward(x, w, group_sizes):
    if _on_cpu(x, w, group_sizes):
        return ref.grouped_matmul_ref(x, w, group_sizes).to(x.dtype)
    return _grouped_kernel(x, w, group_sizes)


class _GroupedMatmul(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the plain version (CPU).  The TPU
    kernel has no backward (the JAX package differentiates
    ``jax.lax.ragged_dot``); here:

    * dx = dy @ W[g]ᵀ per row is the forward function again on
      ``w.transpose(1, 2)`` made contiguous: the kernel on the card;
    * dW[e] = x_eᵀ dy_e is one plain ``torch.matmul`` per expert segment in
      fp32, cast to w's dtype.  Slicing the segments reads the group sizes
      on the host once — in backward only; the forward never does."""

    @staticmethod
    def forward(ctx, x, w, group_sizes):
        ctx.save_for_backward(x, w, group_sizes)
        return _grouped_forward(x, w, group_sizes)

    @staticmethod
    def backward(ctx, dy):
        x, w, group_sizes = ctx.saved_tensors
        need = ctx.needs_input_grad
        dy = dy.contiguous()
        dx = dw = None
        if need[0]:
            wt = w.transpose(1, 2).contiguous()
            dx = _grouped_forward(dy.to(wt.dtype), wt, group_sizes)
            dx = dx.to(x.dtype)
        if need[1]:
            grads = []
            start = 0
            for n in group_sizes.tolist():
                n = max(0, min(int(n), x.shape[0] - start))
                grads.append(x[start:start + n].float().T
                             @ dy[start:start + n].float())
                start += n
            dw = torch.stack(grads).to(w.dtype)
        return dx, dw, None


def grouped_matmul(x, w, group_sizes):
    """Grouped (ragged) expert GEMM: x (M, d) rows sorted by group, w
    (E, d, f), group_sizes (E,) integers summing to M -> (M, f) in x's
    dtype, fp32 accumulation; differentiable in x and w.

    Row i contracts against W[group(i)] only — a per-row function, which
    keeps the drop-free MoE dispatch batch-size invariant.  On the card x
    and w share one kernel dtype and group_sizes lies on the same device
    (converted to int32 there)."""
    _check_grouped(x, w, group_sizes)
    if not _on_cpu(x, w, group_sizes):
        group_sizes = group_sizes.to(torch.int32)
    return _GroupedMatmul.apply(x, w, group_sizes)
