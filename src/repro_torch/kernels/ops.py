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
  the kernels;
* asks ``kernels.autotune`` for its launch plan, as the JAX wrappers ask
  theirs for block shapes: the kernel module's ``plan()`` on the CPU and
  under ``REPRO_AUTOTUNE=heuristic``, a measured and cached pick of its
  lattice on the card.  A measurement launches the candidates on the
  caller's inputs into outputs of its own (never into the caller's
  tensors, ``acc=`` included) and is not counted in ``LAUNCHES``.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import math
from typing import Dict, Optional, Sequence

import torch

from repro_torch.kernels import autotune
from repro_torch.kernels import cov_accum as _cov
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import grouped_matmul as _gm
from repro_torch.kernels import lowrank_matmul as _lowrank
from repro_torch.kernels import ref

LAUNCHES: Dict[str, int] = {"cov_accum": 0, "cov_accum_banked": 0,
                            "lowrank_matmul": 0, "flash_attention": 0,
                            "flash_decode": 0, "grouped_matmul": 0}
# lowrank_matmul's launches by row count T (its plan's body depends on T)
LOWRANK_ROWS: Dict[int, int] = collections.Counter()
# flash_attention's launches by its plan's body
FLASH_BODIES: Dict[str, int] = collections.Counter()
# flash_decode's launches by its plan's keys body
DECODE_BODIES: Dict[str, int] = collections.Counter()
# grouped_matmul's launches by routed row count M
GROUPED_ROWS: Dict[int, int] = collections.Counter()

KERNEL_DTYPES = (torch.float32, torch.bfloat16)

# Static registry: public wrapper that launches a kernel -> its contract and
# lattice (``kernels.contracts.CONTRACTS``, ``autotune._LATTICES``).  The
# contract pass (``repro_torch.analysis.contracts``) checks that the four
# agree, so a kernel cannot ship without a contract and a lattice.  The
# banked and grouped covariances run cov_accum's kernel, lowrank_down /
# lowrank_up one product of lowrank_matmul's.
REGISTERED_KERNELS: Dict[str, str] = {
    "lowrank_matmul": "lowrank_matmul",
    "lowrank_down": "lowrank_matmul",
    "lowrank_up": "lowrank_matmul",
    "cov_accum": "cov_accum",
    "cov_accum_banked": "cov_accum",
    "cov_accum_grouped": "cov_accum",
    "flash_attention": "flash_attention",
    "flash_decode": "flash_decode",
    "grouped_matmul": "grouped_matmul",
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    LOWRANK_ROWS.clear()
    FLASH_BODIES.clear()
    DECODE_BODIES.clear()
    GROUPED_ROWS.clear()


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


class _Scratch:
    """A measurement's fp32 scratch: one buffer, grown to the largest
    candidate's need (at least one float: the launchers take a null scratch
    only for unsplit plans)."""

    def __init__(self, device):
        self.device, self.buf = device, None

    def __call__(self, floats: int) -> torch.Tensor:
        if self.buf is None or self.buf.numel() < floats:
            self.buf = torch.empty(max(floats, 1), dtype=torch.float32,
                                   device=self.device)
        return self.buf


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


def _add_into(acc, outs):
    """``outs`` when there is no ``acc``; else ``outs`` added into ``acc``
    IN PLACE and ``acc`` returned."""
    if acc is None:
        return outs
    for a, o in zip(acc, outs):
        a.add_(o)
    return acc


def _cov_kernel(name: str, x, xp, acc):
    """The covariance kernel on (E, T, n) CUDA inputs (E 1 for a dense
    tap): one launch for all E triples, counted under ``name``.  n is
    padded to the body's 16-byte multiple, T never.  ``acc`` (E, n, n)
    fp32 is added into in place, straight by the kernel when n needs no
    padding and it is 16-byte aligned, else from a fresh triple."""
    e, t, n = x.shape
    _check_cuda(name, [x, xp], x.dtype)
    if acc is not None:
        for a in acc:
            if (a.device != x.device or a.dtype != torch.float32
                    or tuple(a.shape) != (e, n, n) or not a.is_contiguous()):
                raise ValueError(f"{name}: acc= must be contiguous float32 "
                                 f"of the triple's shape on {x.device}")
    if e == 0 or t == 0:
        return _add_into(acc, tuple(x.new_zeros((e, n, n),
                                                dtype=torch.float32)
                                    for _ in range(3)))
    xk = _aligned(pad_dim(x, 2, _cov.ALIGN[x.dtype]))
    xpk = _aligned(pad_dim(xp, 2, _cov.ALIGN[x.dtype]))
    p = autotune.cov_plan(t, n, x.dtype, banks=e, device=x.device,
                          invariant=_BATCH_INVARIANT,
                          bench=lambda: _cov_bench(xk, xpk,
                                                   acc is not None)).plan
    scratch = (torch.empty(p.scratch_floats, dtype=torch.float32,
                           device=x.device) if p.scratch_floats else None)
    if (acc is not None and p.n == n
            and all(a.data_ptr() % 16 == 0 for a in acc)):
        _cov.launch(p, xk, xpk, *acc, scratch, accumulate=True)
        LAUNCHES[name] += 1
        return acc
    outs = tuple(torch.empty((e, p.n, p.n), dtype=torch.float32,
                             device=x.device) for _ in range(3))
    _cov.launch(p, xk, xpk, *outs, scratch, accumulate=False)
    LAUNCHES[name] += 1
    if p.n != n:
        outs = tuple(o[:, :n, :n].contiguous() for o in outs)
    return _add_into(acc, outs)


def _cov_bench(x, xp, accumulate: bool):
    """A measurement's launcher: plan ``p`` on the padded inputs into a
    triple of its own (added into when the call adds into ``acc=``)."""
    e, _, n = x.shape
    outs = tuple(torch.empty((e, n, n), dtype=torch.float32, device=x.device)
                 for _ in range(3))
    scratch = _Scratch(x.device)

    def run(p):
        _cov.launch(p, x, xp, *outs, scratch(p.scratch_floats),
                    accumulate=accumulate)
    return run


def cov_accum(x, xp, *, acc=None):
    """(T, n) x2 -> (xx, xxp, xpxp) fp32 (leading axes flatten into T).

    ``acc`` is an existing fp32 (xx, xxp, xpxp) triple to accumulate into.
    The wrapper owns that update and does it IN PLACE — the caller's
    tensors are modified and returned — which on the card lets the kernel
    add straight into them and saves a fresh 3·n²·4-byte triple per call
    (when n is not a multiple of 16 bytes' worth of elements, or ``acc``
    is not 16-byte aligned, the kernel writes a fresh triple and it is
    added in).  On the card xx and xpxp come out exactly symmetric (given
    a symmetric ``acc``) and two calls on the same inputs give the same
    bits (``kernels.cov_accum``).  A strided view (Mamba1's ``dt_proj``
    tap is the first ``dt_rank`` columns of ``x_proj``'s output) is copied
    to contiguous rows first."""
    n = x.shape[-1]
    x = x.reshape(-1, n).contiguous()
    xp = xp.reshape(-1, n).contiguous()
    if x.shape != xp.shape:
        raise ValueError(f"cov_accum: shapes {tuple(x.shape)} and "
                         f"{tuple(xp.shape)} differ")
    if x.device.type == "cpu" and xp.device.type == "cpu":
        return _add_into(acc, ref.cov_accum_ref(x, xp))
    outs = _cov_kernel("cov_accum", x[None], xp[None],
                       None if acc is None else tuple(a[None] for a in acc))
    return acc if acc is not None else tuple(o[0] for o in outs)


def cov_accum_banked(x, xp, *, acc=None):
    """Expert-bank covariance triple: (E, C, n) x2 -> (xx, xxp, xpxp), each
    (E, n, n) fp32, the capacity dispatch's per-expert triples.

    One launch of ``cov_accum``'s kernel over all E banks (the counterpart
    of the JAX package's vmapped ``cov_accum_banked``, without ``mesh``).
    Capacity padding is exact: zero slots add zero outer products.  ``acc``
    is an existing (E, n, n) fp32 triple, updated IN PLACE as in
    ``cov_accum``.  On the card each bank's xx and xpxp come out exactly
    symmetric, and a bank's bits depend on its own inputs alone."""
    if x.ndim != 3 or x.shape != xp.shape:
        raise ValueError(f"cov_accum_banked: shapes {tuple(x.shape)} and "
                         f"{tuple(xp.shape)} are not one (E, C, n)")
    if x.device.type == "cpu" and xp.device.type == "cpu":
        return _add_into(acc, ref.cov_accum_banked_ref(x, xp))
    return _cov_kernel("cov_accum_banked", x, xp, acc)


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


# set by ``batch_invariant``: lowrank_matmul takes the large-T body at any
# T, flash_attention a tile body at any Lq
_BATCH_INVARIANT = False


@contextlib.contextmanager
def batch_invariant():
    """Inside it ``lowrank_matmul`` runs its large-T body at every row count
    T and ``flash_attention`` a tile body at every query length Lq; in
    both a row's result does not depend on the row count (nor, in
    attention, on where its query block starts), so a prompt prefilled in
    chunks (a last chunk of any length) gives the bits of whole prefill.
    Outside it T <= ``SMALL_T_MAX`` (decode) takes the small-T body, which
    rounds t differently, and Lq 1 attention the split body, which sums
    over key spans merged afterwards.  Prefill (``models.model.prefill``)
    runs in it."""
    global _BATCH_INVARIANT
    before, _BATCH_INVARIANT = _BATCH_INVARIANT, True
    try:
        yield
    finally:
        _BATCH_INVARIANT = before


def _lowrank_kernel(x, v, u, bias, residual, body=None, t_in=None):
    """Checked launch of the call's plan (``kernels.lowrank_matmul.plan``;
    ``body`` forces one, else ``batch_invariant`` may) on 2D operands;
    returns (y (T, m), t (T, k)).  T is never padded; n, k, m only to what
    the plan's body loads (zeros, exact).  With ``t_in`` (T, k) given
    instead of x and v, only t @ U runs (``lowrank_up``)."""
    lead = x if t_in is None else t_in
    _check_cuda("lowrank_matmul", [lead, v, u, bias, residual], lead.dtype)
    k, m = u.shape
    if t_in is None:
        t0, n = x.shape
        if v.shape != (n, k):
            raise ValueError(f"lowrank_matmul: v {tuple(v.shape)} does not "
                             f"match x {tuple(x.shape)} and u "
                             f"{tuple(u.shape)}")
    else:
        (t0, kt), n = t_in.shape, 0
        if kt != k:
            raise ValueError(f"lowrank_up: t {tuple(t_in.shape)} does not "
                             f"match u {tuple(u.shape)}")
    if t0 == 0:
        return lead.new_zeros((0, m)), lead.new_zeros((0, k))
    if body is None and _BATCH_INVARIANT:
        body = _lowrank.LARGE_T_BODY[lead.dtype]
    an, ak, am = _lowrank.plan(t0, n, k, m, lead.dtype, body=body).align
    uk = _aligned(pad_dim(pad_dim(u, 0, ak), 1, am))
    bk = None if bias is None else _aligned(pad_dim(bias.reshape(-1), 0, am))
    rk = None if residual is None else _aligned(pad_dim(residual, 1, am))
    if t_in is None:
        xk = _aligned(pad_dim(x, 1, an))
        vk = _aligned(pad_dim(pad_dim(v, 0, an), 1, ak))
        t = None
    else:
        xk = vk = None
        t = _aligned(pad_dim(t_in, 1, ak))
    p = autotune.lowrank_plan(
        t0, n, k, m, lead.dtype, body=body, invariant=_BATCH_INVARIANT,
        device=lead.device,
        bench=functools.partial(_lowrank_bench, xk, vk, uk, t, bk, rk)).plan
    y = torch.empty((t0, p.m), dtype=lead.dtype, device=lead.device)
    if t is None:
        t = torch.empty((t0, p.k), dtype=x.dtype, device=x.device)
    scratch = (torch.empty(p.scratch_floats, dtype=torch.float32,
                           device=lead.device) if p.scratch_floats else None)
    _lowrank.launch(p, xk, vk, uk, t, y, bk, rk, scratch)
    LAUNCHES["lowrank_matmul"] += 1
    LOWRANK_ROWS[t0] += 1
    return (y if p.m == m else y[:, :m].contiguous()), t[:, :k]


def _lowrank_bench(x, v, u, t_in, bias, residual, product: str):
    """A measurement's launcher: the whole call under plan ``p`` (the
    candidate differs from the anchor in ``product``'s split alone, so the
    other product's time is common to all) on the padded operands, into
    outputs of its own."""
    lead = x if t_in is None else t_in
    rows, dev = lead.shape[0], lead.device
    k, m = u.shape
    t = t_in if t_in is not None else torch.empty(
        (rows, k), dtype=lead.dtype, device=dev)
    y = torch.empty((rows, m), dtype=lead.dtype, device=dev)
    scratch = _Scratch(dev)

    def run(p):
        _lowrank.launch(p, x, v, u, t, y, bias, residual,
                        scratch(p.scratch_floats))
    return run


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


def lowrank_up(t, u):
    """y = t @ u, summed in fp32 and rounded once to t's dtype: the second
    product of ``lowrank_matmul`` alone, on a given rank-k t.  t: (..., k);
    u: (k, m).  On the card it runs the t @ U of the kernel's plan for any
    x (``batch_invariant`` holds for it too), so the latent cache's keys and
    values round as the dense layout's ``lowrank_matmul`` rounds them; on
    the CPU it is the plain version's second product.  No autograd."""
    lead = t.shape[:-1]
    tf = t.reshape(-1, t.shape[-1])
    if tf.device.type == "cpu":
        y = torch.matmul(tf.float(), u.float()).to(tf.dtype)
    else:
        y = _lowrank_kernel(None, None, u, None, None,
                            t_in=tf.contiguous())[0]
    return y.reshape(*lead, u.shape[1])


# ---------------------------------------------------------------------------
# flash attention


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _padded_head_dim(d: int) -> int:
    """The smallest head dim ``flash_attention`` is compiled for that holds
    ``d``: ``d`` itself where it has a body (96 and 112 among them), else
    the next one up (the smoke configs' 8, 20, 24, 100; raises past 256: no
    body takes it)."""
    for dp in _fa.HEAD_DIMS:
        if dp >= d:
            return dp
    raise ValueError(f"flash_attention: head dim {d} > {_fa.HEAD_DIMS[-1]} "
                     "has no kernel")


def _flash_attention_kernel(q, k, v, q_offset, causal, window, softcap):
    """Checked launch of the call's plan (``kernels.flash_attention.plan``;
    ``batch_invariant`` makes it choose by dtype and head dim alone).  A
    compiled head dim reaches the kernel as the caller's tensors, read in
    place; any other is zero-padded to the next compiled one (exact: zero
    dims add nothing to q·k or to the output columns kept) with the scale of
    the true one.  Per-slot offsets stay on the device: the kernel reads
    them."""
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
    scale = 1.0 / math.sqrt(d)
    p = autotune.flash_plan(
        b, lq, k.shape[1], h, k.shape[2], dp, q.dtype, causal=causal,
        window=window, invariant=_BATCH_INVARIANT, device=q.device,
        bench=lambda: _flash_bench(q, k, v, q_off, q_off0, scale,
                                   softcap)).plan
    out = torch.empty((b, lq, h, dp), dtype=q.dtype, device=q.device)
    scratch = (torch.empty(p.scratch_floats, dtype=torch.float32,
                           device=q.device) if p.scratch_floats else None)
    _fa.launch(p, q, k, v, out, q_off, q_off0, scale=scale,
               softcap=softcap, scratch=scratch)
    LAUNCHES["flash_attention"] += 1
    FLASH_BODIES[p.body] += 1
    return out if dp == d else out[..., :d].contiguous()


def _flash_bench(q, k, v, q_off, q_off0, scale, softcap):
    """A measurement's launcher: plan ``p`` on the padded q, k, v and the
    call's offsets, into an output of its own."""
    out = torch.empty_like(q)
    scratch = _Scratch(q.device)

    def run(p):
        _fa.launch(p, q, k, v, out, q_off, q_off0, scale=scale,
                   softcap=softcap, scratch=scratch(p.scratch_floats)
                   if p.scratch_floats else None)
    return run


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
    the plain version; the kernel walks its plan's key tiles or spans."""
    return _FlashAttention.apply(q, k, v, q_offset, causal, window, chunk,
                                 softcap)


# ---------------------------------------------------------------------------
# latent-cache decode


def _check_decode(q, lk, lv, uk, uv, lengths, cos, sin, rope):
    """The kernel takes mixed dtypes, so it has its own check: everything
    contiguous on one CUDA device, then ``_decode_plan``."""
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
    return _decode_plan(q, lk, lv, uk, uv, lengths, cos, sin, rope)


def _decode_plan(q, lk, lv, uk, uv, lengths, cos, sin, rope):
    """q, lk, lv in one kernel dtype (the cache's), uk / uv / cos / sin
    fp32, lengths int32, shapes that fit; returns the call's plan
    (``kernels.flash_decode.plan``, which refuses head dims and shared
    memory no body takes)."""
    name = "flash_decode"
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
    return autotune.flash_decode_plan(b, l, h, kv, d, lk.shape[2],
                                      lv.shape[2], q.dtype,
                                      device=q.device).plan


def flash_decode(q, lk, lv, uk, uv, lengths, cos, sin, *, rope: bool = True):
    """One decode step against the factorized latent KV cache.

    q: (B, H, D) current-step queries (already RoPE'd); lk/lv: (B, L,
    r_k / r_v) latent caches; uk/uv: (r_k, KV·D) / (r_v, KV·D), the "u"
    factor leaves exactly as stored in params (read by stride, never
    transposed); lengths: (B,) live prefix per slot; cos/sin: (L, D/2)
    rope tables at absolute positions.  Returns (B, H, D) in q's dtype.
    Positions at or past ``lengths[b]`` are masked, so L needs no padding;
    ranks are taken as they are.  On the card the plan's key spans start
    at absolute key 0 and a slot's spans merge in order, so a slot's
    output bits do not depend on B, L or the other slots; the scratch of
    the span partials is allocated here."""
    if _on_cpu(q, lk, lv, uk, uv, lengths, cos, sin):
        return ref.flash_decode_ref(q, lk, lv, uk, uv, lengths, cos, sin,
                                    rope=rope)
    p = _check_decode(q, lk, lv, uk, uv, lengths, cos, sin, rope)
    out = torch.empty_like(q)
    scratch = torch.empty(p.scratch_floats, dtype=torch.float32,
                          device=q.device)
    q, lk, lv, uk, uv = (_aligned(t) for t in (q, lk, lv, uk, uv))
    if rope:
        cos, sin = _aligned(cos), _aligned(sin)
    _fd.launch(p, q, lk, lv, uk, uv, lengths, cos, sin, out, scratch,
               rope=rope)
    LAUNCHES["flash_decode"] += 1
    DECODE_BODIES[p.body] += 1
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


def _grouped_kernel(x, w, group_sizes, trans=False):
    """Checked launch of y = x @ W[g] (``trans``: W[g]ᵀ, x then (M, f)).
    The kernel scans the group sizes into the segment offsets on the
    device: nothing of the routing is read on the host, so a forward
    through here never synchronizes.  The fp32 body takes W as it lies: it
    gets Wᵀ made contiguous; the bf16 body reads the bank in place."""
    _check_cuda("grouped_matmul", [x, w], x.dtype)
    if group_sizes.device != x.device:
        raise ValueError(f"grouped_matmul: group_sizes on "
                         f"{group_sizes.device}, operands on {x.device}")
    if trans and _gm.BODY[x.dtype] == "fma32":
        w, trans = w.transpose(1, 2).contiguous(), False
    m, n = x.shape[0], w.shape[1 if trans else 2]
    if m == 0:
        return x.new_zeros((0, n))
    e, d, f = w.shape
    xk, wk = (_aligned(t) for t in grouped_operands(x, w))
    gs = group_sizes.contiguous()
    p = autotune.grouped_plan(m, d, f, e, x.dtype, trans, device=x.device,
                              bench=lambda: _grouped_bench(xk, wk, gs,
                                                           trans)).plan
    y = torch.empty((m, p.n), dtype=x.dtype, device=x.device)
    _gm.launch(p, xk, wk, gs, y)
    LAUNCHES["grouped_matmul"] += 1
    GROUPED_ROWS[m] += 1
    return y if p.n == n else y[:, :n].contiguous()


def _grouped_bench(x, w, group_sizes, trans):
    """A measurement's launcher: plan ``p`` on the padded operands and the
    call's group sizes, into an output of its own."""
    y = torch.empty((x.shape[0], w.shape[1 if trans else 2]), dtype=x.dtype,
                    device=x.device)

    def run(p):
        _gm.launch(p, x, w, group_sizes, y)
    return run


def _grouped_forward(x, w, group_sizes, trans=False):
    if _on_cpu(x, w, group_sizes):
        wt = w.transpose(1, 2) if trans else w
        return ref.grouped_matmul_ref(x, wt, group_sizes).to(x.dtype)
    return _grouped_kernel(x, w, group_sizes, trans)


class _GroupedMatmul(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the plain version (CPU).  The TPU
    kernel has no backward (the JAX package differentiates
    ``jax.lax.ragged_dot``); here:

    * dx = dy @ W[g]ᵀ per row is the kernel again with ``trans``: the bf16
      body reads the bank in place as a K-major operand (no transposed
      copy); the fp32 body is handed Wᵀ made contiguous;
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
            dx = _grouped_forward(dy.to(w.dtype), w, group_sizes, trans=True)
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
