"""Static contracts of every hand-written kernel's launch-plan lattice.

Counterpart of ``src/repro/kernels/contracts.py``.  One
:class:`KernelContract` per entry of ``autotune._LATTICES`` says, without a
card, what each candidate the tuner may launch must satisfy:

* **alignment** — the plan's own multiples: 16-byte rows of the widths the
  kernel loads (8 bf16 / 4 fp32 elements, the wgmma bodies' 8, the fp32
  tiles' 16 / 64), whole ``STEP``s in a covariance slice, whole ring stages
  or one ``WG_SLICE`` in a split product, whole key tiles in an attention
  span, the compiled ``SPAN`` of the decode;
* **resources** — each candidate's modeled shared bytes
  (``autotune.smem_bytes``) within the budget, and its grid within
  2³¹−1 × 65535 × 65535;
* **evaluation** — the counterpart of ``jax.eval_shape``: for each probe
  and candidate the kernel module's ``emulate(plan, ...)`` (the plan's own
  tiling arithmetic in plain PyTorch) runs on CPU tensors made from a numpy
  seed, is held against ``kernels.ref`` within the stated tolerance, and
  its outputs' shapes must equal what the wrapper slices.  A bad split,
  span or tile fails here, on the host, before any card sees it.

Every probe runs in fp32 and bf16.  The probes are the JAX package's
(``src/repro/kernels/contracts.py``) plus the port's own head dims
(attention 96, 112, 192, 256; decode 8, 20, 96, 112) and the shapes that
reach each lattice (one-row attention, small-T and split products, banks).
A probe the port refuses on purpose is listed in ``refused``: the JAX
decode probe at D 80, which no decode body takes (RoPE pairs the true
dims, so a head dim is never padded); its plan must raise ``ValueError``.
``repro_torch.analysis.contracts`` drives these.
"""

from __future__ import annotations

import repro_torch._fp32  # noqa: F401  (TF32 off before any torch work)
import dataclasses
import functools
import math
from typing import Callable, Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.kernels import autotune
from repro_torch.kernels import cov_accum as _cov
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import grouped_matmul as _gm
from repro_torch.kernels import lowrank_matmul as _low
from repro_torch.kernels import ref

DTYPES = ("float32", "bfloat16")

# tolerances of emulate against kernels.ref: max |emulate - ref| over
# max |ref|.  fp32: the same fp32 products summed in another order (the
# covariance's atol is thereby scaled to its accumulator, hazard 3b);
# bf16: outputs rounded once to bf16 (chip_smoke.py's limits)
TOL = {"cov_accum": {"float32": 1e-5, "bfloat16": 1e-5},
       "lowrank_matmul": {"float32": 1e-5, "bfloat16": 2e-2},
       "flash_attention": {"float32": 2e-5, "bfloat16": 2e-2},
       "flash_attention_bwd": {"float32": 2e-5, "bfloat16": 2e-2},
       "flash_decode": {"float32": 1e-4, "bfloat16": 2e-2},
       "grouped_matmul": {"float32": 1e-5, "bfloat16": 1e-2}}


class KernelContract(NamedTuple):
    """The static contract of one kernel's (lattice, wrapper, emulation).

    ``align``      (plan) -> {plan field: required multiple}.
    ``probes``     problem shapes (with a ``dtype``), aligned and ragged.
    ``candidates`` (probe) -> the tuner's candidates for the probe.
    ``evaluate``   (probe, plan) -> (outputs, err / tolerance): the plan's
                   emulation against the plain version (raises if the
                   plan's arithmetic does — that IS the check).
    ``expected``   (probe, plan) -> the output shapes the wrapper slices.
    ``refused``    probes the plan must refuse with ``ValueError``.
    ``exact``      (plan) -> {plan field: the one value its body is
                   compiled for} (tile edges, key tiles, slices, spans).
    """

    name: str
    align: Callable[[object], Dict[str, int]]
    probes: Tuple[Dict, ...]
    candidates: Callable[[Dict], List[autotune.Candidate]]
    evaluate: Callable[[Dict, object], Tuple[tuple, float]]
    expected: Callable[[Dict, object], tuple]
    refused: Tuple[Dict, ...] = ()
    exact: Callable[[object], Dict[str, int]] = lambda plan: {}


def _dtype(p) -> torch.dtype:
    return getattr(torch, p["dtype"])


def _rand(shape, seed, dtype=torch.float32, scale=1.0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(a).to(dtype)


def _both(*probes) -> Tuple[Dict, ...]:
    return tuple({**p, "dtype": dt} for p in probes for dt in DTYPES)


def _ratio(got, want, kernel, probe) -> float:
    err = max(float((g.float() - w.float()).abs().max())
              for g, w in zip(got, want))
    top = max(float(w.float().abs().max()) for w in want)
    return err / (TOL[kernel][probe["dtype"]] * max(top, 1e-30))


# ---------------------------------------------------------------------------
# cov_accum — the covariance triple on (T, n) rows, or (E, C, n) banks


def _cov_inputs(p):
    dt = _dtype(p)
    shape = ((p["banks"],) if "banks" in p else ()) + (p["t"], p["n"])
    x = _rand(shape, 1, dt)
    xp = (x.float() + 0.1 * _rand(shape, 2)).to(dt)
    return x, xp


def _cov_eval(p, plan):
    x, xp = _cov_inputs(p)
    got = _cov.emulate(plan, x, xp)
    want = (ref.cov_accum_banked_ref(x, xp) if x.ndim == 3
            else ref.cov_accum_ref(x, xp))
    return got, _ratio(got, want, "cov_accum", p)


def _cov_expected(p, plan):
    lead = (p["banks"],) if "banks" in p else ()
    return tuple(lead + (p["n"], p["n"]) for _ in range(3))


def _cov_align(plan):
    out = {"n": plan.align}
    if plan.splits > 1:
        out["rows_per_split"] = plan.step
    return out


_COV = KernelContract(
    name="cov_accum",
    align=_cov_align,
    probes=_both(
        {"t": 1024, "n": 512},        # aligned (the transformer tap shape)
        {"t": 300, "n": 80},          # ragged tokens + the 80-dim tap
        {"t": 8, "n": 128},           # fewer rows than a step
        {"t": 130, "n": 72, "banks": 3},   # the bank axis, ragged
    ),
    candidates=lambda p: autotune.cov_candidates(
        p["t"], p["n"], _dtype(p), p.get("banks", 1)),
    evaluate=_cov_eval,
    expected=_cov_expected,
    exact=lambda plan: {"edge": _cov.EDGE[plan.dtype],
                        "step": _cov.STEP[plan.dtype]},
)


# ---------------------------------------------------------------------------
# lowrank_matmul — (x @ V) @ U, each product's split tuned on its own


def _lr_candidates(p):
    kw = dict(body=None, invariant=bool(p.get("invariant")))
    out = []
    for product in ("xv", "tu"):
        out += autotune.lowrank_candidates(p["t"], p["n"], p["k"], p["m"],
                                           _dtype(p), product=product, **kw)
    seen, uniq = set(), []
    for c in out:
        if c.plan not in seen:
            seen.add(c.plan)
            uniq.append(c)
    return uniq


def _lr_eval(p, plan):
    dt = _dtype(p)
    x = _rand((p["t"], p["n"]), 3, dt)
    v = _rand((p["n"], p["k"]), 4, dt, 1 / math.sqrt(p["n"]))
    u = _rand((p["k"], p["m"]), 5, dt, 1 / math.sqrt(p["k"]))
    y, t = _low.emulate(plan, x, v, u)
    want = ref.lowrank_matmul_ref(x, v, u)
    return (y, t), _ratio((y,), (want,), "lowrank_matmul", p)


def _lr_align(plan):
    an, ak, am = plan.align
    out = {"n": an, "k": ak, "m": am}
    if plan.body == "small_t":
        stage = _low.SMALL_STAGE[torch.bfloat16 if an == 8
                                 else torch.float32]
        for field, splits in (("depth_xv", plan.splits_xv),
                              ("depth_tu", plan.splits_tu)):
            if splits > 1:
                out[field] = stage
    return out


def _lr_exact(plan):
    """The wgmma body takes a split product only as one ``WG_SLICE`` slice
    a block, in 128-row tiles."""
    if plan.body != "wgmma":
        return {}
    out = {"tile_rows_xv": _low.WG_ROWS, "tile_rows_tu": _low.WG_ROWS}
    for field, splits in (("depth_xv", plan.splits_xv),
                          ("depth_tu", plan.splits_tu)):
        if splits > 1:
            out[field] = _low.WG_SLICE
    return out


_LOWRANK = KernelContract(
    name="lowrank_matmul",
    align=_lr_align,
    probes=_both(
        {"t": 512, "n": 512, "k": 128, "m": 512},     # aligned
        {"t": 100, "n": 80, "k": 16, "m": 80},        # everything ragged
        {"t": 8, "n": 2048, "k": 96, "m": 256},       # decode: small_t
        {"t": 77, "n": 2048, "k": 96, "m": 256},      # split products
        {"t": 8, "n": 2048, "k": 96, "m": 256, "invariant": 1},
    ),
    candidates=_lr_candidates,
    evaluate=_lr_eval,
    expected=lambda p, plan: ((p["t"], p["m"]), (p["t"], p["k"])),
    exact=_lr_exact,
)


# ---------------------------------------------------------------------------
# flash_attention — the tile bodies (a lattice of one) and the split spans


def _fa_offsets(p):
    if p["lq"] > 1:
        return (0,) * p["b"]
    # one-row queries at spread positions, one short of the keys' end
    return tuple(max(0, p["lk"] - 1 - 37 * i) for i in range(p["b"]))


def _fa_eval(p, plan):
    dt = _dtype(p)
    q = _rand((p["b"], p["lq"], p["h"], p["d"]), 6, dt)
    k = _rand((p["b"], p["lk"], p["kv"], p["d"]), 7, dt)
    v = _rand((p["b"], p["lk"], p["kv"], p["d"]), 8, dt)
    offs = _fa_offsets(p)
    window = p.get("window", 0)
    scale = 1.0 / math.sqrt(p["d"])
    out = _fa.emulate(dataclasses.replace(plan, offsets=offs), q, k, v,
                      scale=scale)
    want = ref.flash_attention_ref(
        q, k, v, causal=True, window=window,
        q_offset=torch.tensor(offs) if p["lq"] == 1 else 0)
    return (out,), _ratio((out,), (want,), "flash_attention", p)


_FLASH = KernelContract(
    name="flash_attention",
    align=lambda plan: ({"span": plan.bkey}
                        if plan.body in _fa.SPLIT_BODIES else {}),
    probes=_both(
        {"b": 2, "h": 4, "kv": 2, "lq": 512, "lk": 512, "d": 128},
        {"b": 1, "h": 4, "kv": 4, "lq": 333, "lk": 257, "d": 128},
        *({"b": 1, "h": 2, "kv": 1, "lq": 70, "lk": 90, "d": d}
          for d in (96, 112, 192, 256)),
        # one-row queries: the split bodies' spans
        {"b": 3, "h": 8, "kv": 2, "lq": 1, "lk": 300, "d": 64},
        {"b": 2, "h": 4, "kv": 4, "lq": 1, "lk": 257, "d": 112},
        {"b": 2, "h": 8, "kv": 1, "lq": 1, "lk": 400, "d": 256,
         "window": 200},
    ),
    candidates=lambda p: autotune.flash_candidates(
        p["b"], p["lq"], p["lk"], p["h"], p["kv"], p["d"], _dtype(p),
        window=p.get("window", 0)),
    evaluate=_fa_eval,
    expected=lambda p, plan: ((p["b"], p["lq"], p["h"], plan.d),),
    exact=lambda plan: {"bkey": (
        _fa.WG_BKEY[plan.d] if plan.body == "wgmma"
        else _fa.mma_keys(plan.d) if plan.body == "split_mma"
        else _fa.split_keys(plan.dtype, plan.d) if plan.body == "split"
        else _fa.tile_bkey(plan.d))},
)


# ---------------------------------------------------------------------------
# flash_attention_bwd — dq, dk, dv from the forward's output and LSE (its
# tiles compiled per dtype and head dim: a lattice of one)


def _fab_eval(p, plan):
    dt = _dtype(p)
    q = _rand((p["b"], p["lq"], p["h"], p["d"]), 16, dt)
    k = _rand((p["b"], p["lk"], p["kv"], p["d"]), 17, dt)
    v = _rand((p["b"], p["lk"], p["kv"], p["d"]), 18, dt)
    dout = _rand((p["b"], p["lq"], p["h"], p["d"]), 19, dt)
    offs = tuple(p.get("offsets", (0,) * p["b"]))
    kw = dict(causal=p.get("causal", True), window=p.get("window", 0),
              softcap=p.get("softcap", 0.0))
    scale = 1.0 / math.sqrt(p["d"])
    fwd = _fa.plan(p["b"], p["lq"], p["lk"], p["h"], p["kv"], p["d"], dt,
                   causal=kw["causal"], window=kw["window"], q_offset=offs,
                   invariant=True)
    out, lse = _fa.emulate(fwd, q, k, v, scale=scale,
                           softcap=kw["softcap"], lse=True)
    got = _fa.emulate_backward(dataclasses.replace(plan, offsets=offs), q,
                               k, v, out, lse, dout, scale=scale,
                               softcap=kw["softcap"])
    want = ref.flash_attention_bwd_ref(q, k, v, dout,
                                       q_offset=torch.tensor(offs), **kw)
    return got, _ratio(got, want, "flash_attention_bwd", p)


_FLASH_BWD = KernelContract(
    name="flash_attention_bwd",
    align=lambda plan: {},
    probes=_both(
        # GQA with per-slot offsets, a window and a soft cap, Lk ragged
        {"b": 2, "h": 4, "kv": 2, "lq": 40, "lk": 70, "d": 64,
         "window": 24, "softcap": 30.0, "offsets": (30, 5)},
        # non-causal with Lq != Lk (cross-attention)
        {"b": 1, "h": 2, "kv": 2, "lq": 20, "lk": 45, "d": 112,
         "causal": False},
        # D 16 (fma in both dtypes) and D 256 (the narrower steps)
        {"b": 1, "h": 2, "kv": 1, "lq": 33, "lk": 33, "d": 16},
        {"b": 1, "h": 2, "kv": 1, "lq": 35, "lk": 35, "d": 256},
    ),
    candidates=lambda p: autotune.flash_bwd_candidates(
        p["b"], p["lq"], p["lk"], p["h"], p["kv"], p["d"], _dtype(p),
        causal=p.get("causal", True), window=p.get("window", 0)),
    evaluate=_fab_eval,
    expected=lambda p, plan: ((p["b"], p["lq"], p["h"], p["d"]),
                              (p["b"], p["lk"], p["kv"], p["d"]),
                              (p["b"], p["lk"], p["kv"], p["d"])),
    exact=lambda plan: (
        {"kv_keys": _fa.BWD_WG_KEYS, "kv_rows": _fa.bwd_wg_rows(plan.d),
         "q_rows": _fa.BWD_WG_QROWS, "q_keys": _fa.bwd_wg_keys(plan.d)}
        if plan.body == "wgmma" else
        {f: _fa.BWD_TILE for f in ("kv_keys", "kv_rows", "q_rows",
                                   "q_keys")}),
)


# ---------------------------------------------------------------------------
# flash_decode — one step over the latent cache (SPAN compiled: one plan)


def _fd_eval(p, plan):
    dt = _dtype(p)
    b, h, kv, l, d, rk, rv = (p[k] for k in ("b", "h", "kv", "l", "d", "rk",
                                             "rv"))
    q = _rand((b, h, d), 9, dt)
    lk = _rand((b, l, rk), 10, dt)
    lv = _rand((b, l, rv), 11, dt)
    uk = _rand((rk, kv * d), 12, scale=1 / math.sqrt(rk))
    uv = _rand((rv, kv * d), 13, scale=1 / math.sqrt(rv))
    lengths = torch.tensor([max(1, l - 97 * i) for i in range(b)],
                           dtype=torch.int32)
    half = d // 2
    pos = torch.arange(l, dtype=torch.float64)[:, None]
    freq = 10000.0 ** (-torch.arange(half, dtype=torch.float64) / half)
    cos, sin = torch.cos(pos * freq).float(), torch.sin(pos * freq).float()
    out = _fd.emulate(plan, q, lk, lv, uk, uv, lengths, cos, sin)
    want = ref.flash_decode_ref(q, lk, lv, uk, uv, lengths, cos, sin)
    return (out,), _ratio((out,), (want,), "flash_decode", p)


_DECODE = KernelContract(
    name="flash_decode",
    align=lambda plan: ({"rk": _fd.RANK_MULTIPLE}
                        if plan.body == "wgmma" else {}),
    probes=_both(
        {"b": 2, "h": 8, "kv": 2, "l": 1024, "d": 64, "rk": 128, "rv": 128},
        *({"b": 2, "h": 4, "kv": 2, "l": 300, "d": d, "rk": 24, "rv": 40}
          for d in (8, 20, 96, 112)),
    ),
    candidates=lambda p: autotune.flash_decode_candidates(
        p["b"], p["l"], p["h"], p["kv"], p["d"], p["rk"], p["rv"],
        _dtype(p)),
    evaluate=_fd_eval,
    expected=lambda p, plan: ((p["b"], p["h"], p["d"]),),
    exact=lambda plan: {"span": _fd.SPAN},
    # the JAX package's ragged probe: D 80 has no decode body (RoPE pairs
    # the true dims, so it is never padded)
    refused=_both({"b": 1, "h": 4, "kv": 4, "l": 300, "d": 80, "rk": 24,
                   "rv": 40}),
)


# ---------------------------------------------------------------------------
# grouped_matmul — ragged expert GEMM over rows sorted by expert


def _gm_sizes(p):
    m, e = p["m"], p["e"]
    sizes = [m // e] * e
    sizes[0] += m - sum(sizes)
    return torch.tensor(sizes, dtype=torch.int32)


def _gm_eval(p, plan):
    # the emulation does not read ``ctas`` (each count computes the same
    # tiles, bit for bit): candidates that differ only there share one run
    return _gm_eval_once(tuple(sorted(p.items())),
                         dataclasses.replace(plan, ctas=0))


@functools.lru_cache(maxsize=64)
def _gm_eval_once(items, plan):
    p = dict(items)
    dt = _dtype(p)
    x = _rand((p["m"], plan.d), 14, dt)
    # one expert's bank repeated over E, as a view: the deepseek-shaped
    # probe's (64, 2048, 1408) bank would take 740 MB; the bf16 values are
    # handed over in fp32, which the emulation reads alike
    w = _rand((1, plan.d, plan.f), 15, dt, 1 / math.sqrt(plan.d)).float()
    w = w.expand(p["e"], plan.d, plan.f)
    sizes = _gm_sizes(p)
    y = _gm.emulate(plan, x, w, sizes.tolist())
    want = ref.grouped_matmul_ref(x, w, sizes).to(dt)
    return (y,), _ratio((y,), (want,), "grouped_matmul", p)


_GROUPED = KernelContract(
    name="grouped_matmul",
    align=lambda plan: {"d": _gm.MULTIPLE, "f": _gm.MULTIPLE},
    probes=_both(
        {"m": 4096, "d": 2048, "f": 1408, "e": 64},   # deepseek-shaped
        {"m": 37, "d": 80, "f": 96, "e": 8},          # ragged everything
        {"m": 8, "d": 128, "f": 128, "e": 256},       # more experts than
        # rows: most groups empty
    ),
    candidates=lambda p: autotune.grouped_candidates(
        p["m"], p["d"], p["f"], p["e"], _dtype(p)),
    evaluate=_gm_eval,
    expected=lambda p, plan: ((p["m"], plan.n),),
    exact=lambda plan: ({"bm": _gm.WG_BM, "bn": _gm.WG_BN}
                        if plan.body == "wgmma"
                        else {"bm": _gm.F32_TILE, "bn": _gm.F32_TILE}),
)


CONTRACTS: Dict[str, KernelContract] = {
    c.name: c for c in (_COV, _LOWRANK, _FLASH, _FLASH_BWD, _DECODE,
                        _GROUPED)
}
