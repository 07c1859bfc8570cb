"""Launch-plan autotuner: measure-and-cache over a per-kernel lattice.

Counterpart of ``src/repro/kernels/autotune.py``.  Every wrapper in
``kernels.ops`` asks this module for its launch plan.  The plan each kernel
module's ``plan()`` gives is the *anchor*: the heuristic, which the tuner
returns unchanged on the CPU and under ``REPRO_AUTOTUNE=heuristic``, so
those runs launch exactly what the hand-written ``plan()`` picks.  Around
the anchor each kernel has a small *lattice* of plans that differ only in
fields its launcher takes at run time (``kernels/build.py`` signatures):
nothing new is compiled.

* ``cov_accum`` (and its bank axis): the split of T into slices of whole
  ``STEP``s (``splits`` / ``rows_per_split``); changes the summation order.
* ``lowrank_matmul``: each product's depth split, tuned per product (x @ V
  keyed on (T, n, k), t @ U on (T, k, m), so ``lowrank_down`` and
  ``lowrank_up`` round as ``lowrank_matmul`` does).  ``small_t``: up to
  ``SMALL_MAX_SPLITS`` slices (changes the order); ``wgmma``: unsplit or
  one ``WG_SLICE`` slice a block, the same bits either way.
* ``flash_attention``: the split bodies' key ``span`` (multiples of
  ``bkey``; ``split_mma`` at least ``MMA_MIN_TILES`` tiles); changes the
  merge order.  The tile bodies' ``bq`` / ``bkey`` are compiled per head
  dim: a lattice of one.
* ``flash_attention_bwd``: its tiles are compiled per (dtype, head dim): a
  lattice of one.
* ``flash_decode``: ``SPAN`` is compiled into ``csrc/flash_decode.cu`` (its
  launcher refuses any other span): a lattice of one.
* ``grouped_matmul``: the wgmma body's persistent ``ctas``, the same bits
  at any count.

Candidates are filtered by the shared-memory budget
(``REPRO_AUTOTUNE_SMEM_BYTES``, default 232448: one block's limit on the
H100) and by *waste*: the modeled fp32 partials a split writes and reads
back, over the bytes the call must move (inputs read once, outputs written
once).  A candidate may waste at most ``MAX_WASTE`` or the anchor's own.
Under ``ops.batch_invariant`` only the knobs that leave the bits unchanged
are offered, so chunked prefill keeps the bits of whole prefill; fp32 calls
(the dtype held to the CPU) keep the heuristic for every order-changing
knob (``ORDER_TUNED``).

Modes (``REPRO_AUTOTUNE`` overrides the call site's): ``auto`` measures
when the operands lie on a CUDA device and takes the heuristic elsewhere;
``measure`` times the top ``REPRO_AUTOTUNE_MAX_CANDIDATES`` (default 8)
candidates by preference (the anchor first, then the nearest to it) with
CUDA events on the current stream — one warm-up, then the median of 3
samples of up to 16 launches (~200 µs of kernel time), each launch between
its own events after a 128 MB read that evicts the L2, as a decode step
finds its weights, the host a sample ahead of the card — on the caller's
inputs (read only) and outputs of its own, and keeps the fastest;
``heuristic`` returns the anchor.  A lattice of one is never measured.
Measuring on the CPU raises unless a timer is injected (``set_timer``, for
tests).  A candidate that fails to launch raises: the contract
(``kernels.contracts``) should have refused it.  While the current stream
captures a CUDA graph the tuner only reads its caches; a miss raises.

Measured picks persist to a JSON file (``REPRO_AUTOTUNE_CACHE``, default
``~/.cache/aa-svd/autotune_torch.json``, written by temp file and rename)
under the key

    <kernel>|v<CACHE_VERSION>-<source hash>|cuda:<device name>|<sig>

where the source hash is the first 12 hex digits of ``build.source_hash()``
(an edited kernel invalidates its old picks) and ``sig`` holds only what
the plan depends on.  ``reset()`` drops the in-memory state,
``clear_disk_cache()`` the file.
"""

from __future__ import annotations

import repro_torch._fp32  # noqa: F401  (TF32 off before any torch work)
import dataclasses
import functools
import json
import math
import os
import statistics
import tempfile
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels import cov_accum as _cov
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import grouped_matmul as _gm
from repro_torch.kernels import lowrank_matmul as _low

CACHE_VERSION = 1

# the heuristic: each kernel's hand-written plan(), the lattice's anchor
_ANCHORS: Dict[str, Callable] = {
    "cov_accum": _cov.plan,
    "lowrank_matmul": _low.plan,
    "flash_attention": _fa.plan,
    "flash_attention_bwd": _fa.plan_backward,
    "flash_decode": _fd.plan,
    "grouped_matmul": _gm.plan,
}

# the knobs each lattice varies and the values it offers (each filtered by
# the launcher's rules, the budget and the waste bound; the anchor's own
# value always joins); empty: a lattice of one
_LATTICES: Dict[str, Dict[str, Tuple]] = {
    "cov_accum": {"splits": (1, 2, 3, 4, 6, 8, 12, 16)},
    "lowrank_matmul": {"small_t.splits": (1, 2, 4, 8, _low.SMALL_MAX_SPLITS),
                       "wgmma.splits": ("unsplit", "a slice a block")},
    "flash_attention": {"span": (0.25, 0.5, 1, 2, 4)},   # x the anchor's
    "flash_attention_bwd": {},
    "flash_decode": {},
    "grouped_matmul": {"ctas": (_gm.SMS // 4, _gm.SMS // 2,
                                3 * _gm.SMS // 4, _gm.SMS)},
}

# the dtypes whose order-changing knobs (cov_accum's T slices, small_t's
# splits, the split attention spans) are tuned.  fp32 keeps the heuristic:
# it is the dtype that runs held to the CPU (smoke parity, the zoo), where
# the solves amplify a changed summation order unit by unit (ROADMAP hazard
# 3j): a measured T split moved a deepseek smoke map past its 1e-3 limit.
ORDER_TUNED = (torch.bfloat16,)
MAX_WASTE = 1.0
# cov_accum: a split is offered only while the work items fit this many
# waves (past it every SM is busy without one)
COV_MAX_WAVES = 4
# flash_attention's merge stages 2·spans + 2 floats in default shared memory
MAX_SPANS = 4096
GRID = (2 ** 31 - 1, 65535, 65535)
SMEM_BYTES = 232448      # one block's shared memory on the H100
SAMPLE_US = 200.0        # a timed sample's launches, in µs of kernel time
MAX_REPS = 16
FLUSH_BYTES = 128 << 20  # a read this large evicts the H100's 50 MB L2
AHEAD_CYCLES = 200_000   # ~100 µs of the card a timed launch, for the host


class TuneResult(NamedTuple):
    """One decision: the plan to launch, where it came from (``heuristic``
    | ``measured`` | ``cache``) and the measured median µs a call (None
    when nothing was measured)."""

    plan: object
    source: str
    us: Optional[float]


class Candidate(NamedTuple):
    plan: object
    smem_bytes: int
    waste: float


class _Pick(NamedTuple):
    """A kept pick: its knobs (applied to each call's candidates), where it
    came from and its µs."""

    knobs: dict
    source: str
    us: Optional[float]


# ---------------------------------------------------------------------------
# knobs (env-overridable so tests and chip_smoke.py can pin them)


def _smem_budget() -> int:
    return int(os.environ.get("REPRO_AUTOTUNE_SMEM_BYTES", SMEM_BYTES))


def _max_measured() -> int:
    return int(os.environ.get("REPRO_AUTOTUNE_MAX_CANDIDATES", 8))


def _cache_path() -> str:
    return os.environ.get(
        "REPRO_AUTOTUNE_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "aa-svd",
                     "autotune_torch.json"))


MODES = ("auto", "measure", "heuristic", "off")


def _mode(mode: str, device) -> str:
    """Resolve ``auto``: measure for operands on a CUDA device, heuristic
    elsewhere.  ``REPRO_AUTOTUNE`` overrides every call site's mode;
    ``off`` is the heuristic."""
    mode = os.environ.get("REPRO_AUTOTUNE", mode)
    if mode not in MODES:
        raise ValueError(f"autotune: mode {mode!r} not one of {MODES}")
    if mode == "off":
        return "heuristic"
    if mode != "auto":
        return mode
    return ("measure" if torch.device(device or "cpu").type == "cuda"
            else "heuristic")


# ---------------------------------------------------------------------------
# caches and counters


_MEM: Dict[str, _Pick] = {}
# every call's result by its exact arguments: the launch path's lookup
_FAST: Dict[tuple, TuneResult] = {}
_DISK: Optional[Dict[str, dict]] = None
_TIMER: Optional[Callable] = None
_MEASURING = False
# measurements made (signatures timed), candidates timed, and their seconds
STATS: Dict[str, float] = {"measurements": 0, "candidates": 0,
                           "seconds": 0.0}


def reset(disk: bool = False) -> None:
    """Drop the in-memory picks (and the counters); ``disk=True`` also
    deletes the cache file."""
    global _DISK
    _MEM.clear()
    _FAST.clear()
    _DISK = None
    for key in STATS:
        STATS[key] = 0
    if disk:
        clear_disk_cache()


def clear_disk_cache() -> None:
    global _DISK
    _DISK = None
    try:
        os.remove(_cache_path())
    except OSError:
        pass


def measuring() -> bool:
    """Whether a measurement is launching candidates now (its launches are
    not the calling wrapper's)."""
    return _MEASURING


def set_timer(timer: Optional[Callable]) -> None:
    """Time candidates with ``timer(run, plan) -> µs`` instead of CUDA
    events (None restores them); with one set, measure mode also runs on
    CPU operands."""
    global _TIMER
    _TIMER = timer


def _disk() -> Dict[str, dict]:
    global _DISK
    if _DISK is None:
        try:
            with open(_cache_path()) as f:
                _DISK = json.load(f)
        except (OSError, ValueError):
            _DISK = {}
    return _DISK


def _disk_put(key: str, entry: dict) -> None:
    """Merge one measured entry into the cache file (temp file, then an
    atomic rename: concurrent processes lose at worst a re-measurement)."""
    global _DISK
    path = _cache_path()
    folder = os.path.dirname(path) or "."
    os.makedirs(folder, exist_ok=True)
    merged = dict(_disk())
    merged[key] = entry
    fd, tmp = tempfile.mkstemp(dir=folder, prefix=".autotune-")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(merged, f, indent=0, sort_keys=True)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    _DISK = merged


@functools.lru_cache(maxsize=1)
def _source_tag() -> str:
    return build.source_hash()[:12]


def _device_sig(device) -> str:
    device = torch.device(device or "cpu")
    if device.type == "cuda":
        name = torch.cuda.get_device_name(device).replace(" ", "_")
        return f"cuda:{name}"
    return f"{device.type}:{device.type}"


def _key(kernel: str, sig: str, device) -> str:
    return (f"{kernel}|v{CACHE_VERSION}-{_source_tag()}|"
            f"{_device_sig(device)}|{sig}")


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


# ---------------------------------------------------------------------------
# shared memory of a plan's largest block (mirrors the .cu constants)


def _flash_smem(p) -> int:
    d = p.d
    if p.body == "split_mma":
        return _fa.mma_smem(d)
    eb = p.dtype.itemsize
    if p.body == "split":
        # fs::Cfg<T, D>::smem(g): K / V double-buffered tiles, q, scores
        vec = 16 // eb
        bk = _fa.split_keys(p.dtype, d)
        return eb * 4 * bk * (d + vec) + 4 * (p.group * d + p.group * bk
                                              + 3 * p.group)
    if p.body == "wgmma":
        # fw::Cfg<D>::SMEM: Q's boxes, two stages of K and V, barriers
        dc = -(-d // 64)
        bkey = _fa.WG_BKEY[d]
        bars = (4 if d == 64 else 2) * 2 + 1
        return 1024 + dc * _fa.WG_BQ * 128 + 2 * 2 * dc * bkey * 128 + 8 * bars
    # ft::Layout<T, D>::bytes (fma32 / wmma)
    bq, bkey = _fa.TILE_BQ, _fa.tile_bkey(d)
    ld = d + (8 if eb == 2 else 4)
    p_bytes = 0 if eb == 4 else eb * bq * (bkey + 8)
    return (eb * bq * ld + 2 * eb * bkey * ld + 4 * bq * (bkey + 4) + p_bytes
            + 4 * bq * (d + 4) + 2 * 4 * bq)


def _flash_bwd_smem(p) -> int:
    """The larger pass's block (``csrc/flash_attention_bwd.cu``)."""
    if p.body == "wgmma":
        # bw::Cfg<D>: dK/dV: K and V (64 keys), two stages of Q and dO
        # (kv_rows each) with their LSE and Δ; dQ: Q and dO (128 rows), two
        # stages of K and V (q_keys each); 1024 of alignment, barriers (the
        # dK/dV block's rounded to 16 bytes, then its dead rows' D fp32 sums)
        box = 128 * (-(-p.d // 64))
        kvp = (2 * p.kv_keys * box + 2 * (2 * p.kv_rows * box
                                          + 2 * 4 * p.kv_rows) + 48 + 4 * p.d)
        qp = 2 * p.q_rows * box + 2 * 2 * p.q_keys * box + 8 * 5
        return 1024 + max(kvp, qp)
    # bt::Lay<D>: four fp32 tiles of 32 rows at a pitch of D + 1, two
    # 32 x 33 score tiles, the LSE and Δ of 32 rows
    t = _fa.BWD_TILE
    return 4 * (4 * t * (p.d + 1) + 2 * t * (t + 1) + 2 * t)


def smem_bytes(kernel: str, p) -> int:
    """Shared bytes of one block of plan ``p`` (the body's ``SMEM`` in
    ``csrc/<kernel>.cu``, or the plan module's own model)."""
    if kernel == "cov_accum":
        # cw::SMEM (ring of 4 stages of 4 atoms, the staged tile, barriers);
        # cov_fma: two static (16, 64) fp32 tiles
        return (1024 + 4 * 4 * 8192 + 128 * 129 * 4 + 64
                if p.dtype == torch.bfloat16 else 2 * 16 * 64 * 4)
    if kernel == "lowrank_matmul":
        if p.body == "small_t":   # skinny Ring<...>::SMEM
            return (1024 + 4 * 16384 + 36 * 1024 + 64
                    if p.align[0] == 8
                    else 1024 + 6 * 8192 + 36 * 1024 + 96)
        if p.body == "wgmma":     # wg::SMEM
            return 4 * 32768 + 1024 + 64
        return (16 * 68 + 16 * 64) * 4
    if kernel == "flash_attention":
        return _flash_smem(p)
    if kernel == "flash_attention_bwd":
        return _flash_bwd_smem(p)
    if kernel == "flash_decode":
        return p.smem
    if kernel == "grouped_matmul":
        if p.body == "wgmma":     # gw::SMEM
            return (1024 + 4 * 32768 + 128 * 136 * 2 + 64
                    + 2 * (_gm.MAX_EXPERTS + 1) * 4)
        return (16 * 68 + 16 * 64) * 4 + (_gm.MAX_EXPERTS + 1) * 4
    raise KeyError(kernel)


def grid(kernel: str, p) -> Tuple[int, int, int]:
    """The grid of plan ``p``'s largest launch, as its launcher forms it."""
    if kernel == "cov_accum":
        if p.dtype == torch.bfloat16:
            return (min(p.items, _cov.SMS), 1, 1)
        return (p.tiles, p.splits, p.banks)
    if kernel == "lowrank_matmul":
        dims = [p.grid("tu")] + ([p.grid("xv")] if p.n else [])
        return tuple(max(g[i] for g in dims) for i in range(3))
    if kernel == "flash_attention":
        if p.body in _fa.SPLIT_BODIES:
            return (p.spans, p.b * p.kv, 1)
        if p.body == "wgmma":
            return (p.grid, 1, 1)
        return (p.q_blocks, p.b * p.h, 1)
    if kernel == "flash_attention_bwd":
        # the larger of its two launches, each (tiles, B·heads)
        return (max(p.kv_grid[0], p.q_grid[0]),
                max(p.kv_grid[1], p.q_grid[1]), 1)
    if kernel == "flash_decode":
        return (p.grid, 1, 1)
    if kernel == "grouped_matmul":
        if p.body == "wgmma":
            return (p.ctas, 1, 1)
        return (p.col_tiles, -(-p.rows // p.bm), 1)
    raise KeyError(kernel)


# ---------------------------------------------------------------------------
# lattices: each returns the candidates sorted by preference, anchor first


def _sorted(cands: List[Candidate], anchor, dist: Callable) -> List[Candidate]:
    """Budget and waste filters, then the anchor first and the rest by
    distance from it (a stable, total order).  A candidate may waste at most
    max(MAX_WASTE, the anchor's waste); if the budget leaves nothing, the
    smallest-footprint candidate survives."""
    seen, uniq = set(), []
    for c in cands:
        if c.plan not in seen:
            seen.add(c.plan)
            uniq.append(c)
    base = next(c for c in uniq if c.plan == anchor)
    keep = [c for c in uniq
            if c.waste <= max(MAX_WASTE, base.waste) + 1e-9]
    fit = [c for c in keep if c.smem_bytes <= _smem_budget()]
    if not fit:
        fit = [min(keep, key=lambda c: (c.smem_bytes, c.plan != anchor))]
    return sorted(fit, key=lambda c: (c.plan != anchor, dist(c.plan),
                                      repr(c.plan)))


def _log_dist(a: int, b: int) -> float:
    return abs(math.log2(max(a, 1)) - math.log2(max(b, 1)))


def _cov_waste(p) -> float:
    """The split's fp32 partials (written, then read back) over the bytes
    the call must move: both inputs once, the three accumulators once."""
    eb = p.dtype.itemsize
    rows = -(-p.rows // p.step) * p.step
    moved = p.banks * (2 * rows * p.n * eb + 3 * p.n * p.n * 4)
    return 2 * 4 * p.scratch_floats / moved


def cov_candidates(rows: int, n: int, dtype, banks: int = 1, *,
                   invariant: bool = False) -> List[Candidate]:
    """``cov_accum``'s lattice: T cut into s slices of whole ``STEP``s,
    each at least ``MIN_STEPS`` of them, while the work items (banks x
    slices x tiles) fit ``COV_MAX_WAVES`` waves and the launcher takes
    them (tiles <= 65535 when split).  Splits change the summation order:
    under ``invariant`` and in fp32 only the anchor."""
    anchor = _cov.plan(rows, n, dtype, banks)
    steps = -(-rows // anchor.step)
    work = banks * anchor.tiles
    plans = [anchor]
    if not invariant and dtype in ORDER_TUNED:
        for s in _LATTICES["cov_accum"]["splits"]:
            if s == 1:
                plans.append(dataclasses.replace(anchor, splits=1,
                                                 rows_per_split=rows))
                continue
            if (steps < s * _cov.MIN_STEPS[dtype]
                    or work * s > COV_MAX_WAVES * _cov.WAVE[dtype]
                    or anchor.tiles > 65535):
                continue
            per = -(-steps // s) * anchor.step
            plans.append(dataclasses.replace(
                anchor, splits=-(-rows // per), rows_per_split=per))
    cands = [Candidate(p, smem_bytes("cov_accum", p), _cov_waste(p))
             for p in plans]
    return _sorted(cands, anchor,
                   lambda p: _log_dist(p.splits, anchor.splits))


def _lowrank_split(p, product: str, splits: int, depth: int):
    if product == "xv":
        return dataclasses.replace(p, splits_xv=splits, depth_xv=depth)
    return dataclasses.replace(p, splits_tu=splits, depth_tu=depth)


def _lowrank_waste(p, product: str, eb: int) -> float:
    """One product's split partials (written and read back) over the bytes
    the product must move: its input, its factor and its output."""
    if product == "xv":
        moved = (p.rows * p.n + p.n * p.k + p.rows * p.k) * eb
        part = p.splits_xv * p.rows * p.k if p.splits_xv > 1 else 0
    else:
        moved = (p.rows * p.k + p.k * p.m + p.rows * p.m) * eb
        part = p.splits_tu * p.rows * p.m if p.splits_tu > 1 else 0
    return 2 * 4 * part / max(moved, 1)


def lowrank_candidates(rows: int, n: int, k: int, m: int, dtype, *,
                       product: str, body: Optional[str] = None,
                       invariant: bool = False) -> List[Candidate]:
    """One product's lattice (``product`` "xv": x @ V, depth n; "tu":
    t @ U, depth k), the other product as the anchor has it.  ``small_t``:
    the depth cut into at most s slices of whole ring stages, s in
    ``_LATTICES`` (order-changing: not under ``invariant`` nor in fp32);
    ``wgmma``: unsplit, or one ``WG_SLICE`` slice a block (the same bits);
    ``fma32``: unsplit alone."""
    if invariant and body is None:
        body = _low.LARGE_T_BODY[dtype]
    anchor = _low.plan(rows, n, k, m, dtype, body=body)
    depth, cols = (anchor.n, anchor.k) if product == "xv" else \
        (anchor.k, anchor.m)
    plans = [anchor]
    if depth > 0 and cols > 0:
        if (anchor.body == "small_t" and not invariant
                and dtype in ORDER_TUNED):
            for s in _LATTICES["lowrank_matmul"]["small_t.splits"]:
                splits, per = _low._slices(depth, s,
                                           _low.SMALL_STAGE[dtype])
                plans.append(_lowrank_split(anchor, product, splits, per))
        elif anchor.body == "wgmma":
            plans.append(_lowrank_split(anchor, product, 1, depth))
            slices = -(-depth // _low.WG_SLICE)
            if slices > 1:
                plans.append(_lowrank_split(anchor, product, slices,
                                            _low.WG_SLICE))

    def splits(p):
        return p.splits_xv if product == "xv" else p.splits_tu

    cands = [Candidate(p, smem_bytes("lowrank_matmul", p),
                       _lowrank_waste(p, product, dtype.itemsize))
             for p in plans]
    return _sorted(cands, anchor,
                   lambda p: _log_dist(splits(p), splits(anchor)))


def flash_candidates(b: int, lq: int, lk: int, h: int, kv: int, d: int,
                     dtype, *, causal: bool = True, window: int = 0,
                     invariant: bool = False) -> List[Candidate]:
    """``flash_attention``'s lattice: for the split bodies the anchor's key
    span times each factor of ``_LATTICES``, rounded up to whole tiles, at
    least one tile (``split_mma``: ``MMA_MIN_TILES``), at most the keys'
    tiles; it changes the merge order (none is offered in fp32, nor under
    ``invariant``, where Lq 1 takes a tile body anyway).  The tile bodies'
    bq and bkey are compiled per head dim: a lattice of one."""
    anchor = _fa.plan(b, lq, lk, h, kv, d, dtype, causal=causal,
                      window=window, invariant=invariant)
    plans = [anchor]
    if (anchor.body in _fa.SPLIT_BODIES and not invariant
            and dtype in ORDER_TUNED):
        bk = anchor.bkey
        least = _fa.MMA_MIN_TILES * bk if anchor.body == "split_mma" else bk
        most = max(least, -(-lk // bk) * bk)
        for f in _LATTICES["flash_attention"]["span"]:
            span = min(most, max(least, -(-int(anchor.span * f) // bk) * bk))
            spans = -(-lk // span)
            if spans <= MAX_SPANS:
                plans.append(dataclasses.replace(anchor, span=span,
                                                 spans=spans))

    def waste(p):
        eb = dtype.itemsize
        moved = (2 * b * lq * h * d + 2 * b * lk * kv * d) * eb
        return 2 * 4 * p.scratch_floats / moved

    cands = [Candidate(p, smem_bytes("flash_attention", p), waste(p))
             for p in plans]
    return _sorted(cands, anchor,
                   lambda p: _log_dist(p.span, anchor.span))


def flash_bwd_candidates(b: int, lq: int, lk: int, h: int, kv: int, d: int,
                         dtype, *, causal: bool = True,
                         window: int = 0) -> List[Candidate]:
    """``flash_attention_bwd``'s lattice: its anchor alone (its tiles are
    compiled per dtype and head dim; no run-time knob)."""
    p = _fa.plan_backward(b, lq, lk, h, kv, d, dtype, causal=causal,
                          window=window)
    return [Candidate(p, smem_bytes("flash_attention_bwd", p), 0.0)]


def flash_decode_candidates(b: int, l: int, h: int, kv: int, d: int, rk: int,
                            rv: int, dtype) -> List[Candidate]:
    """``flash_decode``'s lattice: its anchor alone.  The span (``SPAN``,
    256 keys) is a constant of ``csrc/flash_decode.cu``: its keys bodies'
    score arrays are sized by it and the launcher refuses any other."""
    p = _fd.plan(b, l, h, kv, d, rk, rv, dtype)
    return [Candidate(p, smem_bytes("flash_decode", p), 0.0)]


def grouped_candidates(rows: int, d: int, f: int, experts: int, dtype,
                       trans: bool = False) -> List[Candidate]:
    """``grouped_matmul``'s lattice: the wgmma body's persistent blocks,
    the values of ``_LATTICES`` at most the items a call can have (the
    launcher's bound); every count gives the same bits.  The fp32 body
    launches a block a tile: a lattice of one."""
    anchor = _gm.plan(rows, d, f, experts, dtype, trans)
    plans = [anchor]
    if anchor.body == "wgmma":
        most = anchor.most_row_tiles * anchor.col_tiles
        plans += [dataclasses.replace(anchor, ctas=min(c, most))
                  for c in _LATTICES["grouped_matmul"]["ctas"]]
    cands = [Candidate(p, smem_bytes("grouped_matmul", p), 0.0)
             for p in plans]
    return _sorted(cands, anchor, lambda p: _log_dist(p.ctas, anchor.ctas))


# ---------------------------------------------------------------------------
# measurement


def _cuda_time(run: Callable, plan, *, flush) -> float:
    """Median µs of one launch of ``plan`` with the L2 cold: a warm-up,
    one launch to size a sample, then 3 samples of ``reps`` launches, each
    after a read of ``flush`` (twice the L2) and between its own CUDA
    events on the current stream, so the time is the launch's alone.  A
    spin kernel of ``AHEAD_CYCLES`` a launch opens each sample: the host
    enqueues the whole sample while it runs, so no launch waits on the
    host's launch work (tensor-map encodes, the launcher's checks)."""
    def sample(reps):
        torch.cuda._sleep(AHEAD_CYCLES * reps)
        pairs = []
        for _ in range(reps):
            flush.sum()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run(plan)
            end.record()
            pairs.append((start, end))
        pairs[-1][1].synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs) * 1e3 / reps

    run(plan)
    one = max(sample(1), 1e-3)
    reps = max(1, min(MAX_REPS, math.ceil(SAMPLE_US / one)))
    return statistics.median(sample(reps) for _ in range(3))


def _measure(cands: Sequence[Candidate], bench: Callable) -> Tuple[object,
                                                                    float]:
    """Time the top candidates by preference and return (fastest plan, its
    µs).  ``bench()`` makes ``run(plan)``, which launches one candidate on
    the caller's inputs into outputs of its own; it is dropped after, so
    what it allocated is freed.  Nothing is caught: a candidate that fails
    is a contract error."""
    global _MEASURING
    top = list(cands)[:_max_measured()]
    t0 = time.perf_counter()
    _MEASURING = True
    try:
        timer = _TIMER
        if timer is None:
            flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32,
                                device="cuda")
            timer = functools.partial(_cuda_time, flush=flush)
        run = bench()
        times = [(timer(run, c.plan), i) for i, c in enumerate(top)]
        del run, timer
        if _TIMER is None:
            torch.cuda.synchronize()
    finally:
        _MEASURING = False
    STATS["measurements"] += 1
    STATS["candidates"] += len(top)
    STATS["seconds"] += time.perf_counter() - t0
    us, i = min(times)
    return top[i].plan, us


def _fast(args: tuple, mode: str, device, make: Callable) -> TuneResult:
    """The result of ``make(resolved mode)`` for these exact arguments,
    made once: a launch after the first costs one dict lookup."""
    resolved = _mode(mode, device)
    key = (args, resolved, str(device))
    hit = _FAST.get(key)
    if hit is None:
        hit = _FAST[key] = make(resolved)
    return hit


def _pick(cands: Sequence[Candidate], knobs: Callable, want: dict):
    return next((c.plan for c in cands if knobs(c.plan) == want), None)


def _tune(kernel: str, sig: str, cands: Sequence[Candidate],
          knobs: Callable, bench: Optional[Callable], resolved: str,
          device) -> TuneResult:
    """The pick for one signature: the anchor (``cands[0]``) in heuristic
    mode or for a lattice of one; else the in-memory pick, the disk
    cache's, or a measurement.  A pick is kept as its knobs and applied to
    this call's candidates (one signature may cover several row counts of
    one structure); knobs that name no current candidate are a miss."""
    if resolved == "heuristic" or len(cands) == 1:
        return TuneResult(cands[0].plan, "heuristic", None)
    key = _key(kernel, sig, device)
    hit = _MEM.get(key)
    if hit is not None:
        plan = _pick(cands, knobs, hit.knobs)
        if plan is not None:
            return TuneResult(plan, hit.source, hit.us)
    entry = _disk().get(key)
    if entry is not None:
        plan = _pick(cands, knobs, entry["knobs"])
        if plan is not None:
            _MEM[key] = _Pick(entry["knobs"], "cache", entry.get("us"))
            return TuneResult(plan, "cache", entry.get("us"))
    on_cuda = torch.device(device or "cpu").type == "cuda"
    if on_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"autotune: {key} is not tuned yet and the "
                           "current stream is capturing a CUDA graph: call "
                           "it once before capture")
    if _TIMER is None and not on_cuda:
        raise RuntimeError(f"autotune: measure mode on {device} needs a CUDA "
                           "device (or an injected timer)")
    if bench is None:
        raise RuntimeError(f"autotune: {key} has no launcher to measure")
    plan, us = _measure(cands, bench)
    _MEM[key] = _Pick(knobs(plan), "measured", us)
    _disk_put(key, {"knobs": knobs(plan), "us": us})
    return TuneResult(plan, "measured", us)


# ---------------------------------------------------------------------------
# public per-kernel entry points (called by kernels.ops at each launch)


def cov_plan(rows: int, n: int, dtype, banks: int = 1, *, device=None,
             bench: Optional[Callable] = None, mode: str = "auto",
             invariant: bool = False) -> TuneResult:
    """The plan of ``banks`` (rows, n) covariance triples.  Keyed on T's
    ``STEP``s: row counts of one step count share their slice structure,
    and a pick is kept as (slices, steps a slice)."""
    def make(resolved):
        cands = cov_candidates(rows, n, dtype, banks, invariant=invariant)
        steps = -(-rows // cands[0].plan.step)
        sig = (f"e{banks}-s{steps}-n{n}-{_dtype_name(dtype)}"
               f"-i{int(invariant)}")

        def knobs(p):
            return {"splits": p.splits, "steps": (p.rows_per_split // p.step
                                                  if p.splits > 1 else 0)}

        return _tune("cov_accum", sig, cands, knobs, bench, resolved, device)

    return _fast(("cov", rows, n, dtype, banks, invariant), mode, device,
                 make)


def lowrank_plan(rows: int, n: int, k: int, m: int, dtype, *,
                 body: Optional[str] = None, invariant: bool = False,
                 device=None, bench: Optional[Callable] = None,
                 mode: str = "auto") -> TuneResult:
    """The plan of (rows, n) @ (n, k) @ (k, m) (m 0: x @ V alone; n 0: t @
    U alone): each product tuned on its own signature, x @ V on (T, n, k)
    and t @ U on (T, k, m), and the two picks combined, so a product rounds
    alike whichever wrapper runs it.  ``bench(product)`` makes the
    launcher of the whole call, which times that product's candidates
    (each the anchor but for the product's split).  The source is the most
    recent of the two (measured, then cache, then heuristic); ``us`` their
    sum."""
    if invariant and body is None:
        body = _low.LARGE_T_BODY[dtype]

    def make(resolved):
        anchor = _low.plan(rows, n, k, m, dtype, body=body)
        name = _dtype_name(dtype)
        picks = {}
        for product, (depth, cols) in (("xv", (n, k)), ("tu", (k, m))):
            cands = lowrank_candidates(rows, n, k, m, dtype, product=product,
                                       body=body, invariant=invariant)
            sig = (f"{product}-t{rows}-d{depth}-c{cols}-{name}-{anchor.body}"
                   f"-i{int(invariant)}")

            def knobs(p, product=product):
                return ({"splits": p.splits_xv, "depth": p.depth_xv}
                        if product == "xv" else
                        {"splits": p.splits_tu, "depth": p.depth_tu})

            product_bench = (None if bench is None
                             else functools.partial(bench, product))
            picks[product] = _tune("lowrank_matmul", sig, cands, knobs,
                                   product_bench, resolved, device)
        xv, tu = picks["xv"].plan, picks["tu"].plan
        plan = dataclasses.replace(anchor, splits_xv=xv.splits_xv,
                                   depth_xv=xv.depth_xv,
                                   splits_tu=tu.splits_tu,
                                   depth_tu=tu.depth_tu)
        sources = {r.source for r in picks.values()}
        source = next(s for s in ("measured", "cache", "heuristic")
                      if s in sources)
        us = [r.us for r in picks.values() if r.us is not None]
        return TuneResult(plan, source, sum(us) if us else None)

    return _fast(("lowrank", rows, n, k, m, dtype, body, invariant), mode,
                 device, make)


def flash_plan(b: int, lq: int, lk: int, h: int, kv: int, d: int, dtype, *,
               causal: bool = True, window: int = 0, invariant: bool = False,
               device=None, bench: Optional[Callable] = None,
               mode: str = "auto") -> TuneResult:
    """The plan of one attention call (no per-call offsets: the kernel
    reads them on the device).  Keyed on (B, Lq, Lk, H, KV, D, dtype,
    causal, window); only the split bodies (Lq 1) have a lattice."""
    def make(resolved):
        cands = flash_candidates(b, lq, lk, h, kv, d, dtype, causal=causal,
                                 window=window, invariant=invariant)
        sig = (f"b{b}-lq{lq}-lk{lk}-h{h}-kv{kv}-d{d}-{_dtype_name(dtype)}"
               f"-c{int(causal)}w{window}-i{int(invariant)}")
        return _tune("flash_attention", sig, cands,
                     lambda p: {"span": p.span}, bench, resolved, device)

    return _fast(("flash", b, lq, lk, h, kv, d, dtype, bool(causal),
                  int(window), bool(invariant)), mode, device, make)


def flash_bwd_plan(b: int, lq: int, lk: int, h: int, kv: int, d: int,
                   dtype, *, causal: bool = True, window: int = 0,
                   device=None, mode: str = "auto") -> TuneResult:
    """The plan of one attention backward: a lattice of one, so never
    measured."""
    def make(resolved):
        cands = flash_bwd_candidates(b, lq, lk, h, kv, d, dtype,
                                     causal=causal, window=window)
        sig = (f"b{b}-lq{lq}-lk{lk}-h{h}-kv{kv}-d{d}-{_dtype_name(dtype)}"
               f"-c{int(causal)}w{window}")
        return _tune("flash_attention_bwd", sig, cands, lambda p: {},
                     None, resolved, device)

    return _fast(("flash_bwd", b, lq, lk, h, kv, d, dtype, bool(causal),
                  int(window)), mode, device, make)


def flash_decode_plan(b: int, l: int, h: int, kv: int, d: int, rk: int,
                      rv: int, dtype, *, device=None,
                      bench: Optional[Callable] = None,
                      mode: str = "auto") -> TuneResult:
    """The plan of one latent-cache decode step; ``l`` is the cache's
    capacity, not the live lengths.  A lattice of one (``SPAN`` is
    compiled in), so it is never measured."""
    def make(resolved):
        cands = flash_decode_candidates(b, l, h, kv, d, rk, rv, dtype)
        sig = (f"b{b}-l{l}-h{h}-kv{kv}-d{d}-rk{rk}-rv{rv}"
               f"-{_dtype_name(dtype)}")
        return _tune("flash_decode", sig, cands, lambda p: {"span": p.span},
                     bench, resolved, device)

    return _fast(("decode", b, l, h, kv, d, rk, rv, dtype), mode, device,
                 make)


def grouped_plan(rows: int, d: int, f: int, experts: int, dtype,
                 trans: bool = False, *, device=None,
                 bench: Optional[Callable] = None,
                 mode: str = "auto") -> TuneResult:
    """The plan of one grouped GEMM over ``rows`` routed rows (the group
    sizes stay on the device)."""
    def make(resolved):
        cands = grouped_candidates(rows, d, f, experts, dtype, trans)
        sig = (f"m{rows}-d{d}-f{f}-e{experts}-{_dtype_name(dtype)}"
               f"-t{int(trans)}")
        return _tune("grouped_matmul", sig, cands,
                     lambda p: {"ctas": p.ctas}, bench, resolved, device)

    return _fast(("grouped", rows, d, f, experts, dtype, bool(trans)), mode,
                 device, make)
