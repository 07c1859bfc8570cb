"""The port's launch-plan autotuner (``repro_torch.kernels.autotune``):
the heuristic is each kernel's ``plan()``, candidates stay within their
bounds, measure mode (with an injected timer on the CPU) persists and
replays its picks, and every candidate's emulation agrees with the JAX
package's kernels in interpret mode.  The counterpart of
``tests/test_autotune.py``."""

from __future__ import annotations

import torch_thread_cap  # noqa: F401  (thread caps under pytest-xdist)
import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import autotune, build
from repro_torch.kernels import cov_accum as cov
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import grouped_matmul as gm
from repro_torch.kernels import lowrank_matmul as low
from repro_torch.kernels import ops, ref

SRC = str(pathlib.Path(__file__).resolve().parents[1] / "src")
F32, BF16 = torch.float32, torch.bfloat16


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    """Each test gets fresh in-memory state, no timer and its own cache."""
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "tune.json"))
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    autotune.reset()
    autotune.set_timer(None)
    yield
    autotune.set_timer(None)
    autotune.reset()


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# the shapes the plan tests plan (tests/test_torch_*_plan.py)
COV = [(1000, 64, F32, 1), (128, 64, F32, 1), (130, 100, BF16, 3),
       (384, 2048, BF16, 1), (40, 64, F32, 8), (4096, 11008, BF16, 1),
       (4096, 4096, BF16, 1), (4096, 512, BF16, 1), (4096, 512, F32, 1),
       (480, 1408, BF16, 64), (480, 2048, BF16, 64), (77, 200, BF16, 1),
       (4096, 256, BF16, 1), (1280, 7168, BF16, 32)]
LOW = [(10, 48, 12, 0, F32, None), (129, 64, 19, 160, BF16, None),
       (129, 64, 19, 160, F32, None), (8, 64, 19, 160, BF16, None),
       (8, 64, 19, 160, F32, None), (8, 4096, 1232, 4096, BF16, None),
       (256, 4096, 1232, 4096, BF16, None),
       (4096, 4096, 1232, 4096, BF16, None),
       (16, 0, 96, 256, BF16, "small_t"), (77, 2048, 96, 0, BF16, "wgmma"),
       (5, 300, 150, 50, F32, None), (8, 2048, 96, 256, BF16, "wgmma")]
FLASH = [(8, 1, 2048, 32, 32, 128, BF16), (8, 1, 2048, 4, 1, 256, BF16),
         (1, 1024, 1024, 32, 32, 128, BF16), (2, 64, 64, 4, 2, 16, F32),
         (8, 1, 2048, 64, 8, 112, BF16), (2, 1, 150, 4, 2, 64, F32),
         (2, 1, 150, 4, 4, 16, BF16)]
DECODE = [(1, 1, 1, 1, 32, 1, 1, F32), (1, 64, 64, 8, 112, 480, 480, BF16),
          (2, 300, 4, 2, 128, 16, 16, BF16), (2, 300, 4, 2, 128, 16, 16, F32),
          (3, 300, 2, 2, 64, 16, 16, BF16), (3, 77, 16, 2, 112, 19, 24, BF16),
          (8, 2048, 32, 32, 128, 1232, 1232, BF16)]
GROUPED = [(150, 32, 16, 4, F32, False), (150, 32, 16, 4, BF16, False),
           (24576, 2048, 504, 64, BF16, False),
           (24576, 2048, 504, 64, BF16, True), (33, 77, 200, 9, F32, False),
           (4133, 200, 77, 9, F32, False), (48, 2048, 1408, 64, BF16, False),
           (48, 2048, 504, 64, BF16, True), (5, 8, 8, 2, BF16, False)]


def _heuristic_pairs(device):
    """(tuned plan, parent plan) for every shape above, as the wrappers ask
    (``invariant`` as ``ops.batch_invariant`` sets it)."""
    for rows, n, dt, banks in COV:
        yield (autotune.cov_plan(rows, n, dt, banks, device=device).plan,
               cov.plan(rows, n, dt, banks))
    for rows, n, k, m, dt, body in LOW:
        for inv in (False, True):
            want_body = low.LARGE_T_BODY[dt] if inv and body is None else body
            yield (autotune.lowrank_plan(rows, n, k, m, dt, body=body,
                                         invariant=inv, device=device).plan,
                   low.plan(rows, n, k, m, dt, body=want_body))
    for b, lq, lk, h, kv, d, dt in FLASH:
        for inv in (False, True):
            yield (autotune.flash_plan(b, lq, lk, h, kv, d, dt, window=0,
                                       invariant=inv, device=device).plan,
                   fa.plan(b, lq, lk, h, kv, d, dt, invariant=inv))
    for shape in DECODE:
        yield (autotune.flash_decode_plan(*shape, device=device).plan,
               fd.plan(*shape))
    for rows, d, f, e, dt, trans in GROUPED:
        yield (autotune.grouped_plan(rows, d, f, e, dt, trans,
                                     device=device).plan,
               gm.plan(rows, d, f, e, dt, trans))


def test_heuristic_is_plan_on_the_cpu():
    """auto on CPU operands is the heuristic: each kernel's plan(), field
    for field, with nothing measured (us None) and nothing written."""
    for got, want in _heuristic_pairs("cpu"):
        assert got == want
    res = autotune.cov_plan(4096, 512, BF16, device="cpu")
    assert res.source == "heuristic" and res.us is None
    assert autotune.STATS["measurements"] == 0
    assert not os.path.exists(os.environ["REPRO_AUTOTUNE_CACHE"])


def test_env_heuristic_pins_cuda_calls_to_plan(monkeypatch):
    """REPRO_AUTOTUNE=heuristic on CUDA operands (what chip_smoke.py's
    phase 17 (c) runs on the card) gives the parent's plan() as well, and
    beats an explicit measure request."""
    monkeypatch.setenv("REPRO_AUTOTUNE", "heuristic")
    for got, want in _heuristic_pairs(torch.device("cuda")):
        assert got == want
    res = autotune.cov_plan(4096, 512, BF16, device="cuda", mode="measure")
    assert res.source == "heuristic"
    assert not os.path.exists(os.environ["REPRO_AUTOTUNE_CACHE"])


def test_unknown_mode_raises(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "fastest")
    with pytest.raises(ValueError, match="mode"):
        autotune.cov_plan(64, 64, F32, device="cpu")


def test_candidates_stay_within_their_bounds():
    for rows, n, dt, banks in COV:
        cands = autotune.cov_candidates(rows, n, dt, banks)
        anchor = cov.plan(rows, n, dt, banks)
        assert cands[0].plan == anchor
        for c in cands:
            p = c.plan
            assert (p.splits == 1 or (p.rows_per_split % p.step == 0
                                      and p.tiles <= 65535))
            assert (p.splits - 1) * p.rows_per_split < rows
            assert p.splits * p.rows_per_split >= rows
            assert p.splits == 1 or p.banks * p.tiles * p.splits <= \
                autotune.COV_MAX_WAVES * cov.WAVE[dt]
            assert c.waste <= max(autotune.MAX_WASTE, cands[0].waste)
    for rows, n, k, m, dt, body in LOW:
        for product in ("xv", "tu"):
            cands = autotune.lowrank_candidates(rows, n, k, m, dt,
                                                product=product, body=body)
            assert cands[0].plan == low.plan(rows, n, k, m, dt, body=body)
            for c in cands:
                p = c.plan
                other = ((p.splits_tu, p.depth_tu) if product == "xv"
                         else (p.splits_xv, p.depth_xv))
                a = cands[0].plan
                assert other == ((a.splits_tu, a.depth_tu) if product == "xv"
                                 else (a.splits_xv, a.depth_xv))
                for splits, depth in ((p.splits_xv, p.depth_xv),
                                      (p.splits_tu, p.depth_tu)):
                    if p.body == "small_t":
                        assert splits <= low.SMALL_MAX_SPLITS
                        assert splits == 1 or depth % low.SMALL_STAGE[dt] == 0
                    if p.body == "wgmma" and splits > 1:
                        assert depth == low.WG_SLICE
    for b, lq, lk, h, kv, d, dt in FLASH:
        cands = autotune.flash_candidates(b, lq, lk, h, kv, d, dt)
        for c in cands:
            p = c.plan
            if p.body in fa.SPLIT_BODIES:
                least = fa.MMA_MIN_TILES if p.body == "split_mma" else 1
                assert p.span % p.bkey == 0 and p.span >= least * p.bkey
                assert p.spans == -(-lk // p.span) <= autotune.MAX_SPANS
            else:
                assert len(cands) == 1
    for shape in DECODE:
        assert len(autotune.flash_decode_candidates(*shape)) == 1
    for rows, d, f, e, dt, trans in GROUPED:
        cands = autotune.grouped_candidates(rows, d, f, e, dt, trans)
        for c in cands:
            p = c.plan
            assert p.body == "fma32" or 1 <= p.ctas <= \
                p.most_row_tiles * p.col_tiles


def test_smem_budget_filters_candidates(monkeypatch):
    """A budget under the bf16 covariance body's shared memory leaves the
    one smallest-footprint candidate, which the tuner then returns without
    measuring; the full budget keeps the lattice."""
    full = autotune.cov_candidates(4096, 512, BF16)
    assert len(full) > 1
    assert all(c.smem_bytes <= autotune.SMEM_BYTES for c in full)
    monkeypatch.setenv("REPRO_AUTOTUNE_SMEM_BYTES",
                       str(full[0].smem_bytes - 1))
    tight = autotune.cov_candidates(4096, 512, BF16)
    assert len(tight) == 1 and tight[0].plan == full[0].plan
    autotune.reset()
    res = autotune.cov_plan(4096, 512, BF16, device="cpu", mode="measure",
                            bench=lambda: pytest.fail("measured"))
    assert res.source == "heuristic"


class _Bench:
    """A fake launcher and timer: records the plans run, prices each by a
    rule (fewest µs wins)."""

    def __init__(self, price):
        self.price, self.runs = price, []

    def make(self, *args):
        return self.run

    def run(self, plan):
        self.runs.append(plan)

    def timer(self, run, plan):
        run(plan)
        return float(self.price(plan))


def test_measure_mode_persists_and_cache_hits():
    fake = _Bench(lambda p: abs(p.splits - 1) + 1.0)   # unsplit is fastest
    autotune.set_timer(fake.timer)
    first = autotune.cov_plan(4096, 512, BF16, device="cpu", mode="measure",
                              bench=fake.make)
    cands = autotune.cov_candidates(4096, 512, BF16)
    assert first.source == "measured" and first.us == 1.0
    assert first.plan.splits == 1 and first.plan in [c.plan for c in cands]
    assert {p for p in fake.runs} == {c.plan for c in cands}
    assert autotune.STATS["measurements"] == 1
    assert autotune.STATS["candidates"] == len(cands)
    with open(os.environ["REPRO_AUTOTUNE_CACHE"]) as f:
        disk = json.load(f)
    (key, entry), = disk.items()
    assert key == (f"cov_accum|v{autotune.CACHE_VERSION}-"
                   f"{build.source_hash()[:12]}|cpu:cpu|e1-s64-n512-"
                   "bfloat16-i0")
    assert entry == {"knobs": {"splits": 1, "steps": 0}, "us": 1.0}
    # a second call in the process: the in-memory pick, nothing measured
    runs = len(fake.runs)
    again = autotune.cov_plan(4096, 512, BF16, device="cpu", mode="measure",
                              bench=fake.make)
    assert again == first and len(fake.runs) == runs
    # a fresh in-memory state replays the disk cache
    autotune.reset()
    hit = autotune.cov_plan(4096, 512, BF16, device="cpu", mode="measure",
                            bench=fake.make)
    assert hit.source == "cache" and hit.plan == first.plan
    assert hit.us == first.us and len(fake.runs) == runs
    # the same step count at another T takes the pick, re-cut for its rows
    other = autotune.cov_plan(4090, 512, BF16, device="cpu", mode="measure",
                              bench=fake.make)
    assert other.source == "cache" and other.plan.rows == 4090
    assert other.plan.splits == 1 and len(fake.runs) == runs
    autotune.clear_disk_cache()
    assert not os.path.exists(os.environ["REPRO_AUTOTUNE_CACHE"])


def test_lowrank_products_are_tuned_apart():
    """x @ V is keyed on (T, n, k) and t @ U on (T, k, m): lowrank_down and
    lowrank_up take the picks lowrank_matmul takes, product by product."""
    fake = _Bench(lambda p: -(p.splits_xv + p.splits_tu))   # most splits
    autotune.set_timer(fake.timer)
    kw = dict(device="cpu", mode="measure", bench=fake.make)
    full = autotune.lowrank_plan(8, 4096, 1232, 4096, BF16, **kw).plan
    down = autotune.lowrank_plan(8, 4096, 1232, 0, BF16, **kw).plan
    up = autotune.lowrank_plan(8, 0, 1232, 4096, BF16, **kw).plan
    assert full.splits_xv == low.SMALL_MAX_SPLITS
    assert (down.splits_xv, down.depth_xv) == (full.splits_xv, full.depth_xv)
    assert (up.splits_tu, up.depth_tu) == (full.splits_tu, full.depth_tu)
    # two measured products for the full call; down's x @ V and up's t @ U
    # are cache hits of them (their other product is a lattice of one)
    assert autotune.STATS["measurements"] == 2


def test_cache_determinism_across_processes(tmp_path):
    """Two child interpreters sharing one cache file: the first measures,
    the second reports source == "cache" with the same plan."""
    child = """
import json
import torch
from repro_torch.kernels import autotune
autotune.set_timer(lambda run, p: float(abs(p.splits - 2) + 1))
r = autotune.cov_plan(4096, 512, torch.bfloat16, device="cpu",
                      mode="measure", bench=lambda: (lambda p: None))
print(json.dumps({"source": r.source, "splits": r.plan.splits,
                  "per": r.plan.rows_per_split}))
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    outs = []
    for _ in range(2):
        out = subprocess.run([sys.executable, "-c", child], env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr
        outs.append(json.loads(out.stdout.splitlines()[-1]))
    assert outs[0]["source"] == "measured" and outs[1]["source"] == "cache"
    assert outs[0]["splits"] == outs[1]["splits"] == 2
    assert outs[0]["per"] == outs[1]["per"]


def test_measure_without_cuda_raises():
    with pytest.raises(RuntimeError, match="CUDA"):
        autotune.cov_plan(4096, 512, BF16, device="cpu", mode="measure",
                          bench=lambda: (lambda p: None))
    assert not os.path.exists(os.environ["REPRO_AUTOTUNE_CACHE"])


def test_failing_candidate_raises():
    """No fallback: a candidate whose launch fails stops the measurement
    and nothing is kept."""
    def timer(run, plan):
        if plan.splits == 2:
            raise RuntimeError("cov_accum: CUDA launch failed with "
                               "cudaError 1")
        return 1.0

    autotune.set_timer(timer)
    with pytest.raises(RuntimeError, match="cudaError"):
        autotune.cov_plan(4096, 512, BF16, device="cpu", mode="measure",
                          bench=lambda: (lambda p: None))
    assert not os.path.exists(os.environ["REPRO_AUTOTUNE_CACHE"])
    assert autotune._MEM == {}


def test_miss_during_graph_capture_raises(monkeypatch):
    """While the current stream captures a CUDA graph the tuner reads its
    caches only: a miss raises, naming the signature; a hit is fine."""
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    capturing = [True]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    fake = _Bench(lambda p: 1.0)
    autotune.set_timer(fake.timer)
    dev = torch.device("cuda")
    with pytest.raises(RuntimeError, match="e1-s64-n512.*capturing"):
        autotune.cov_plan(4096, 512, BF16, device=dev, bench=fake.make)
    assert fake.runs == []
    capturing[0] = False
    got = autotune.cov_plan(4096, 512, BF16, device=dev, bench=fake.make)
    assert got.source == "measured"
    key, = json.load(open(os.environ["REPRO_AUTOTUNE_CACHE"]))
    assert "|cuda:NVIDIA_H100_80GB_HBM3|" in key
    autotune._FAST.clear()
    capturing[0] = True
    assert autotune.cov_plan(4096, 512, BF16, device=dev,
                             bench=fake.make).plan == got.plan


def test_fp32_keeps_the_heuristic_for_order_changing_knobs():
    """fp32 (the dtype held to the CPU) offers no order-changing knob: the
    covariance's slices, small_t's splits and the attention spans stay the
    heuristic's, where bf16 offers them."""
    for rows, n in [(4096, 512), (4096, 256)]:
        assert len(autotune.cov_candidates(rows, n, F32)) == 1
        assert len(autotune.cov_candidates(rows, n, BF16)) > 1
    for product in ("xv", "tu"):
        assert len(autotune.lowrank_candidates(
            8, 2048, 96, 256, F32, product=product)) == 1
    assert len(autotune.lowrank_candidates(8, 2048, 96, 256, BF16,
                                           product="xv")) > 1
    assert len(autotune.flash_candidates(8, 1, 2048, 32, 32, 128, F32)) == 1
    assert len(autotune.flash_candidates(8, 1, 2048, 32, 32, 128, BF16)) > 1


def test_batch_invariant_keeps_the_heuristic_for_order_changing_knobs():
    """Under batch_invariant only the knobs that leave the bits unchanged
    are offered: lowrank_matmul's wgmma splits and grouped_matmul's ctas.
    The covariance's slices, small_t's splits and the attention spans keep
    the heuristic's."""
    for rows, n, dt, banks in COV:
        assert len(autotune.cov_candidates(rows, n, dt, banks,
                                           invariant=True)) == 1
    for b, lq, lk, h, kv, d, dt in FLASH:
        assert len(autotune.flash_candidates(b, lq, lk, h, kv, d, dt,
                                             invariant=True)) == 1
    for rows, n, k, m, dt, _ in LOW:
        for product in ("xv", "tu"):
            cands = autotune.lowrank_candidates(rows, n, k, m, dt,
                                                product=product,
                                                invariant=True)
            assert all(c.plan.body == low.LARGE_T_BODY[dt] for c in cands)
    # at T 8 the invariant call is the wgmma body, split or not: a lattice
    cands = autotune.lowrank_candidates(8, 2048, 96, 256, BF16,
                                        product="xv", invariant=True)
    assert {(c.plan.splits_xv, c.plan.depth_xv) for c in cands} == \
        {(1, 2048), (4, low.WG_SLICE)}
    fake = _Bench(lambda p: p.splits_xv)
    autotune.set_timer(fake.timer)
    got = autotune.lowrank_plan(8, 2048, 96, 256, BF16, invariant=True,
                                device="cpu", mode="measure",
                                bench=fake.make)
    assert got.plan.body == "wgmma" and got.plan.splits_xv == 1


def test_neutral_knobs_give_the_same_bits():
    """The wgmma body's split and grouped_matmul's ctas: every candidate's
    emulation gives the bits of the anchor's."""
    rng = np.random.default_rng(21)
    x = torch.from_numpy(_rand(rng, 77, 2048)).bfloat16()
    v = (torch.from_numpy(_rand(rng, 2048, 96)) / 45).bfloat16()
    u = (torch.from_numpy(_rand(rng, 96, 600)) / 10).bfloat16()
    outs = []
    for product in ("xv", "tu"):
        cands = autotune.lowrank_candidates(77, 2048, 96, 600, BF16,
                                            product=product)
        assert len(cands) == 2 or product == "tu"
        outs += [low.emulate(c.plan, x, v, u) for c in cands]
    for y, t in outs[1:]:
        assert torch.equal(y, outs[0][0]) and torch.equal(t, outs[0][1])
    sizes = [400, 0, 90, 7, 300, 3, 0, 200]
    xg = torch.from_numpy(_rand(rng, 1000, 64)).bfloat16()
    wg = torch.from_numpy(_rand(rng, 8, 64, 304)).bfloat16()
    cands = autotune.grouped_candidates(1000, 64, 304, 8, BF16)
    assert len(cands) > 1
    ys = [gm.emulate(c.plan, xg, wg, sizes) for c in cands]
    assert all(torch.equal(y, ys[0]) for y in ys[1:])


@pytest.mark.parametrize("rows,dtype", [(300, F32), (300, BF16),
                                        (2000, BF16)])
def test_cov_candidates_match_pallas_on_the_ragged_shape(rows, dtype):
    """Every candidate at the JAX test's ragged (300, 200), numpy seed (and
    at 2000 rows in bf16, where T splits are offered), against the JAX
    kernel in interpret mode: rtol 1e-5, atol 1e-5 of the accumulator's
    largest entry (hazard 3b)."""
    rng = np.random.default_rng(0)
    x = _rand(rng, rows, 200)
    xp = x + 0.1 * _rand(rng, rows, 200)
    xt, xpt = (torch.from_numpy(a).to(dtype) for a in (x, xp))
    jdt = jnp.bfloat16 if dtype == BF16 else jnp.float32
    want = jops.cov_accum(jnp.asarray(xt.float().numpy()).astype(jdt),
                          jnp.asarray(xpt.float().numpy()).astype(jdt),
                          force_pallas=True, interpret=True)
    cands = autotune.cov_candidates(rows, 200, dtype)
    assert len(cands) > 1 or rows == 300
    for c in cands:
        got = cov.emulate(c.plan, xt, xpt)
        for g, w in zip(got, want):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                       atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("shape", [(100, 80, 16, 80), (5, 300, 150, 50)])
def test_lowrank_candidates_match_pallas(shape):
    """Every candidate of each product, fp32's and bf16's plans, at the
    contract's ragged probe and a small-T split shape, emulated in fp32
    against the JAX kernel in interpret mode: rtol 1e-5, atol 1e-6 of the
    output's largest entry (a split sums the same fp32 products in another
    order)."""
    t, n, k, m = shape
    rng = np.random.default_rng(t + n)
    x, v, u = _rand(rng, t, n), _rand(rng, n, k), _rand(rng, k, m)
    want = np.asarray(jops.lowrank_matmul(jnp.asarray(x), jnp.asarray(v),
                                          jnp.asarray(u), force_pallas=True,
                                          interpret=True))
    plans = [c.plan for product in ("xv", "tu") for dt in (F32, BF16)
             for c in autotune.lowrank_candidates(t, n, k, m, dt,
                                                  product=product)]
    assert len(plans) > 4 or t > 16
    for p in plans:
        got, _ = low.emulate(p, *(torch.from_numpy(a) for a in (x, v, u)))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("b,lq,lk,h,kv,d,causal", [
    (1, 333, 257, 4, 4, 128, True),      # the contract's ragged probe
    (3, 1, 300, 8, 2, 64, False),        # one-row queries: split spans
    (2, 1, 257, 4, 4, 112, False)])
def test_flash_candidates_match_pallas(b, lq, lk, h, kv, d, causal):
    """Every candidate (fp32 bodies, and the bf16 plans' spans emulated in
    fp32) against the JAX kernel in interpret mode in its (B, H, L, D)
    layout at q_offset 0: rtol 1e-5, atol 1e-6."""
    rng = np.random.default_rng(lq + lk + d)
    q, k, v = (_rand(rng, b, L, H, d) for L, H in ((lq, h), (lk, kv),
                                                   (lk, kv)))
    tr = (0, 2, 1, 3)
    want = np.asarray(jops.flash_attention(
        *(jnp.asarray(a.transpose(tr)) for a in (q, k, v)), causal=causal,
        force_pallas=True, interpret=True)).transpose(tr)
    plans = [c.plan for dt in (F32, BF16)
             for c in autotune.flash_candidates(b, lq, lk, h, kv, d, dt,
                                                causal=causal)]
    assert len(plans) > 2 or lq > 1
    for p in plans:
        p = dataclasses.replace(p, dtype=F32, offsets=(0,) * b)
        got = fa.emulate(p, *(torch.from_numpy(a) for a in (q, k, v)),
                         scale=1.0 / math.sqrt(d))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_measurement_never_writes_into_the_callers_tensors(monkeypatch):
    """ops.cov_accum on the kernel's path (the launcher routed to the
    emulation): the tuner's measurement launches into a triple of its own,
    the caller's acc= is added into once, by the picked plan."""
    launched = []

    def fake_launch(p, x, xp, xx, xxp, xpxp, scratch, *, accumulate):
        launched.append((p, xx.data_ptr()))
        outs = cov.emulate(p, x, xp, (xx, xxp, xpxp) if accumulate
                           else None)
        for o, r in zip((xx, xxp, xpxp), outs):
            o.copy_(r)

    monkeypatch.setattr(ops, "_check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(cov, "launch", fake_launch)
    monkeypatch.setenv("REPRO_AUTOTUNE", "measure")
    autotune.set_timer(lambda run, p: (run(p), float(p.splits))[1])
    rng = np.random.default_rng(3)
    x = torch.from_numpy(_rand(rng, 1, 4096, 512)).bfloat16()
    xp = torch.from_numpy(_rand(rng, 1, 4096, 512)).bfloat16()
    acc = tuple(torch.zeros((1, 512, 512)) for _ in range(3))
    ops.reset_launches()
    got = ops._cov_kernel("cov_accum", x, xp, acc)
    assert got is acc and ops.LAUNCHES["cov_accum"] == 1
    mine = [ptr for _, ptr in launched[:-1]]
    assert acc[0].data_ptr() not in mine and len(set(mine)) == 1
    assert launched[-1][1] == acc[0].data_ptr()
    assert launched[-1][0].splits == 1          # the fastest by the timer
    want = ref.cov_accum_banked_ref(x, xp)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5,
                                   atol=1e-5 * float(w.abs().max()))
