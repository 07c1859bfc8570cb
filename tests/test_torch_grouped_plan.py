"""The launch plan of the port's grouped expert GEMM
(``repro_torch/kernels/grouped_matmul.py``): the per-expert row tiles of the
wgmma body and the order its persistent blocks take them, the launcher's
refusals, and a plain-PyTorch emulation of the kernel's work tile by tile,
held to the port's plain version and to the JAX package's kernel in Pallas
interpret mode.

The CUDA bodies run only on the card; ``chip_smoke.py`` holds each against
the plain version there at the main path's shapes.
"""

from __future__ import annotations

import torch_thread_cap  # noqa: F401  (thread caps under pytest-xdist)
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import grouped_matmul as gm
from repro_torch.kernels import ops, ref

DTYPES = (torch.bfloat16, torch.float32)


def _dirichlet(m, e, seed, empty=()):
    """Skewed sizes summing to m (a Dirichlet(0.3) draw, chip_smoke.py's),
    the experts in ``empty`` without rows."""
    rng = np.random.default_rng(seed)
    p = rng.dirichlet(np.full(e, 0.3))
    p[list(empty)] = 0.0
    return rng.multinomial(m, p / p.sum()).tolist()


# (name, M, d, f, group sizes)
CASES = [
    ("tail_rows", 300, 504, 1408, [100, 0, 50, 30]),        # sum < M
    ("leading_empty", 300, 1408, 504, [0, 0, 200, 100]),
    ("middle_empty", 257, 2048, 200, [129, 0, 0, 128]),
    ("trailing_empty", 130, 200, 77, [1, 129, 0, 0]),
    ("one_expert", 1000, 77, 2048, [0] * 5 + [1000] + [0] * 2),
    ("decode", 48, 2048, 1408, _dirichlet(48, 64, 0)),
    ("phase7", 24576, 2048, 504, _dirichlet(24576, 64, 1, (1, 32))),
    ("past_m", 100, 504, 504, [60, 70, 10]),                # clamped to M
]


def _owner(m, sizes):
    """Each row's expert (-1: past every segment), ends clamped to M."""
    own = np.full(m, -1)
    start = 0
    for g, s in enumerate(sizes):
        own[min(start, m):min(start + s, m)] = g
        start += s
    return own


def _plans(m, d, f, e):
    """Every plan a call can take: fp32, and bf16 forward and dx."""
    return [gm.plan(m, d, f, e, torch.float32)] + [
        gm.plan(m, d, f, e, torch.bfloat16, trans=trans)
        for trans in (False, True)]


@pytest.mark.parametrize("name,m,d,f,sizes", CASES,
                         ids=[c[0] for c in CASES])
def test_tiles_cover_every_row_once_by_its_own_expert(name, m, d, f, sizes):
    own = _owner(m, sizes)
    live = int((own >= 0).sum())
    for p in _plans(m, d, f, len(sizes)):
        assert p.d % gm.MULTIPLE == 0 and p.d - d < gm.MULTIPLE
        assert p.f % gm.MULTIPLE == 0 and p.f - f < gm.MULTIPLE
        seen = np.zeros((m, p.col_tiles), dtype=np.int64)
        for g, r0, r1, j in gm.tiles(p, sizes):
            assert 0 <= r0 < r1 <= m and r1 - r0 <= p.bm
            assert (own[r0:r1] == g).all() and 0 <= j < p.col_tiles
            seen[r0:r1, j] += 1
        # rows of a segment once in every column tile, the rest never
        assert (seen[own >= 0] == 1).all() and (seen[own < 0] == 0).all()
        if p.body != "wgmma":
            continue
        items = gm.tiles(p, sizes)
        starts = p.tile_starts(sizes)
        assert len(items) == starts[-1] * p.col_tiles
        assert starts[-1] <= p.most_row_tiles
        assert 1 <= p.ctas <= min(gm.SMS, p.most_row_tiles * p.col_tiles)
        # an expert's tiles start at its own first row, BM apart; empty
        # experts get none
        segs = p.segments(sizes)
        for g, (lo, hi) in enumerate(segs):
            mine = [t for t in items if t[0] == g]
            assert len(mine) == (-(-(hi - lo) // p.bm) if hi > lo else 0) \
                * p.col_tiles
            assert all((r0 - lo) % p.bm == 0 for _, r0, _, _ in mine)
        # the tail tiles' wasted rows: at most one tile less a row an
        # expert; a warpgroup whose 64 rows lie past the segment computes
        # nothing, so the rows of MMA work waste at most 63 an expert
        live_experts = sum(hi > lo for lo, hi in segs)
        waste = starts[-1] * p.bm - live
        assert 0 <= waste <= live_experts * (p.bm - 1)
        work = p.computed_rows(sizes) - live
        assert 0 <= work <= live_experts * (gm.WG_ROWS - 1) and work <= waste


@pytest.mark.parametrize("name,m,d,f,sizes", CASES,
                         ids=[c[0] for c in CASES])
def test_tile_at_is_the_launch_order(name, m, d, f, sizes):
    # the kernel's on-device map (a scan of the clamped offsets, then a
    # binary search) gives item w of tiles() for every w
    for p in _plans(m, d, f, len(sizes))[1:]:
        items = gm.tiles(p, sizes)
        ws = range(len(items)) if len(items) <= 4000 else \
            np.random.default_rng(0).integers(0, len(items), 500).tolist()
        assert all(p.tile_at(sizes, w) == items[w] for w in ws)
        with pytest.raises(IndexError):
            p.tile_at(sizes, len(items))


def test_plan_bodies_tiles_and_blocks():
    p = gm.plan(24576, 2048, 504, 64, torch.bfloat16)
    assert (p.body, p.bm, p.bn, p.stages, p.ctas) == ("wgmma", 128, 128, 4,
                                                       gm.SMS)
    assert (p.k, p.n, p.col_tiles) == (2048, 504, 4) and not p.trans
    t = gm.plan(24576, 2048, 504, 64, torch.bfloat16, trans=True)
    assert (t.k, t.n, t.col_tiles) == (504, 2048, 16) and t.trans
    # decode: 48 rows over 64 experts still fill the card
    assert gm.plan(48, 2048, 1408, 64, torch.bfloat16).ctas == gm.SMS
    # a call with few items takes as many blocks as the most it could need
    small = gm.plan(5, 8, 8, 2, torch.bfloat16)
    assert small.ctas == (1 + 2) * 1
    f32 = gm.plan(4133, 200, 77, 9, torch.float32)
    assert (f32.body, f32.bm, f32.bn, f32.stages, f32.ctas) == (
        "fma32", 64, 64, 0, 0)
    assert (f32.d, f32.f) == (200, 80)
    with pytest.raises(ValueError, match="as it lies"):
        gm.plan(64, 8, 8, 2, torch.float32, trans=True)
    with pytest.raises(ValueError, match="grid"):
        gm.plan(64 * 65535 + 1, 8, 8, 2, torch.float32)
    # the wgmma body's grid does not depend on M
    assert gm.plan(128 * 65536, 8, 8, 2, torch.bfloat16).ctas == gm.SMS
    for dtype in DTYPES:
        with pytest.raises(ValueError, match="experts"):
            gm.plan(64, 8, 8, gm.MAX_EXPERTS + 1, dtype)
    with pytest.raises(TypeError):
        gm.plan(64, 8, 8, 2, torch.float16)
    with pytest.raises(ValueError):
        gm.plan(0, 8, 8, 2, torch.bfloat16)


def _launcher_accepts(p):
    """The checks ``grouped_matmul_launch`` (csrc/grouped_matmul.cu) makes
    of a plan before it launches anything."""
    if (p.rows <= 0 or p.d <= 0 or p.f <= 0 or p.experts <= 0
            or p.experts > 1024 or p.d % 8 or p.f % 8):
        return False
    if p.dtype == torch.float32 and p.body == "fma32":
        return (not p.trans and (p.bm, p.bn, p.stages, p.ctas) == (64, 64, 0, 0)
                and -(-p.rows // 64) <= 65535)
    if p.dtype == torch.bfloat16 and p.body == "wgmma":
        most = (-(-p.rows // 128) + p.experts) * -(-p.n // 128)
        return ((p.bm, p.bn, p.stages) == (128, 128, 4)
                and 1 <= p.ctas <= most and most <= 0x7fffffff)
    return False


@pytest.mark.parametrize("name,m,d,f,sizes", CASES,
                         ids=[c[0] for c in CASES])
def test_launcher_accepts_every_plan(name, m, d, f, sizes):
    assert all(_launcher_accepts(p) for p in _plans(m, d, f, len(sizes)))


@pytest.mark.parametrize("change", [
    dict(bm=64), dict(bn=256), dict(stages=3), dict(ctas=0),
    dict(ctas=(192 + 64) * 4 + 1), dict(experts=1025), dict(d=2044),
    dict(f=500), dict(rows=0), dict(body="fma32"),
    dict(dtype=torch.float32)])
def test_launcher_refuses_what_the_plan_never_makes(change):
    base = gm.plan(24576, 2048, 504, 64, torch.bfloat16)
    assert _launcher_accepts(base)
    assert not _launcher_accepts(dataclasses.replace(base, **change))


@pytest.mark.parametrize("change", [dict(trans=True), dict(ctas=1),
                                    dict(bm=128), dict(rows=64 * 65536),
                                    dict(experts=1025)])
def test_launcher_refuses_fp32_plans_it_never_gets(change):
    base = gm.plan(4133, 200, 77, 9, torch.float32)
    assert _launcher_accepts(base)
    assert not _launcher_accepts(dataclasses.replace(base, **change))


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _rel_fro(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# (M, d, f, sizes): every row tile shape the plan makes at a small size —
# sum < M, leading / middle / trailing empties, one expert, unaligned d / f
EMULATE_CASES = [
    (300, 72, 200, [100, 0, 50, 30]),
    (260, 136, 64, [0, 0, 200, 60]),
    (257, 64, 40, [129, 0, 0, 128]),
    (130, 77, 24, [1, 129, 0, 0]),
    (200, 16, 136, [0, 200, 0]),
    (48, 128, 96, _dirichlet(48, 16, 2)),
]


# the plans a call makes: bf16 forward and dx (trans), fp32 forward (its dx
# is the forward on Wᵀ made contiguous)
@pytest.mark.parametrize("dtype,trans", [(torch.bfloat16, False),
                                         (torch.bfloat16, True),
                                         (torch.float32, False)])
@pytest.mark.parametrize("m,d,f,sizes", EMULATE_CASES)
def test_emulate_matches_plain_and_pallas(m, d, f, sizes, dtype, trans):
    # fp32: the same fp32 products summed in other orders, 1e-5 relative
    # Frobenius.  bf16: exact products summed in fp32 and rounded once to
    # bf16 (2^-8 relative) in each of the three, 1e-2
    rng = np.random.default_rng(m + d + f)
    x = torch.from_numpy(_rand(rng, m, f if trans else d)).to(dtype)
    w = torch.from_numpy(_rand(rng, len(sizes), d, f)).to(dtype)
    gs = np.asarray(sizes, np.int32)
    p = gm.plan(m, d, f, len(sizes), dtype, trans=trans)
    xk, wk = ops.grouped_operands(x, w)
    n = d if trans else f
    got = gm.emulate(p, xk, wk, sizes)[:, :n]
    assert got.dtype == dtype and tuple(got.shape) == (m, n)
    wt = w.transpose(1, 2) if trans else w
    plain = ref.grouped_matmul_ref(x, wt, torch.from_numpy(gs)).to(dtype)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jw = jnp.asarray(wt.float().numpy()).astype(jdt)
    pallas = jops.grouped_matmul(jnp.asarray(x.float().numpy()).astype(jdt),
                                 jw, jnp.asarray(gs), force_pallas=True,
                                 interpret=True)
    lim = 1e-5 if dtype == torch.float32 else 1e-2
    assert _rel_fro(got.float(), plain.float()) <= lim
    assert _rel_fro(got.float(), np.asarray(pallas.astype(jnp.float32))) \
        <= lim
    # rows past the segments are exactly zero
    live = min(m, int(gs.sum()))
    assert not got[live:].float().abs().any()


def test_emulate_fp32_is_the_plain_version_row_by_row():
    # each output row is its own row times its own expert's weights; the
    # wgmma tiles' extra box rows change nothing
    rng = np.random.default_rng(9)
    sizes = [3, 0, 140, 5]
    x = torch.from_numpy(_rand(rng, 150, 32))
    w = torch.from_numpy(_rand(rng, 4, 32, 16))
    own = _owner(150, sizes)
    for dtype in DTYPES:
        p = gm.plan(150, 32, 16, 4, dtype)
        got = gm.emulate(dataclasses.replace(p, dtype=torch.float32), x, w,
                         sizes)
        for i in range(150):
            want = x[i] @ w[own[i]] if own[i] >= 0 else torch.zeros(16)
            torch.testing.assert_close(got[i], want, rtol=1e-5, atol=1e-5)


def test_wrapper_launches_the_plan(monkeypatch):
    # a tensor off the CPU takes the kernel's route (meta: no data).  The
    # bf16 forward and dx read the bank as it lies (dx with trans: no
    # transposed copy); the fp32 dx gets Wᵀ made contiguous
    seen = []
    monkeypatch.setattr(ops, "_check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(ops, "_aligned", lambda a: a)
    monkeypatch.setattr(gm, "launch", lambda p, x, w, gs, y: seen.append(
        (p, tuple(x.shape), w, tuple(gs.shape), tuple(y.shape))))
    meta = dict(device="meta")
    ops.reset_launches()
    gs = torch.zeros(64, dtype=torch.int32, **meta)
    w = torch.zeros(64, 2048, 504, dtype=torch.bfloat16, **meta)
    y = ops._grouped_kernel(torch.zeros(24576, 2048, dtype=torch.bfloat16,
                                        **meta), w, gs)
    p = gm.plan(24576, 2048, 504, 64, torch.bfloat16)
    assert seen[-1][0] == p and seen[-1][2] is w
    assert seen[-1][1:2] + seen[-1][3:] == ((24576, 2048), (64,),
                                            (24576, 504))
    assert tuple(y.shape) == (24576, 504)
    dx = ops._grouped_kernel(torch.zeros(48, 504, dtype=torch.bfloat16,
                                         **meta), w, gs, trans=True)
    assert seen[-1][0] == gm.plan(48, 2048, 504, 64, torch.bfloat16, True)
    assert seen[-1][2] is w and tuple(dx.shape) == (48, 2048)
    w32 = torch.zeros(9, 200, 77, **meta)
    gs9 = torch.zeros(9, dtype=torch.int32, **meta)
    dx = ops._grouped_kernel(torch.zeros(33, 77, **meta), w32, gs9,
                             trans=True)
    assert seen[-1][0] == gm.plan(33, 77, 200, 9, torch.float32)
    assert tuple(seen[-1][2].shape) == (9, 80, 200)   # Wᵀ, padded
    assert tuple(dx.shape) == (33, 200)
    assert ops.LAUNCHES["grouped_matmul"] == 3
    # no rows: nothing launched
    ops._grouped_kernel(torch.zeros(0, 2048, dtype=torch.bfloat16, **meta),
                        w, gs)
    assert ops.LAUNCHES["grouped_matmul"] == 3 and len(seen) == 3
    assert dict(ops.GROUPED_ROWS) == {24576: 1, 48: 1, 33: 1}


def test_backward_runs_dx_on_the_bank_as_it_lies(monkeypatch):
    # dx = dy @ W[g]ᵀ goes through the forward function with trans on the
    # bank itself; on the CPU that is the plain version on wᵀ
    calls = []
    real = ops._grouped_forward

    def spy(x, w, group_sizes, trans=False):
        calls.append((w, trans))
        return real(x, w, group_sizes, trans)

    monkeypatch.setattr(ops, "_grouped_forward", spy)
    rng = np.random.default_rng(4)
    sizes = torch.tensor([5, 0, 9, 2], dtype=torch.int32)
    x = torch.from_numpy(_rand(rng, 16, 24)).requires_grad_(True)
    w = torch.from_numpy(_rand(rng, 4, 24, 40)).requires_grad_(True)
    dy = torch.from_numpy(_rand(rng, 16, 40))
    dx, _ = torch.autograd.grad(ops.grouped_matmul(x, w, sizes), (x, w), dy)
    assert [t for _, t in calls] == [False, True]
    assert calls[1][0].data_ptr() == w.data_ptr()
    want = ref.grouped_matmul_ref(dy, w.detach().transpose(1, 2), sizes)
    torch.testing.assert_close(dx, want, rtol=1e-5, atol=1e-5)
