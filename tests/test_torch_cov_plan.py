"""The launch plan of the port's covariance triple
(``repro_torch/kernels/cov_accum.py``) and a plain-PyTorch emulation of its
arithmetic (triangle tiles over [X | X'], split partials added in order, the
mirror), held to the port's plain version and to the JAX package's kernel
in Pallas interpret mode; and the same with a bank axis (the capacity
dispatch's per-expert triples, one launch over all banks).

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
from repro_torch.kernels import cov_accum as cov
from repro_torch.kernels import ops, ref

DTYPES = (torch.bfloat16, torch.float32)
# chip_smoke.py's phase-3 shapes (T, n), then small ragged ones
SHAPES = ((4096, 4096), (4096, 11008), (4096, 512), (384, 2048), (4096, 80),
          (77, 203), (1, 8), (37, 80), (200, 200), (1000, 264))


def _launcher_accepts(p):
    """The checks ``cov_accum_launch`` (csrc/cov_accum.cu) makes of a plan
    before it launches anything (the scratch is given when split)."""
    step = 64 if p.dtype == torch.bfloat16 else 16
    edge = 128 if p.dtype == torch.bfloat16 else 64
    align = 8 if p.dtype == torch.bfloat16 else 4
    strips = 2 * -(-p.n // p.edge)
    tiles = strips * (strips + 1) // 2
    return (p.edge == edge and 1 <= p.banks <= 65535 and p.rows >= 1
            and p.n >= 1 and p.n % align == 0
            and 1 <= p.splits <= 65535 and p.rows_per_split >= 1
            and p.splits * p.rows_per_split >= p.rows
            and (p.splits - 1) * p.rows_per_split < p.rows
            and (p.splits == 1 or p.rows_per_split % step == 0)
            and tiles * p.splits * p.banks <= 0x7fffffff
            and (p.splits == 1 or tiles <= 65535))


def _coverage(p, n):
    """How many times the kernels' epilogue stores each entry of xx, xxp,
    xpxp (n the unpadded width): the tiles' direct stores, the mirror of an
    off-diagonal xx / xpxp tile, a diagonal tile's upper half and its
    mirror."""
    counts = [np.zeros((n, n), dtype=np.int64) for _ in range(3)]
    e, half = p.edge, p.half
    for a, b in p.tile_list():
        ap, bp = a >= half, b >= half
        i0, j0 = (a % half) * e, (b % half) * e
        rows = np.arange(i0, min(n, i0 + e))
        cols = np.arange(j0, min(n, j0 + e))
        if ap != bp:
            counts[1][np.ix_(rows, cols)] += 1
            continue
        out = counts[2 if ap else 0]
        if a == b:
            r, c = np.meshgrid(rows, cols, indexing="ij")
            up = r <= c
            np.add.at(out, (r[up], c[up]), 1)
            low = r < c
            np.add.at(out, (c[low], r[low]), 1)
        else:
            out[np.ix_(rows, cols)] += 1
            out[np.ix_(cols, rows)] += 1
    return counts


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t_rows,n", SHAPES)
def test_plan_covers_every_row_and_tile_once(t_rows, n, dtype):
    p = cov.plan(t_rows, n, dtype)
    assert _launcher_accepts(p)
    # the slices tile [0, T) once, in order
    bounds = p.slices()
    assert bounds[0][0] == 0 and bounds[-1][1] == t_rows
    assert all(a1 == b0 for (_, a1), (b0, _) in zip(bounds, bounds[1:]))
    assert all(r0 < r1 for r0, r1 in bounds)
    # every upper-triangle tile of the 2·half strips once, and the kernels'
    # index arithmetic gives the launch order
    tiles = p.tile_list()
    s = p.strips
    assert s == 2 * -(-n // p.edge)
    assert sorted(tiles) == [(a, b) for a in range(s) for b in range(a, s)]
    assert len(tiles) == p.tiles
    if p.tiles <= 20000:
        assert all(p.tile_at(t) == tile for t, tile in enumerate(tiles))
    else:
        for t in np.random.default_rng(0).integers(0, p.tiles, 500):
            assert p.tile_at(int(t)) == tiles[t]
    with pytest.raises(IndexError):
        p.tile_at(p.tiles)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t_rows,n", [(37, 80), (77, 203), (200, 200),
                                      (1000, 264), (64, 512)])
def test_epilogue_stores_every_entry_once(t_rows, n, dtype):
    p = cov.plan(t_rows, n, dtype)
    for c in _coverage(p, n):
        assert (c == 1).all()


@pytest.mark.parametrize("dtype", DTYPES)
def test_splits_only_when_the_triangle_underfills_a_wave(dtype):
    rng = np.random.default_rng(1)
    shapes = [(int(t), int(n)) for t, n in zip(rng.integers(1, 5000, 60),
                                                rng.integers(1, 1500, 60))]
    for t_rows, n in list(SHAPES) + shapes:
        p = cov.plan(t_rows, n, dtype)
        steps = -(-t_rows // p.step)
        # a wave holds at least two blocks of each tile, and T two slices
        splittable = (2 * p.tiles <= cov.WAVE[dtype]
                      and steps >= 2 * cov.MIN_STEPS[dtype])
        assert (p.splits > 1) == splittable
        if p.splits > 1:
            assert p.tiles * p.splits <= cov.WAVE[dtype]
            assert p.rows_per_split >= cov.MIN_STEPS[dtype] * p.step
            assert p.scratch_floats == p.splits * p.tiles * p.edge ** 2
        else:
            assert p.rows_per_split == t_rows and p.scratch_floats == 0
    # the main paths' shapes: llama-7b's taps unsplit; MLA's kv_lora tap
    # (n 512) split in bf16; the smoke recipe's fp32 taps split
    assert cov.plan(4096, 4096, torch.bfloat16).splits == 1
    assert cov.plan(4096, 11008, torch.bfloat16).splits == 1
    assert cov.plan(384, 2048, torch.bfloat16).splits == 1
    assert cov.plan(4096, 512, dtype).splits > 1
    assert cov.plan(128, 64, torch.float32).splits > 1


@pytest.mark.parametrize("change", [
    dict(splits=0), dict(rows_per_split=0), dict(n=83), dict(edge=96),
    dict(rows_per_split=100), dict(splits=2), dict(splits=70000),
    dict(rows=0), dict(banks=0), dict(banks=70000)])
@pytest.mark.parametrize("banks,n", [(1, 512), (3, 256)])
def test_launcher_refuses_what_the_plan_never_makes(change, banks, n):
    base = cov.plan(4096, n, torch.bfloat16, banks=banks)
    assert base.splits > 1 and _launcher_accepts(base)
    assert not _launcher_accepts(dataclasses.replace(base, **change))


def test_plan_refuses_bank_counts_the_launcher_refuses():
    with pytest.raises(ValueError, match="no plan"):
        cov.plan(64, 64, torch.float32, banks=0)
    with pytest.raises(ValueError, match="no plan"):
        cov.plan(64, 64, torch.float32, banks=cov.MAX_BANKS + 1)
    assert _launcher_accepts(cov.plan(64, 64, torch.float32,
                                      banks=cov.MAX_BANKS))


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_acc", [False, True])
@pytest.mark.parametrize("t_rows,n", [(37, 80), (200, 200), (100, 130),
                                      (1000, 64)])
def test_emulate_matches_plain_and_pallas(t_rows, n, with_acc, dtype):
    # fp32 sums of the same products in other orders (and, split, in slices
    # added in order): rtol 1e-5 plus an atol of 1e-6·max|want| for entries
    # near zero (ROADMAP hazard 3b).  bf16 inputs: each product is exact in
    # fp32, so the same limits hold
    rng = np.random.default_rng(t_rows + n)
    xt = torch.from_numpy(_rand(rng, t_rows, n)).to(dtype)
    xpt = torch.from_numpy(_rand(rng, t_rows, n)).to(dtype)
    a, b = _rand(rng, n, n), _rand(rng, n, n)
    # symmetric xx / xpxp accumulators, as calibration holds them
    acc = ((a + a.T) / 2, _rand(rng, n, n), (b + b.T) / 2) if with_acc \
        else None
    p = cov.plan(t_rows, n, dtype)
    tacc = None if acc is None else tuple(torch.from_numpy(v) for v in acc)
    got = cov.emulate(p, xt, xpt, tacc)
    plain = ref.cov_accum_ref(xt, xpt)
    if acc is not None:
        plain = tuple(v + w for v, w in zip(tacc, plain))
        assert all(torch.equal(v, torch.from_numpy(w))
                   for v, w in zip(tacc, acc))      # acc is not modified
    xj = jnp.asarray(xt.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    xpj = jnp.asarray(xpt.float().numpy()).astype(xj.dtype)
    pallas = jops.cov_accum(xj, xpj, acc=None if acc is None else tuple(
        jnp.asarray(v) for v in acc), force_pallas=True, interpret=True)
    for g, w, j in zip(got, plain, pallas):
        j = np.asarray(j)
        lim = 1e-6 * np.abs(j).max()
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=lim)
        np.testing.assert_allclose(g.numpy(), j, rtol=1e-5, atol=lim)
    # the mirror: xx and xpxp exactly symmetric (acc symmetric too)
    assert torch.equal(got[0], got[0].T) and torch.equal(got[2], got[2].T)


def test_emulate_sums_slices_in_order():
    # a split plan's result is its slices' products added in slice order:
    # the same bits from the unsplit arithmetic over the same slices
    rng = np.random.default_rng(5)
    x = torch.from_numpy(_rand(rng, 1000, 64))
    xp = torch.from_numpy(_rand(rng, 1000, 64))
    p = cov.plan(1000, 64, torch.float32)
    assert p.splits > 1
    got = cov.emulate(p, x, xp)
    z = torch.cat([x, xp], 1)
    total = None
    for r0, r1 in p.slices():
        part = z[r0:r1].T @ z[r0:r1]
        total = part if total is None else total + part
    upper = torch.triu(total[:64, :64])
    assert torch.equal(got[0], upper + torch.triu(upper, 1).T)
    assert torch.equal(got[1], total[:64, 64:])


def test_wrapper_launches_the_plan(monkeypatch):
    # a tensor off the CPU takes the kernel's route (meta: no data), as one
    # bank: n is padded to the body's 16-byte multiple only, T never; acc=
    # is added into in place when n needs no padding, else a fresh triple
    # is sliced and added
    seen = []
    monkeypatch.setattr(ops, "_check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(ops, "_aligned", lambda a: a)
    monkeypatch.setattr(cov, "launch", lambda p, x, xp, xx, xxp, xpxp,
                        scratch, *, accumulate: seen.append(
                            (p, tuple(x.shape), tuple(xx.shape),
                             None if scratch is None else scratch.numel(),
                             accumulate)))
    meta = dict(dtype=torch.bfloat16, device="meta")
    ops.reset_launches()
    xx, xxp, xpxp = ops.cov_accum(torch.zeros(2, 2048, 512, **meta),
                                  torch.zeros(4096, 512, **meta))
    p = cov.plan(4096, 512, torch.bfloat16)
    assert seen[-1] == (p, (1, 4096, 512), (1, 512, 512), p.scratch_floats,
                        False)
    assert xx.shape == (512, 512) and ops.LAUNCHES["cov_accum"] == 1
    acc = tuple(torch.zeros(200, 200, device="meta") for _ in range(3))
    out = ops.cov_accum(torch.zeros(77, 200, **meta),
                        torch.zeros(77, 200, **meta), acc=acc)
    assert all(o is a for o, a in zip(out, acc))
    assert seen[-1] == (cov.plan(77, 200, torch.bfloat16), (1, 77, 200),
                        (1, 200, 200), None, True)
    acc = tuple(torch.zeros(203, 203, device="meta") for _ in range(3))
    out = ops.cov_accum(torch.zeros(77, 203, **meta),
                        torch.zeros(77, 203, **meta), acc=acc)
    assert all(o is a for o, a in zip(out, acc))
    assert seen[-1][1:] == ((1, 77, 208), (1, 208, 208), None, False)
    assert ops.LAUNCHES["cov_accum"] == 3
    # no rows: nothing launched
    ops.cov_accum(torch.zeros(0, 64, **meta), torch.zeros(0, 64, **meta))
    assert ops.LAUNCHES["cov_accum"] == 3 and len(seen) == 3


# ---------------------------------------------------------------------------
# banked: (E, C, n) -> E triples in one launch

# chip_smoke.py's banked shapes (E, C, n): the capacity dispatch's two bank
# taps at deepseek-v2-lite's widths, then ragged ones
BANKED = ((64, 480, 2048), (64, 480, 1408), (3, 130, 72), (3, 130, 100),
          (3, 37, 100), (2, 130, 192), (8, 40, 64))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("e,c,n", BANKED)
def test_banked_items_run_bank_slice_tile(e, c, n, dtype):
    # the kernels' item order: bank slowest, then slice, then tile; every
    # (bank, slice, tile) once, and the launcher takes the plan
    p = cov.plan(c, n, dtype, banks=e)
    assert p.banks == e and _launcher_accepts(p)
    assert p.items == e * p.splits * p.tiles
    want = [(b, z, t) for b in range(e) for z in range(p.splits)
            for t in range(p.tiles)]
    if p.items <= 50000:
        assert [p.item_at(w) for w in range(p.items)] == want
    else:
        for w in np.random.default_rng(0).integers(0, p.items, 2000):
            assert p.item_at(int(w)) == want[w]
    with pytest.raises(IndexError):
        p.item_at(p.items)
    # a bank's tiles and slices are the unbanked plan's at the same split
    one = cov.plan(c, n, dtype)
    assert (p.n, p.tiles, p.tile_list()) == (one.n, one.tiles,
                                             one.tile_list())
    if p.splits > 1:
        assert p.scratch_floats == p.items * p.edge ** 2


@pytest.mark.parametrize("dtype", DTYPES)
def test_banked_split_rule_reads_only_the_shape(dtype):
    # T is split only when the banks' tiles (E x tiles items) fill less than
    # half a wave and T holds two slices; the plan is a function of
    # (E, C, n, dtype), and E 1 is the unbanked plan
    rng = np.random.default_rng(2)
    shapes = [(int(b), int(t), int(n)) for b, t, n in zip(
        rng.integers(1, 80, 60), rng.integers(1, 3000, 60),
        rng.integers(1, 1200, 60))]
    for e, c, n in list(BANKED) + shapes:
        p = cov.plan(c, n, dtype, banks=e)
        assert p == cov.plan.__wrapped__(c, n, dtype, e)
        steps = -(-c // p.step)
        splittable = (2 * e * p.tiles <= cov.WAVE[dtype]
                      and steps >= 2 * cov.MIN_STEPS[dtype])
        assert (p.splits > 1) == splittable, (e, c, n)
        if p.splits > 1:
            assert p.items <= cov.WAVE[dtype]
        if e == 1:
            assert p == cov.plan(c, n, dtype)
    # the capacity dispatch's taps at deepseek-v2-lite widths: 64 x 528 and
    # 64 x 242 items, no split; the smoke recipe's (8, 40, 64) fp32 taps
    # split (8 x 3 items)
    assert cov.plan(480, 2048, torch.bfloat16, banks=64).splits == 1
    assert cov.plan(480, 1408, torch.bfloat16, banks=64).splits == 1
    assert cov.plan(40, 64, torch.float32, banks=8).splits > 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_acc", [False, True])
@pytest.mark.parametrize("e,c,n", [(3, 130, 72), (3, 37, 100), (8, 40, 64)])
def test_banked_emulate_matches_plain_per_bank(e, c, n, with_acc, dtype):
    # each bank against the plain version: the limits of
    # test_emulate_matches_plain_and_pallas; each bank's xx and xpxp
    # exactly symmetric; acc= not modified
    rng = np.random.default_rng(e * c + n)
    x = torch.from_numpy(_rand(rng, e, c, n)).to(dtype)
    xp = torch.from_numpy(_rand(rng, e, c, n)).to(dtype)
    acc = None
    if with_acc:
        a, b = _rand(rng, e, n, n), _rand(rng, e, n, n)
        acc = tuple(torch.from_numpy(v) for v in (
            (a + a.transpose(0, 2, 1)) / 2, _rand(rng, e, n, n),
            (b + b.transpose(0, 2, 1)) / 2))
        before = tuple(v.clone() for v in acc)
    p = cov.plan(c, n, dtype, banks=e)
    got = cov.emulate(p, x, xp, acc)
    want = ref.cov_accum_banked_ref(x, xp)
    if acc is not None:
        want = tuple(v + w for v, w in zip(acc, want))
        assert all(torch.equal(v, w) for v, w in zip(acc, before))
    for g, w in zip(got, want):
        assert tuple(g.shape) == (e, n, n)
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-6 * float(w.abs().max()))
    for bank in range(e):
        assert torch.equal(got[0][bank], got[0][bank].T)
        assert torch.equal(got[2][bank], got[2][bank].T)
        one = cov.emulate(dataclasses.replace(p, banks=1), x[bank], xp[bank],
                          None if acc is None else tuple(a[bank]
                                                         for a in acc))
        assert all(torch.equal(g[bank], o) for g, o in zip(got, one))


@pytest.mark.parametrize("dtype", DTYPES)
def test_banked_emulate_bank_independent(dtype):
    # new inputs in every other bank leave bank 1's three outputs bit for
    # bit as they were
    e, c, n = 4, 130, 100
    rng = np.random.default_rng(9)
    x = torch.from_numpy(_rand(rng, e, c, n)).to(dtype)
    xp = torch.from_numpy(_rand(rng, e, c, n)).to(dtype)
    p = cov.plan(c, n, dtype, banks=e)
    first = cov.emulate(p, x, xp)
    x2, xp2 = x.clone(), xp.clone()
    for bank in (0, 2, 3):
        x2[bank] = torch.from_numpy(_rand(rng, c, n)).to(dtype)
        xp2[bank] = torch.from_numpy(_rand(rng, c, n)).to(dtype)
    second = cov.emulate(p, x2, xp2)
    assert all(torch.equal(a[1], b[1]) for a, b in zip(first, second))
    assert not torch.equal(first[0][0], second[0][0])


def test_banked_wrapper_launches_once_for_all_banks(monkeypatch):
    # a tensor off the CPU takes the kernel's route (meta: no data): one
    # launch for all E banks, n padded to the body's 16-byte multiple only,
    # C never; acc= is added into in place when n needs no padding
    seen = []
    monkeypatch.setattr(ops, "_check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(ops, "_aligned", lambda a: a)
    monkeypatch.setattr(cov, "launch", lambda p, x, xp, xx, xxp, xpxp,
                        scratch, *, accumulate: seen.append(
                            (p, tuple(x.shape), tuple(xx.shape),
                             None if scratch is None else scratch.numel(),
                             accumulate)))
    meta = dict(dtype=torch.bfloat16, device="meta")
    ops.reset_launches()
    acc = tuple(torch.zeros(64, 2048, 2048, device="meta") for _ in range(3))
    out = ops.cov_accum_banked(torch.zeros(64, 480, 2048, **meta),
                               torch.zeros(64, 480, 2048, **meta), acc=acc)
    assert all(o is a for o, a in zip(out, acc))
    p = cov.plan(480, 2048, torch.bfloat16, banks=64)
    assert seen[-1] == (p, (64, 480, 2048), (64, 2048, 2048), None, True)
    xx, _, _ = ops.cov_accum_banked(torch.zeros(3, 130, 100, **meta),
                                    torch.zeros(3, 130, 100, **meta))
    p = cov.plan(130, 100, torch.bfloat16, banks=3)
    assert seen[-1] == (p, (3, 130, 104), (3, 104, 104), p.scratch_floats
                        or None, False)
    assert tuple(xx.shape) == (3, 100, 100)
    assert ops.LAUNCHES["cov_accum_banked"] == 2
    assert ops.LAUNCHES["cov_accum"] == 0
    # no slots: nothing launched
    ops.cov_accum_banked(torch.zeros(3, 0, 64, **meta),
                         torch.zeros(3, 0, 64, **meta))
    assert ops.LAUNCHES["cov_accum_banked"] == 2 and len(seen) == 2
