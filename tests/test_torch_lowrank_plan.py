"""The launch plan of the port's factorized linear
(``repro_torch/kernels/lowrank_matmul.py``) and a plain-PyTorch emulation of
its split arithmetic, held to the JAX package's kernel in Pallas interpret
mode and to the port's plain version.

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
from repro_torch.kernels import lowrank_matmul as low
from repro_torch.kernels import ops, ref

# chip_smoke.py's phase-3 shapes (n, k, m): llama-7b's linears at ratio 0.6,
# then the ragged one; and the row counts the main paths give the wrapper
MAIN = ((4096, 1232, 4096), (4096, 1792, 11008), (11008, 1792, 4096))
PHASE3 = MAIN + ((64, 19, 160),)
ROWS = (1, 3, 8, 16, 17, 32, 64, 77, 129, 256, 4096)
DTYPES = (torch.bfloat16, torch.float32)


def _partition(intervals, size):
    """The half-open intervals tile [0, size) once."""
    ends = sorted(set(intervals))
    assert ends[0][0] == 0 and ends[-1][1] == size
    for (a0, a1), (b0, b1) in zip(ends, ends[1:]):
        assert a1 == b0
    return ends


def _covers_once(p, product):
    """Each depth slice's blocks cover every (row, column) of the product's
    padded output once, and the slices tile its padded depth once."""
    cols, depth = (p.k, p.n) if product == "xv" else (p.m, p.k)
    slices = {}
    for r0, r1, c0, c1, d0, d1 in p.blocks(product):
        assert r0 < r1 and c0 < c1 and d0 < d1
        slices.setdefault((d0, d1), []).append(((r0, r1), (c0, c1)))
    _partition(list(slices), depth)
    for rects in slices.values():
        rows_ = _partition([r for r, _ in rects], p.rows)
        cols_ = _partition([c for _, c in rects], cols)
        assert sorted(rects) == sorted((r, c) for r in rows_ for c in cols_)


def _launcher_accepts(p):
    """The checks ``lowrank_matmul_launch`` (csrc/lowrank_matmul.cu) makes
    of a plan before it launches anything (n = 0: t @ U alone; m = 0:
    x @ V alone; not both)."""
    assert p.rows >= 1 and p.splits_xv >= 1 and p.splits_tu >= 1
    assert p.n >= 0 and p.k > 0 and p.m >= 0 and (p.n > 0 or p.m > 0)
    if p.body == "fma32":
        assert p.k % 64 == 0 and p.m % 64 == 0 and p.n % 16 == 0
    elif p.body == "small_t":
        vec = 4 if p.align[0] == 4 else 8
        assert p.rows <= p.tile_rows_xv == p.tile_rows_tu
        assert p.n % vec == 0 and p.k % vec == 0 and p.m % vec == 0
        assert p.depth_xv % 8 == 0 and p.depth_tu % 8 == 0
    else:
        assert p.n % 8 == 0 and p.k % 8 == 0 and p.m % 8 == 0
        assert p.tile_rows_xv == p.tile_rows_tu == low.WG_ROWS
        for splits, per in ((p.splits_xv, p.depth_xv),
                            (p.splits_tu, p.depth_tu)):
            assert splits == 1 or per == low.WG_SLICE


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nkm", PHASE3)
def test_plan_covers_every_output_once(nkm, dtype):
    n, k, m = nkm
    for rows in ROWS:
        p = low.plan(rows, n, k, m, dtype)
        assert p.n >= n and p.k >= k and p.m >= m
        _covers_once(p, "xv")
        _covers_once(p, "tu")
        _launcher_accepts(p)


@pytest.mark.parametrize("seed", range(4))
def test_plan_covers_random_small_shapes(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        rows = int(rng.integers(1, 300))
        n, k, m = (int(d) for d in rng.integers(1, 700, 3))
        for dtype in DTYPES:
            for body in (None, "small_t" if rows <= 32 else None):
                p = low.plan(rows, n, k, m, dtype, body=body)
                _covers_once(p, "xv")
                _covers_once(p, "tu")
                _launcher_accepts(p)


@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_picks_the_body_by_rows_and_never_pads_rows(dtype):
    for rows in ROWS:
        p = low.plan(rows, 4096, 1232, 4096, dtype)
        small = rows <= low.SMALL_T_MAX[dtype]
        large = "wgmma" if dtype == torch.bfloat16 else "fma32"
        assert p.body == ("small_t" if small else large)
        assert p.rows == rows                  # T is masked, never padded
        assert p.grid("xv")[1] == -(-rows // p.tile_rows_xv)
        if small:
            assert p.tile_rows_xv == min(r for r in low.SMALL_ROWS[dtype]
                                         if r >= rows)


@pytest.mark.parametrize("nkm", MAIN)
def test_plan_fills_the_card_at_main_path_shapes(nkm):
    # decode (8), the engine's prefill chunk (256), compression (4096): each
    # product keeps at least SMS blocks in flight where its tiles and splits
    # allow as many (the wgmma body splits into whole 512-row slices only)
    n, k, m = nkm
    for rows in (8, 256, 4096):
        p = low.plan(rows, n, k, m, torch.bfloat16)
        for product, depth in (("xv", p.n), ("tu", p.k)):
            gx, gy, gz = p.grid(product)
            if p.body == "small_t":
                most = gx * gy * low.SMALL_MAX_SPLITS
            else:
                most = gx * gy * -(-depth // low.WG_SLICE)
            assert gx * gy * gz >= min(low.SMS, most)


@pytest.mark.parametrize("nkm", PHASE3)
def test_rows_do_not_depend_on_the_batch(nkm):
    # chunked prefill must equal whole prefill: the wgmma body splits only
    # at fixed 512-row slices, summed in order whether split or not; the
    # small-T body's tiles and splits are the same at every T it takes
    n, k, m = nkm
    for rows in (17, 77, 256, 512, 4096):
        p = low.plan(rows, n, k, m, torch.bfloat16)
        assert p.body == "wgmma"
        for splits, per in ((p.splits_xv, p.depth_xv),
                            (p.splits_tu, p.depth_tu)):
            assert splits == 1 or per == low.WG_SLICE
    small = {dataclasses.replace(low.plan(rows, n, k, m, torch.bfloat16),
                                 rows=0)
             for rows in range(1, low.SMALL_T_MAX[torch.bfloat16] + 1)}
    assert len(small) == 1


def test_plan_pads_only_what_a_body_needs():
    for rows in (8, 256, 4096):
        for n, k, m in MAIN:
            p = low.plan(rows, n, k, m, torch.bfloat16)
            assert (p.n, p.k, p.m) == (n, k, m)     # the factors are not copied
    assert low.plan(8, 64, 19, 160, torch.bfloat16).k == 24
    assert low.plan(129, 64, 19, 160, torch.bfloat16).k == 24
    assert low.plan(8, 64, 19, 160, torch.float32).k == 20
    p = low.plan(129, 64, 19, 160, torch.float32)
    assert p.body == "fma32" and (p.n, p.k, p.m) == (64, 64, 192)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("with_bias,with_res", [(False, False), (True, False),
                                                (False, True), (True, True)])
def test_small_t_emulation_matches_pallas_fp32(with_bias, with_res):
    # ragged n, k, m; the plan splits both contractions; fp32, the tolerance
    # of test_lowrank_matmul_plain_matches_pallas (rtol 1e-5, atol 1e-5)
    rng = np.random.default_rng(5)
    t, n, k, m = 5, 300, 150, 50
    x, v, u = _rand(rng, t, n), _rand(rng, n, k), _rand(rng, k, m)
    b = _rand(rng, m) if with_bias else None
    r = _rand(rng, t, m) if with_res else None
    p = low.plan(t, n, k, m, torch.float32)
    assert p.body == "small_t" and p.splits_xv > 1 and p.splits_tu > 1
    want = jops.lowrank_matmul(
        jnp.asarray(x), jnp.asarray(v), jnp.asarray(u),
        bias=None if b is None else jnp.asarray(b),
        residual=None if r is None else jnp.asarray(r),
        force_pallas=True, interpret=True)
    got, _ = low.emulate(p, torch.from_numpy(x), torch.from_numpy(v),
                         torch.from_numpy(u),
                         None if b is None else torch.from_numpy(b),
                         None if r is None else torch.from_numpy(r))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("rows,body", [(8, "small_t"), (16, "small_t"),
                                       (77, "wgmma")])
def test_split_emulation_matches_plain_bf16(rows, body):
    # bf16 at chip_smoke.py's limit: max abs err <= 2e-2 * max|want|, the
    # plain version adding bias and residual after its bf16 rounding
    rng = np.random.default_rng(6)
    n, k, m = 2048, 96, 256
    x = torch.from_numpy(_rand(rng, rows, n)).bfloat16()
    v = (torch.from_numpy(_rand(rng, n, k)) / n ** 0.5).bfloat16()
    u = (torch.from_numpy(_rand(rng, k, m)) / k ** 0.5).bfloat16()
    b = torch.from_numpy(_rand(rng, m)).bfloat16()
    r = torch.from_numpy(_rand(rng, rows, m)).bfloat16()
    p = low.plan(rows, n, k, m, torch.bfloat16)
    assert p.body == body and p.splits_xv > 1
    got, t = low.emulate(p, x, v, u, b, r)
    want = ref.lowrank_matmul_ref(x, v, u) + b + r
    assert got.dtype == t.dtype == torch.bfloat16
    err = float((got.float() - want.float()).abs().max())
    assert err <= 2e-2 * float(want.float().abs().max())


def test_plan_refuses_what_no_body_runs():
    with pytest.raises(TypeError, match="no kernel"):
        low.plan(8, 64, 16, 32, torch.float16)
    with pytest.raises(ValueError, match="bfloat16"):
        low.plan(8, 64, 16, 32, torch.float32, body="wgmma")
    with pytest.raises(ValueError, match="float32"):
        low.plan(8, 64, 16, 32, torch.bfloat16, body="fma32")
    with pytest.raises(ValueError, match="at most"):
        low.plan(33, 64, 16, 32, torch.bfloat16, body="small_t")
    with pytest.raises(ValueError, match="unknown body"):
        low.plan(8, 64, 16, 32, torch.bfloat16, body="wmma")


def test_wrapper_refuses_meta_tensors_with_any_body():
    x = torch.zeros(4, 8, device="meta")
    v, u = torch.zeros(8, 2, device="meta"), torch.zeros(2, 3, device="meta")
    for body in (None, "small_t", "wgmma"):
        with pytest.raises(ValueError, match="no kernel"):
            ops._lowrank_kernel(x, v, u, None, None, body=body)


def test_cpu_calls_launch_nothing():
    ops.reset_launches()
    x, v, u = torch.ones(3, 8), torch.ones(8, 2), torch.ones(2, 4)
    ops.lowrank_matmul(x, v, u)
    assert ops.LAUNCHES["lowrank_matmul"] == 0 and not ops.LOWRANK_ROWS


def _chosen_bodies(monkeypatch, dtype, rows_list):
    """The body each call's plan took, with the checks and the launch
    stubbed out so the wrapper's choice runs on the CPU."""
    bodies = []
    monkeypatch.setattr(ops, "_check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(low, "launch",
                        lambda p, *a, **k: bodies.append(p.body))
    for rows in rows_list:
        x = torch.zeros(rows, 64, dtype=dtype)
        ops._lowrank_kernel(x, torch.zeros(64, 16, dtype=dtype),
                            torch.zeros(16, 32, dtype=dtype), None, None)
    return bodies


@pytest.mark.parametrize("dtype", DTYPES)
def test_batch_invariant_takes_the_large_t_body_at_any_rows(monkeypatch,
                                                            dtype):
    rows = (1, 8, low.SMALL_T_MAX[dtype], low.SMALL_T_MAX[dtype] + 1, 256)
    outside = _chosen_bodies(monkeypatch, dtype, rows)
    assert outside == ["small_t"] * 3 + [low.LARGE_T_BODY[dtype]] * 2
    with ops.batch_invariant():
        with ops.batch_invariant():
            pass
        inside = _chosen_bodies(monkeypatch, dtype, rows)
    assert inside == [low.LARGE_T_BODY[dtype]] * len(rows)
    with pytest.raises(RuntimeError):
        with ops.batch_invariant():
            raise RuntimeError
    assert _chosen_bodies(monkeypatch, dtype, rows) == outside


def test_prefill_runs_batch_invariant_and_decode_does_not(monkeypatch):
    from repro_torch import configs
    from repro_torch.models import model as M
    cfg = configs.get_smoke_config("llama-7b").replace(dtype="float32")
    params = M.init_params(cfg, 0, device="cpu")
    seen = []
    embed = M._embed_inputs
    monkeypatch.setattr(M, "_embed_inputs", lambda *a: (
        seen.append(ops._BATCH_INVARIANT), embed(*a))[1])
    run_stage = M._run_stage_cached
    monkeypatch.setattr(M, "_run_stage_cached", lambda *a: (
        seen.append(ops._BATCH_INVARIANT), run_stage(*a))[1])
    cache = M.init_cache(cfg, 1, 16, device="cpu")
    tokens = torch.zeros((1, 5), dtype=torch.int32)
    M.prefill(params, cfg, {"tokens": tokens}, cache)
    assert seen and all(seen)
    seen.clear()
    M.decode_step(params, cfg, cache, tokens[:, :1], 5)
    assert seen and not any(seen)
    assert not ops._BATCH_INVARIANT


@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_of_x_at_v_alone(dtype):
    # m = 0: x @ V alone (ops.lowrank_down); t @ U has no block, no split
    # and no scratch; x @ V is planned as with any m
    for rows in (1, 8, 16, 64, 77, 256, 4096):
        for n, k, m in PHASE3:
            p = low.plan(rows, n, k, 0, dtype)
            q = low.plan(rows, n, k, m, dtype)
            assert p.m == 0 and p.grid("tu")[0] == 0 and not p.blocks("tu")
            assert p.splits_tu == 1 and p.depth_tu >= p.k
            _launcher_accepts(p)
            if rows <= 32 and dtype == torch.bfloat16:
                _launcher_accepts(low.plan(rows, n, k, 0, dtype, "small_t"))
            if dtype == torch.bfloat16:
                _launcher_accepts(low.plan(rows, n, k, 0, dtype, "wgmma"))
            assert (p.body, p.k, p.splits_xv, p.depth_xv) == (
                q.body, q.k, q.splits_xv, q.depth_xv)
            assert p.scratch_floats == (
                p.splits_xv * rows * p.k if p.splits_xv > 1 else 0)
            _covers_once(p, "xv")


def test_lowrank_down_is_x_at_v_on_the_cpu():
    rng = np.random.default_rng(7)
    x = torch.from_numpy(_rand(rng, 2, 5, 48))
    v = torch.from_numpy(_rand(rng, 48, 12))
    ops.reset_launches()
    t = ops.lowrank_down(x, v)
    assert t.shape == (2, 5, 12) and ops.LAUNCHES["lowrank_matmul"] == 0
    torch.testing.assert_close(t, x @ v, rtol=0, atol=0)
    # the plan's arithmetic for it: t of the split emulation, fp32
    p = low.plan(10, 48, 12, 0, torch.float32)
    _, te = low.emulate(p, x.reshape(10, 48), v, v.new_zeros((12, 0)))
    np.testing.assert_allclose(te.numpy(), (x @ v).reshape(10, 12).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_lowrank_down_launches_x_at_v_alone(monkeypatch):
    seen = []
    monkeypatch.setattr(ops, "_check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(low, "launch", lambda p, x, v, u, t, y, *a: seen.append(
        (p.m, tuple(u.shape), tuple(t.shape), tuple(y.shape))))
    monkeypatch.setattr(ops, "_aligned", lambda a: a)
    # a tensor off the CPU takes the kernel's route (meta: no data)
    x = torch.zeros(3, 4, 64, dtype=torch.bfloat16, device="meta")
    t = ops.lowrank_down(x, torch.zeros(64, 24, dtype=torch.bfloat16,
                                        device="meta"))
    assert t.shape == (3, 4, 24)
    assert seen == [(0, (24, 0), (12, 24), (12, 0))]


@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_of_t_at_u_alone(dtype):
    # n = 0: t @ U alone on a given t (ops.lowrank_up); x @ V has no split
    # and t @ U is planned as with any n, so its rows round as
    # lowrank_matmul's do
    for rows in (1, 8, 16, 64, 77, 256, 1024, 4096):
        for n, k, m in PHASE3:
            bodies = [None] + (["wgmma"] if dtype == torch.bfloat16 else
                               ["fma32"])
            if rows <= 32 and dtype == torch.bfloat16:
                bodies.append("small_t")
            for body in bodies:
                p = low.plan(rows, 0, k, m, dtype, body)
                q = low.plan(rows, n, k, m, dtype, body)
                assert p.n == 0 and p.splits_xv == 1
                assert (p.body, p.k, p.m, p.tile_rows_tu, p.tile_cols,
                        p.splits_tu, p.depth_tu) == (
                    q.body, q.k, q.m, q.tile_rows_tu, q.tile_cols,
                    q.splits_tu, q.depth_tu)
                assert p.scratch_floats == (
                    p.splits_tu * rows * p.m if p.splits_tu > 1 else 0)
                _launcher_accepts(p)
                _covers_once(p, "tu")


@pytest.mark.parametrize("dtype", DTYPES)
def test_lowrank_up_is_t_at_u_on_the_cpu(dtype):
    # the plain version's second product: fp32 sums rounded once to t's
    # dtype (exactly t @ u in fp32)
    rng = np.random.default_rng(8)
    t = torch.from_numpy(_rand(rng, 2, 5, 12)).to(dtype)
    u = torch.from_numpy(_rand(rng, 12, 40)).to(dtype)
    ops.reset_launches()
    y = ops.lowrank_up(t, u)
    assert y.shape == (2, 5, 40) and y.dtype == dtype
    assert ops.LAUNCHES["lowrank_matmul"] == 0
    want = (t.reshape(10, 12).float() @ u.float()).to(dtype)
    assert torch.equal(y.reshape(10, 40), want)
    if dtype == torch.float32:
        torch.testing.assert_close(y, t @ u, rtol=0, atol=0)
    # lowrank_matmul's plain version is lowrank_up of lowrank_down's t
    x = torch.from_numpy(_rand(rng, 10, 48)).to(dtype)
    v = torch.from_numpy(_rand(rng, 48, 12)).to(dtype)
    assert torch.equal(ops.lowrank_up(ref.lowrank_matmul_ref(
        x, v, torch.eye(12, dtype=dtype)), u),
        ref.lowrank_matmul_ref(x, v, u))


def test_lowrank_up_launches_t_at_u_alone(monkeypatch):
    seen = []
    monkeypatch.setattr(ops, "_check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(low, "launch", lambda p, x, v, u, t, y, *a: seen.append(
        (p.n, x, v, tuple(u.shape), tuple(t.shape), tuple(y.shape))))
    monkeypatch.setattr(ops, "_aligned", lambda a: a)
    # a tensor off the CPU takes the kernel's route (meta: no data); k and
    # m are padded to the body's multiple (19 -> 24, 50 -> 56), T never
    t = torch.zeros(3, 4, 19, dtype=torch.bfloat16, device="meta")
    y = ops.lowrank_up(t, torch.zeros(19, 50, dtype=torch.bfloat16,
                                      device="meta"))
    assert y.shape == (3, 4, 50)
    assert seen == [(0, None, None, (24, 56), (12, 24), (12, 56))]


def test_latent_prefill_matches_reference():
    # the latent cache's prefill (x @ V into the cache at ``start``, the
    # whole cache up-projected through ops.lowrank_up, attention) against
    # the JAX package's on the same numpy weights, cache and tokens: whole
    # (start 0) and a second chunk over a cache already holding 8 rows.
    # fp32, sums in another order: 1e-5
    from repro.core import zoo
    from repro.models import attention as JA
    from repro.models import layers as JL
    from repro_torch import configs as TC
    from repro_torch.models import attention as TA
    from repro_torch.models import layers as TL

    cfg = zoo.smoke_cfg("llama-7b")
    tcfg = TC.get_smoke_config("llama-7b").replace(dtype="float32")
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    rng = np.random.default_rng(9)
    rk, rv, lmax, b = 11, 13, 24, 2
    w = {"wq": {"w": _rand(rng, d, h * hd) / 8},
         "wk": {"v": _rand(rng, d, rk) / 8, "u": _rand(rng, rk, kv * hd) / 4},
         "wv": {"v": _rand(rng, d, rv) / 8, "u": _rand(rng, rv, kv * hd) / 4},
         "wo": {"w": _rand(rng, h * hd, d) / 8}}
    jp = {k: {n: jnp.asarray(a) for n, a in v.items()} for k, v in w.items()}
    tp = {k: {n: torch.from_numpy(a) for n, a in v.items()}
          for k, v in w.items()}
    lk0, lv0 = _rand(rng, b, lmax, rk), _rand(rng, b, lmax, rv)
    theta = cfg.rope_theta
    for start, length in ((0, 8), (8, 5)):
        x = _rand(rng, b, length, d)
        pos = np.arange(start, start + length)
        jcos, jsin = JL.rope_table(jnp.asarray(pos), hd, theta)
        tcos, tsin = TL.rope_table(torch.from_numpy(pos), hd, theta)
        jo, jlk, jlv = JA.gqa_prefill_latent(
            jp, jnp.asarray(x), jnp.asarray(lk0), jnp.asarray(lv0), start,
            cfg, jcos, jsin, theta=theta)
        to, tlk, tlv = TA.gqa_prefill_latent(
            tp, torch.from_numpy(x), torch.from_numpy(lk0.copy()),
            torch.from_numpy(lv0.copy()), start, tcfg, tcos, tsin,
            theta=theta)
        for got, want in ((to, jo), (tlk, jlk), (tlv, jlv)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)
