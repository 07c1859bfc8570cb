"""The port's kernel wrappers on the CPU (plain versions, padding, autograd)
against the JAX package's wrappers in Pallas interpret mode.

The CUDA kernels themselves run only on the card; ``chip_smoke.py`` holds
each against its plain version there.
"""

from __future__ import annotations

import torch_thread_cap  # noqa: F401  (thread caps under pytest-xdist)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import cov_accum as tcov
from repro_torch.kernels import lowrank_matmul as tlow
from repro_torch.kernels import ops, ref


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("with_acc", [False, True])
def test_cov_accum_plain_matches_pallas(with_acc):
    # unaligned T and n; fp32 sums in another order: rtol 1e-5 plus an atol
    # of 1e-6·max|acc| for entries near zero
    rng = np.random.default_rng(0)
    x, xp = _rand(rng, 37, 80), _rand(rng, 37, 80)
    acc = tuple(_rand(rng, 80, 80) for _ in range(3)) if with_acc else None
    want = jops.cov_accum(jnp.asarray(x), jnp.asarray(xp),
                          acc=None if acc is None
                          else tuple(jnp.asarray(a) for a in acc),
                          force_pallas=True, interpret=True)
    tacc = None if acc is None else tuple(torch.from_numpy(a.copy())
                                          for a in acc)
    got = ops.cov_accum(torch.from_numpy(x), torch.from_numpy(xp), acc=tacc)
    if tacc is not None:
        assert all(g is a for g, a in zip(got, tacc))   # updated in place
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-6 * np.abs(w).max())


@pytest.mark.parametrize("with_bias,with_res", [(False, False), (True, False),
                                                (False, True), (True, True)])
def test_lowrank_matmul_plain_matches_pallas(with_bias, with_res):
    # odd rank k = 19 and unaligned T, n, m; fp32, rtol 1e-5
    rng = np.random.default_rng(1)
    t, n, k, m = 37, 80, 19, 50
    x, v, u = _rand(rng, t, n), _rand(rng, n, k), _rand(rng, k, m)
    b = _rand(rng, m) if with_bias else None
    r = _rand(rng, t, m) if with_res else None
    want = jops.lowrank_matmul(
        jnp.asarray(x), jnp.asarray(v), jnp.asarray(u),
        bias=None if b is None else jnp.asarray(b),
        residual=None if r is None else jnp.asarray(r),
        force_pallas=True, interpret=True)
    got = ops.lowrank_matmul(
        torch.from_numpy(x), torch.from_numpy(v), torch.from_numpy(u),
        bias=None if b is None else torch.from_numpy(b),
        residual=None if r is None else torch.from_numpy(r))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_lowrank_ref_rounds_intermediate_to_u_dtype():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(_rand(rng, 8, 32)).bfloat16()
    v = torch.from_numpy(_rand(rng, 32, 5)).bfloat16()
    u = torch.from_numpy(_rand(rng, 5, 16)).bfloat16()
    t = (x.float() @ v.float()).bfloat16()
    want = (t.float() @ u.float()).bfloat16()
    assert torch.equal(ref.lowrank_matmul_ref(x, v, u), want)


# the cov kernels' zero fills: token rows past T up to a step (TMA boxes,
# masked loads), columns past n up to a tile edge, in each dtype's body
@pytest.mark.parametrize("axis,multiple", [
    (0, tcov.STEP[torch.bfloat16]), (1, tcov.EDGE[torch.bfloat16]), (0, 7),
    (1, tcov.EDGE[torch.float32])])
def test_pad_then_plain_then_slice_is_exact(axis, multiple):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(_rand(rng, 37, 80))
    xp = torch.from_numpy(_rand(rng, 37, 80))
    xk, xpk = ops.pad_dim(x, axis, multiple), ops.pad_dim(xp, axis, multiple)
    assert xk.shape[axis] % multiple == 0
    padded = ref.cov_accum_ref(xk, xpk)
    plain = ref.cov_accum_ref(x, xp)
    for a, b in zip(padded, plain):
        assert torch.equal(a[:80, :80], b)
    # the lowrank launcher's pads as each body's plan gives them (n, k, m to
    # its multiples; T is never padded): columns of x / rows of v, columns
    # of v / rows of u, columns of u
    v = torch.from_numpy(_rand(rng, 80, 19))
    u = torch.from_numpy(_rand(rng, 19, 50))
    plans = (tlow.plan(37, 80, 19, 50, torch.float32),
             tlow.plan(37, 80, 19, 50, torch.float32, body="fma32"),
             tlow.plan(37, 80, 19, 50, torch.bfloat16))
    assert {p.body for p in plans} == {"small_t", "fma32", "wgmma"}
    for p in plans:
        an, ak, am = p.align
        y = ref.lowrank_matmul_ref(
            ops.pad_dim(x, 1, an),
            ops.pad_dim(ops.pad_dim(v, 0, an), 1, ak),
            ops.pad_dim(ops.pad_dim(u, 0, ak), 1, am))
        assert y.shape == (37, p.m)
        assert torch.equal(y[:, :50], ref.lowrank_matmul_ref(x, v, u))


def test_lowrank_backward_matches_autograd():
    rng = np.random.default_rng(4)
    x0, v0, u0 = _rand(rng, 3, 7, 24), _rand(rng, 24, 5), _rand(rng, 5, 12)
    b0, r0, g0 = _rand(rng, 12), _rand(rng, 3, 7, 12), _rand(rng, 3, 7, 12)

    def leaves():
        return [torch.tensor(a, requires_grad=True)
                for a in (x0, v0, u0, b0, r0)]

    a = leaves()
    ops.lowrank_matmul(a[0], a[1], a[2], bias=a[3],
                       residual=a[4]).backward(torch.from_numpy(g0))
    b = leaves()
    ((b[0] @ b[1]) @ b[2] + b[3] + b[4]).backward(torch.from_numpy(g0))
    for ga, gb in zip(a, b):
        torch.testing.assert_close(ga.grad, gb.grad, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t_rows,n", [(4096, 64), (4096, 128), (4096, 4096),
                                      (64, 64), (4096, 11008), (1056, 64),
                                      (4096, 512), (37, 80)])
def test_cov_split_plan_covers_every_row(t_rows, n, dtype):
    # T is never padded: the slices tile [0, T) in order, none empty, each
    # (but the last) a whole number of the body's token steps; a split
    # fills at most one wave of blocks
    p = tcov.plan(t_rows, n, dtype)
    assert p.splits >= 1 and p.n >= n and p.n % p.align == 0
    assert (p.splits - 1) * p.rows_per_split < t_rows
    assert t_rows <= p.splits * p.rows_per_split
    bounds = p.slices()
    assert bounds[0][0] == 0 and bounds[-1][1] == t_rows
    assert all(a1 == b0 for (_, a1), (b0, _) in zip(bounds, bounds[1:]))
    assert all(r0 < r1 for r0, r1 in bounds)
    if p.splits > 1:
        assert p.rows_per_split % p.step == 0
        assert p.tiles * p.splits <= tcov.WAVE[dtype]


def test_wrappers_refuse_tensors_they_cannot_run():
    x = torch.zeros(4, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.cov_accum(x, x)
    with pytest.raises(ValueError, match="no kernel"):
        ops.lowrank_matmul(x, torch.zeros(8, 2, device="meta"),
                           torch.zeros(2, 3, device="meta"))
