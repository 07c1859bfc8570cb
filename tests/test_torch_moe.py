"""The port's drop-free MoE on the CPU against the JAX package: the grouped
expert GEMM (plain version, padding, autograd), ``moe_apply`` with
``dispatch="dropfree"``, and the grouped covariance triple.

Inputs come from ``np.random.default_rng`` and go to both packages as the
same arrays.  The CUDA ``grouped_matmul`` kernel runs only on the card;
``chip_smoke.py`` holds it against its plain version there.
"""

from __future__ import annotations

import torch_thread_cap  # noqa: F401  (thread caps under pytest-xdist)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as JL
from repro.models import mlp as jmlp
from repro_torch import bridge
from repro_torch import configs as TC
from repro_torch.core import calibration as TCal
from repro_torch.core import streaming as TS
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as TL
from repro_torch.models import mlp as tmlp

ARCH = "deepseek-v2-lite-16b"


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _cfgs(**moe_over):
    """(JAX cfg, port cfg): deepseek smoke in fp32, drop-free dispatch."""
    over = dict(dispatch="dropfree", **moe_over)
    jc = j_smoke(ARCH).replace(dtype="float32")
    tc = TC.get_smoke_config(ARCH).replace(dtype="float32")
    return (jc.replace(moe=dataclasses.replace(jc.moe, **over)),
            tc.replace(moe=dataclasses.replace(tc.moe, **over)))


def _moe_params(jcfg, seed=0):
    p = jmlp.moe_init(jax.random.PRNGKey(seed), jcfg)
    return p, bridge.to_torch(jax.tree.map(np.asarray, p))


# ---------------------------------------------------------------------------
# grouped_matmul


GROUPED_CASES = [
    (16, 128, 256, [4, 0, 7, 5]),
    (24, 100, 96, [24, 0, 0]),          # unaligned d / f, trailing empties
    (37, 80, 64, [10, 9, 0, 18]),       # ragged rows, an empty middle group
    (32, 64, 40, [0, 0, 32]),           # leading empties
    (45, 72, 24, [3, 0, 0, 20, 0, 22]),  # several empty groups
]


@pytest.mark.parametrize("m,d,f,sizes", GROUPED_CASES)
def test_grouped_matmul_plain_matches_pallas(m, d, f, sizes):
    # the JAX wrapper in Pallas interpret mode (its tiled kernel) against the
    # port's plain path; fp32 sums in another order: rtol 1e-5, atol 1e-5
    rng = np.random.default_rng(m + d + f)
    x, w = _rand(rng, m, d), _rand(rng, len(sizes), d, f)
    gs = np.asarray(sizes, np.int32)
    want = np.asarray(jops.grouped_matmul(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(gs), force_pallas=True,
        interpret=True))
    got = ops.grouped_matmul(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(gs))
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, f)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # row by row: output row i is x[i] @ w[group(i)]
    gids = np.repeat(np.arange(len(sizes)), sizes)
    for i in range(m):
        np.testing.assert_allclose(got[i].numpy(), x[i] @ w[gids[i]],
                                   rtol=1e-5, atol=1e-5)


def test_grouped_matmul_rows_past_the_sizes_are_zero():
    # sum(group_sizes) < M: the rows that belong to no group come out zero,
    # as jax.lax.ragged_dot gives them
    rng = np.random.default_rng(3)
    x, w = _rand(rng, 20, 16), _rand(rng, 3, 16, 8)
    gs = np.asarray([5, 0, 9], np.int32)
    want = np.asarray(jref.grouped_matmul_ref(jnp.asarray(x), jnp.asarray(w),
                                              jnp.asarray(gs)))
    got = ops.grouped_matmul(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(gs))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert float(got[14:].abs().max()) == 0.0


@pytest.mark.parametrize("d,f", [(100, 96), (80, 64), (13, 5)])
def test_grouped_padding_contract_is_exact(d, f):
    # the CUDA wrapper zero-pads d and f to the kernel's multiple of 8 and
    # slices f back; the plain version on the padded operands, sliced, is
    # the same function (zero terms add nothing: bitwise)
    rng = np.random.default_rng(d * f)
    sizes = [6, 0, 11, 4]
    x = torch.from_numpy(_rand(rng, 21, d))
    w = torch.from_numpy(_rand(rng, len(sizes), d, f))
    gs = torch.tensor(sizes, dtype=torch.int32)
    xk, wk = ops.grouped_operands(x, w)
    assert xk.shape[1] % 8 == 0 and wk.shape[1] == xk.shape[1]
    assert wk.shape[2] % 8 == 0 and wk.shape[2] - f < 8
    padded = ref.grouped_matmul_ref(xk, wk, gs)[:, :f]
    torch.testing.assert_close(padded, ref.grouped_matmul_ref(x, w, gs),
                               rtol=0, atol=0)


@pytest.mark.parametrize("sizes", [[4, 0, 7, 5], [0, 16, 0, 0]])
def test_grouped_matmul_backward_matches_jax_grad(sizes):
    # dx (the forward function on wᵀ) and dW (per-segment x_eᵀ dy_e) against
    # jax.grad through the JAX oracle; fp32: rtol 1e-5, atol 1e-5
    rng = np.random.default_rng(11)
    m, d, f = 16, 24, 40
    x, w, dy = _rand(rng, m, d), _rand(rng, len(sizes), d, f), \
        _rand(rng, m, f)
    gs = np.asarray(sizes, np.int32)

    def jloss(xx, ww):
        return jnp.sum(jref.grouped_matmul_ref(xx, ww, jnp.asarray(gs))
                       * jnp.asarray(dy))

    jdx, jdw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    y = ops.grouped_matmul(tx, tw, torch.from_numpy(gs))
    tdx, tdw = torch.autograd.grad(y, (tx, tw), torch.from_numpy(dy))
    np.testing.assert_allclose(tdx.numpy(), np.asarray(jdx), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tdw.numpy(), np.asarray(jdw), rtol=1e-5,
                               atol=1e-5)
    assert float(tdw[[i for i, s in enumerate(sizes) if s == 0]]
                 .abs().sum()) == 0.0


def test_grouped_matmul_refuses_what_it_cannot_run():
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.grouped_matmul(torch.zeros(4, 8, **meta),
                           torch.zeros(2, 8, 3, **meta),
                           torch.zeros(2, dtype=torch.int32, **meta))
    with pytest.raises(ValueError, match="do not fit"):
        ops.grouped_matmul(torch.zeros(4, 8), torch.zeros(2, 9, 3),
                           torch.tensor([2, 2]))
    with pytest.raises(TypeError, match="integers"):
        ops.grouped_matmul(torch.zeros(4, 8), torch.zeros(2, 8, 3),
                           torch.tensor([2.0, 2.0]))


# ---------------------------------------------------------------------------
# moe_apply (drop-free)


def _run_jax(p, x, cfg):
    store = {}
    with JL.sowing(store):
        y, aux = jmlp.moe_apply(p, jnp.asarray(x), cfg)
    return np.asarray(y), float(aux), {k: np.asarray(v)
                                       for k, v in store.items()}


def _run_port(p, x, cfg):
    store = {}
    with torch.no_grad(), TL.sowing(store):
        y, aux = tmlp.moe_apply(p, torch.from_numpy(x), cfg)
    return y.numpy(), float(aux), {k: v.numpy() for k, v in store.items()}


@pytest.mark.parametrize("factorized", [False, True])
def test_moe_apply_matches_reference(factorized):
    # outputs to fp32 rounding (rtol 1e-5, atol 1e-5 on O(1) values), the aux
    # loss to rtol 1e-6, and the routed expert ids and taps in choice-major
    # order: ids EXACTLY
    jcfg, tcfg = _cfgs()
    jp, tp = _moe_params(jcfg)
    rng = np.random.default_rng(4)
    if factorized:
        for name, lin in jp["experts"].items():
            e, n, m = lin["w"].shape
            k = 5
            jp["experts"][name] = {
                "v": jnp.asarray(_rand(rng, e, n, k) / np.sqrt(n)),
                "u": jnp.asarray(_rand(rng, e, k, m) / np.sqrt(k))}
        tp = bridge.to_torch(jax.tree.map(np.asarray, jp))
    x = _rand(rng, 3, 16, jcfg.d_model) * 0.5
    jy, jaux, jtaps = _run_jax(jp, x, jcfg)
    ty, taux, ttaps = _run_port(tp, x, tcfg)
    np.testing.assert_allclose(ty, jy, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(taux, jaux, rtol=1e-6)
    assert set(ttaps) == set(jtaps)
    np.testing.assert_array_equal(ttaps["experts_ids"], jtaps["experts_ids"])
    for name in ("experts_in", "experts_down_in", "shared/in",
                 "shared/down_in"):
        np.testing.assert_allclose(ttaps[name], jtaps[name], rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("experts,top_k,seqs,toks",
                         [(8, 2, 2, 16), (8, 1, 3, 7), (4, 3, 2, 9),
                          (8, 2, 5, 11)])
def test_moe_batch_size_invariance(experts, top_k, seqs, toks):
    # running microbatches separately and concatenating equals one joint
    # forward: rtol / atol 1e-6, what tests/test_moe_dropfree.py holds the
    # reference to (torch's CPU GEMM takes another path for a one-row
    # segment, so the plain version is not bitwise row-invariant)
    jcfg, tcfg = _cfgs(num_experts=experts, top_k=top_k)
    _, tp = _moe_params(jcfg)
    x = _rand(np.random.default_rng(7), seqs, toks, tcfg.d_model) * 0.5
    with torch.no_grad():
        y_all, _ = tmlp.moe_apply(tp, torch.from_numpy(x), tcfg)
        for cut in range(1, seqs):
            y_a, _ = tmlp.moe_apply(tp, torch.from_numpy(x[:cut]), tcfg)
            y_b, _ = tmlp.moe_apply(tp, torch.from_numpy(x[cut:]), tcfg)
            torch.testing.assert_close(torch.cat([y_a, y_b]), y_all,
                                       rtol=1e-6, atol=1e-6)


def test_moe_apply_backward_matches_reference():
    # gradients of a scalar of the output through the router, the gates and
    # the three grouped GEMMs against jax.grad: rtol 1e-4, atol 1e-5 (fp32
    # sums in another order through softmax and the expert products)
    jcfg, tcfg = _cfgs()
    jp, tp = _moe_params(jcfg, seed=2)
    rng = np.random.default_rng(8)
    x = _rand(rng, 2, 8, jcfg.d_model) * 0.5
    cot = _rand(rng, 2, 8, jcfg.d_model)

    def jloss(p):
        y, aux = jmlp.moe_apply(p, jnp.asarray(x), jcfg)
        return jnp.sum(y * jnp.asarray(cot)) + aux

    jg = jax.grad(jloss)(jp)
    leaves = {"router": tp["router"]["w"],
              "gate": tp["experts"]["gate"]["w"],
              "down": tp["experts"]["down"]["w"]}
    for t in leaves.values():
        t.requires_grad_(True)
    y, aux = tmlp.moe_apply(tp, torch.from_numpy(x), tcfg)
    loss = torch.sum(y * torch.from_numpy(cot)) + aux
    grads = torch.autograd.grad(loss, list(leaves.values()))
    want = {"router": jg["router"]["w"], "gate": jg["experts"]["gate"]["w"],
            "down": jg["experts"]["down"]["w"]}
    for (name, _), g in zip(leaves.items(), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[name]),
                                   rtol=1e-4, atol=1e-5)


def test_unknown_dispatch_raises():
    jcfg, tcfg = _cfgs()
    _, tp = _moe_params(jcfg)
    x = torch.zeros(1, 4, tcfg.d_model)
    with pytest.raises(ValueError, match="unknown moe dispatch"):
        tmlp.moe_apply(tp, x, tcfg, dispatch="bogus")


# ---------------------------------------------------------------------------
# grouped covariance triple


def _triples_close(got, want):
    # fp32 sums of R outer products in another order: rtol 1e-5 plus an atol
    # of 1e-6 of the accumulator's largest entry (ROADMAP hazard 3b)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(g), w, rtol=1e-5,
                                   atol=1e-6 * np.abs(w).max())


@pytest.mark.parametrize("with_acc", [False, True])
def test_cov_accum_grouped_matches_refs(with_acc):
    rows, n, e = 300, 72, 6
    rng = np.random.default_rng(5)
    x = _rand(rng, rows, n)
    xp = x + 0.1 * _rand(rng, rows, n)
    ids = rng.integers(0, e - 1, rows).astype(np.int32)   # expert e-1 empty
    want_port = ref.cov_accum_grouped_ref(torch.from_numpy(x),
                                          torch.from_numpy(xp),
                                          torch.from_numpy(ids), e)
    want_jax = jref.cov_accum_grouped_ref(jnp.asarray(x), jnp.asarray(xp),
                                          jnp.asarray(ids), e)
    acc = None
    if with_acc:
        acc = tuple(torch.ones((e, n, n)) for _ in range(3))
        want_port = tuple(w + 1.0 for w in want_port)
        want_jax = tuple(np.asarray(w) + 1.0 for w in want_jax)
    got = ops.cov_accum_grouped(torch.from_numpy(x), torch.from_numpy(xp),
                                torch.from_numpy(ids), e, acc=acc)
    if acc is not None:
        assert all(g is a for g, a in zip(got, acc))      # added in place
    _triples_close([g.numpy() for g in got], [w.numpy() for w in want_port])
    _triples_close([g.numpy() for g in got], want_jax)
    assert float(got[0][e - 1].abs().max()) == (1.0 if with_acc else 0.0)


def test_update_covs_grouped_and_engine_bins_per_expert():
    # update_covs routes (R, n) rows + ids into the (E, n, n) accumulator and
    # counts rows; the engine sizes grouped bank taps from num_experts and
    # bins BOTH streams by the original stream's ids
    rows, n, e = 64, 16, 4
    rng = np.random.default_rng(6)
    x, xp = _rand(rng, rows, n), _rand(rng, rows, n)
    ids = rng.integers(0, e, rows).astype(np.int32)
    covs = TCal.init_covs(n, e)
    TCal.update_covs(covs, torch.from_numpy(x), torch.from_numpy(xp),
                     ids=torch.from_numpy(ids))
    want = jref.cov_accum_grouped_ref(jnp.asarray(x), jnp.asarray(xp),
                                      jnp.asarray(ids), e)
    _triples_close([covs[k].numpy() for k in ("xx", "xxp", "xpxp")], want)
    assert covs["count"] == rows
    assert TCal.ids_tap_name("ffn/experts_down_in") == "ffn/experts_ids"

    group = [("ffn.experts.gate", "ffn/experts_in", True)]
    engine = TS.CalibrationEngine([("ffn/experts_in", group)],
                                  {"ffn/experts_in": torch.Size([rows, n])},
                                  num_experts=e)
    shifted_ids = (ids + 1) % e                  # ignored: original ids bin
    engine.consume({"ffn/experts_in": torch.from_numpy(x),
                    "ffn/experts_ids": torch.from_numpy(ids)},
                   {"ffn/experts_in": torch.from_numpy(xp),
                    "ffn/experts_ids": torch.from_numpy(shifted_ids)})
    got = engine.covs_for("ffn/experts_in")
    _triples_close([got[k].numpy() for k in ("xx", "xxp", "xpxp")], want)
    with pytest.raises(ValueError, match="num_experts"):
        TS.CalibrationEngine([("ffn/experts_in", group)],
                             {"ffn/experts_in": torch.Size([rows, n])})
