"""The port's state-space blocks (``repro_torch.models.ssm``) against the JAX
package's ``repro.models.ssm`` on the CPU.

falcon-mamba smoke (Mamba1: d_model 64, d_inner 128, state 4, dt_rank 8,
chunk 16) and zamba2 smoke (Mamba2: d_inner 128, 8 SSD heads of 16, state
8, chunk 16) in fp32.  Params come from the JAX package's init (one key),
bridged to torch, and inputs from numpy.  The sequence lengths are a
multiple of the chunk (32), not one (23: the last chunk padded with
``dt = 0``), and shorter than the conv window (2: the tail conv state
left-padded).

The SSD body masks the exponent of the chunk square's upper triangle
before the exp, where the reference forms exp(cums_i − cums_j) whole and
masks after (its masked entries overflow once a chunk's decay passes ~88,
and inf · 0 turns the output NaN): on finite inputs the masked body gives
the bits of the reference's formula written in torch, and past the
overflow it gives the step recurrence's values where the reference gives
NaN.

Tolerances, relative Frobenius in fp32: 1e-5 for the forwards, states,
decode rollouts and taps (both packages sum the same products; XLA and
torch order some reductions differently, ~3e-7 measured); 1e-5 for the
gradients of a scalar loss through the chunked scans (``jax.checkpoint``
against ``torch.utils.checkpoint``); the conv exactly to 1e-6.
"""

from __future__ import annotations

import torch_thread_cap  # noqa: F401  (thread caps under pytest-xdist)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import ssm as JS
from repro_torch import bridge
from repro_torch import configs as TC
from repro_torch.models import blocks as TB
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import ssm as TS

ARCHS = ("falcon-mamba-7b", "zamba2-7b")
ZAMBA = "zamba2-7b"
LENGTHS = (32, 23, 2)
TOL = 1e-5


def _cfgs(arch):
    return (j_smoke(arch).replace(dtype="float32"),
            TC.get_smoke_config(arch).replace(dtype="float32"))


def _fns(cfg, module):
    v1 = cfg.ssm.version == 1
    return {name: getattr(module, f"mamba{1 if v1 else 2}_{name}")
            for name in ("init", "forward", "init_state", "decode")}


def _params(arch, seed=1):
    jcfg, tcfg = _cfgs(arch)
    p = jax.tree.map(np.asarray,
                     _fns(jcfg, JS)["init"](jax.random.PRNGKey(seed), jcfg))
    # A_log zeros (Mamba2's init) would make every SSD head decay alike:
    # spread the heads, as training does
    p = dict(p, A_log=(p["A_log"] + np.random.default_rng(seed).uniform(
        -1.0, 1.0, p["A_log"].shape)).astype(np.float32))
    return jcfg, tcfg, p


def rel(got, want):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _x(cfg, length, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (2, length, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_causal_conv_and_step_match_reference(arch):
    jcfg, _, p = _params(arch)
    c = p["conv_w"].shape[0]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 23, c)).astype(np.float32)
    b = rng.standard_normal((c,)).astype(np.float32)
    want = JS.causal_conv(jnp.asarray(x), jnp.asarray(p["conv_w"]),
                          jnp.asarray(b))
    w = torch.tensor(p["conv_w"])
    got = TS.causal_conv(torch.from_numpy(x), w, torch.from_numpy(b))
    assert rel(got, want) <= 1e-6
    state = rng.standard_normal((2, p["conv_w"].shape[1] - 1, c)
                                ).astype(np.float32)
    jy, js = JS.causal_conv_step(jnp.asarray(x[:, 0]), jnp.asarray(state),
                                 jnp.asarray(p["conv_w"]), jnp.asarray(b))
    ty, ts = TS.causal_conv_step(torch.from_numpy(x[:, 0]),
                                 torch.from_numpy(state), w,
                                 torch.from_numpy(b))
    assert rel(ty, jy) <= 1e-6
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_state_match_reference(arch, length):
    jcfg, tcfg, p = _params(arch)
    x = _x(jcfg, length)
    jf, tf = _fns(jcfg, JS)["forward"], _fns(tcfg, TS)["forward"]
    jo, jst = jf(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg,
                 return_state=True)
    with torch.no_grad():
        to, tst = tf(bridge.to_torch(p), torch.from_numpy(x), tcfg,
                     return_state=True)
        plain = tf(bridge.to_torch(p), torch.from_numpy(x), tcfg)
    assert rel(to, jo) <= TOL
    assert torch.equal(plain, to)
    assert tst["h"].dtype == torch.float32
    assert tuple(tst["h"].shape) == tuple(jst["h"].shape)
    assert tuple(tst["conv"].shape) == tuple(jst["conv"].shape)
    assert rel(tst["h"], jst["h"]) <= TOL
    assert rel(tst["conv"], jst["conv"]) <= TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_taps_match_reference(arch):
    # the calibration taps the forward sows, under the block's scope
    jcfg, tcfg, p = _params(arch)
    x = _x(jcfg, 23)
    jstore, tstore = {}, {}
    with JL.sowing(jstore), JL.scope("mixer"):
        _fns(jcfg, JS)["forward"](jax.tree.map(jnp.asarray, p),
                                  jnp.asarray(x), jcfg)
    with torch.no_grad(), TL.sowing(tstore), TL.scope("mixer"):
        _fns(tcfg, TS)["forward"](bridge.to_torch(p), torch.from_numpy(x),
                                  tcfg)
    assert sorted(tstore) == sorted(jstore)
    want = ({"mixer/in_proj_in", "mixer/x_proj_in", "mixer/dt_proj_in",
             "mixer/out_proj_in"} if jcfg.ssm.version == 1
            else {"mixer/in_proj_in", "mixer/out_proj_in"})
    assert set(tstore) == want
    for tap in tstore:
        assert rel(tstore[tap], jstore[tap]) <= TOL, tap


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_rollout_matches_reference(arch):
    # prefill 13 tokens (return_state), then 10 decode steps from that
    # state in both packages; the port's rollout also equals its own
    # forward over the 23 tokens
    jcfg, tcfg, p = _params(arch)
    x = _x(jcfg, 23, seed=5)
    jfn, tfn = _fns(jcfg, JS), _fns(tcfg, TS)
    jp, tp = jax.tree.map(jnp.asarray, p), bridge.to_torch(p)
    _, jstate = jfn["forward"](jp, jnp.asarray(x[:, :13]), jcfg,
                               return_state=True)
    with torch.no_grad():
        full = tfn["forward"](tp, torch.from_numpy(x), tcfg)
        _, tstate = tfn["forward"](tp, torch.from_numpy(x[:, :13]), tcfg,
                                   return_state=True)
        touts = []
        for t in range(13, 23):
            y, tstate = tfn["decode"](tp, torch.from_numpy(x[:, t:t + 1]),
                                      tstate, tcfg)
            touts.append(y)
    jouts = []
    for t in range(13, 23):
        y, jstate = jfn["decode"](jp, jnp.asarray(x[:, t:t + 1]), jstate,
                                  jcfg)
        jouts.append(y)
    got = torch.cat(touts, dim=1)
    assert rel(got, jnp.concatenate(jouts, axis=1)) <= TOL
    assert rel(tstate["h"], jstate["h"]) <= TOL
    assert rel(tstate["conv"], jstate["conv"]) <= TOL
    # the chunked scan (or SSD) equals the step recurrence
    assert rel(got, full[:, 13:]) <= 1e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_init_state_matches_reference(arch):
    jcfg, tcfg, p = _params(arch)
    want = _fns(jcfg, JS)["init_state"](None, jcfg, 3, jnp.bfloat16)
    got = _fns(tcfg, TS)["init_state"](None, tcfg, 3, torch.bfloat16)
    for key in ("h", "conv"):
        assert tuple(got[key].shape) == tuple(want[key].shape)
        assert str(got[key].dtype).replace("torch.", "") == \
            str(want[key].dtype)
        assert not got[key].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_reference(arch):
    # refinement differentiates the scans: d(sum(out * r))/d(every param,
    # x) over 23 tokens (two chunks, the second padded), each chunk
    # recomputed in the backward pass in both packages
    jcfg, tcfg, p = _params(arch)
    x = _x(jcfg, 23, seed=7)
    r = np.random.default_rng(8).standard_normal(x.shape).astype(np.float32)
    jf, tf = _fns(jcfg, JS)["forward"], _fns(tcfg, TS)["forward"]

    def jloss(pp, xx):
        return jnp.sum(jf(pp, xx, jcfg) * jnp.asarray(r))

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jax.tree.map(jnp.asarray, p),
                                               jnp.asarray(x))
    tp = jax.tree.map(lambda t: t.requires_grad_(True), bridge.to_torch(p),
                      is_leaf=torch.is_tensor)
    tx = torch.from_numpy(x).requires_grad_(True)
    loss = torch.sum(tf(tp, tx, tcfg) * torch.from_numpy(r))
    leaves = jax.tree_util.tree_leaves(tp, is_leaf=torch.is_tensor)
    grads = torch.autograd.grad(loss, leaves + [tx])
    want = jax.tree_util.tree_leaves(jgp)
    assert len(want) == len(leaves)
    for g, w, (path, _) in zip(grads, want,
                               jax.tree_util.tree_flatten_with_path(jgp)[0]):
        assert rel(g, w) <= TOL, (jax.tree_util.keystr(path), rel(g, w))
    assert rel(grads[-1], jgx) <= TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_factorized_linears_match_reference(arch):
    # compressed blocks: every linear of the mixer as {"v", "u"} factors
    # (the port's lowrank_matmul plain version on the CPU)
    jcfg, tcfg, p = _params(arch)
    rng = np.random.default_rng(11)
    p = dict(p)
    for name in ("in_proj", "x_proj", "dt_proj", "out_proj"):
        if name not in p:
            continue
        n, m = p[name]["w"].shape
        k = max(1, min(n, m) // 2)
        p[name] = {"v": (rng.standard_normal((n, k)) / np.sqrt(n)
                         ).astype(np.float32),
                   "u": (rng.standard_normal((k, m)) / np.sqrt(k)
                         ).astype(np.float32)}
    x = _x(jcfg, 23, seed=12)
    jo, jst = _fns(jcfg, JS)["forward"](jax.tree.map(jnp.asarray, p),
                                        jnp.asarray(x), jcfg,
                                        return_state=True)
    with torch.no_grad():
        to, tst = _fns(tcfg, TS)["forward"](bridge.to_torch(p),
                                            torch.from_numpy(x), tcfg,
                                            return_state=True)
    assert rel(to, jo) <= TOL
    assert rel(tst["h"], jst["h"]) <= TOL


def test_rope_tables_of_an_attention_free_config():
    # falcon-mamba's head_dim 1: empty RoPE tables in both packages
    jcfg, tcfg = _cfgs("falcon-mamba-7b")
    want = JM.make_ctx(jcfg, jnp.arange(5))
    got = TM.make_ctx(tcfg, torch.arange(5))
    for key in ("cos", "sin"):
        assert tuple(got[key].shape) == tuple(want[key].shape) == (5, 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_block_cache_paths_write_in_place(arch):
    # prefill_sub_block / decode_sub_block write the new state into the
    # cache buffers they are given (views of a stacked cache included) and
    # agree with the reference's block functions; chunked prefill raises
    jcfg, tcfg, p = _params(arch)
    kind = "mamba1" if jcfg.ssm.version == 1 else "mamba2"
    block = {"ln": {"scale": np.linspace(0.5, 1.5, jcfg.d_model,
                                         dtype=np.float32)}, "mixer": p}
    x = _x(jcfg, 9, seed=13)
    from repro.models import blocks as JB
    jc = JB.init_sub_cache(kind, jcfg, 2, 16, jnp.float32)
    jy, jc, _ = JB.prefill_sub_block(kind, jax.tree.map(jnp.asarray, block),
                                     jnp.asarray(x), jc, jcfg, {"pos": 0})
    jd, jc = JB.decode_sub_block(kind, jax.tree.map(jnp.asarray, block),
                                 jnp.asarray(x[:, :1]), jc, jcfg,
                                 {"pos": 9})
    stacked = TB.init_sub_cache(kind, tcfg, 2, 16, torch.float32)
    stacked = {k: v.new_zeros((3,) + v.shape) for k, v in stacked.items()}
    view = {k: v[1] for k, v in stacked.items()}
    tb = bridge.to_torch(block)
    with torch.no_grad():
        ty, out, _ = TB.prefill_sub_block(kind, tb, torch.from_numpy(x),
                                          view, tcfg, {"pos": 0})
        assert out is view
        td, _ = TB.decode_sub_block(kind, tb, torch.from_numpy(x[:, :1]),
                                    view, tcfg, {"pos": 9})
        with pytest.raises(ValueError, match="chunked"):
            TB.prefill_sub_block(kind, tb, torch.from_numpy(x), view, tcfg,
                                 {"pos": 0, "chunked": True})
    assert rel(ty, jy) <= TOL and rel(td, jd) <= TOL
    for key in ("h", "conv"):
        assert rel(stacked[key][1], jc[key]) <= TOL
        assert not stacked[key][0].any() and not stacked[key][2].any()


def _ssd_reference_formula(a, d_skip, s_state, x_c, b_c, c_c, dt_c):
    """The reference's SSD body (``src/repro/models/ssm.py:227``) written in
    torch: exp over the whole chunk square, the causal mask after."""
    da = dt_c * a
    cums = torch.cumsum(da, dim=1)
    cb = torch.einsum("bin,bjn->bij", c_c, b_c)
    dec = torch.exp(cums[:, :, None, :] - cums[:, None, :, :])
    ii = torch.arange(x_c.shape[1])
    causal = (ii[:, None] >= ii[None, :]).to(dec.dtype)
    w = cb[..., None] * dec * causal[None, :, :, None] * dt_c[:, None, :, :]
    y = torch.einsum("bijh,bjhp->bihp", w, x_c)
    y = y + torch.einsum("bin,bhpn->bihp", c_c, s_state) \
        * torch.exp(cums)[..., None]
    decay_out = torch.exp(cums[:, -1:, :] - cums) * dt_c
    s_new = s_state * torch.exp(cums[:, -1])[:, :, None, None] \
        + torch.einsum("bjn,bjh,bjhp->bhpn", b_c, decay_out, x_c)
    y = y + d_skip[None, None, :, None] * x_c
    return s_new, y


def test_ssd_body_masks_before_the_exp():
    rng = np.random.default_rng(21)
    b, c, nh, hp, n = 2, 16, 4, 8, 5
    x_c = torch.from_numpy(rng.standard_normal((b, c, nh, hp))
                           .astype(np.float32))
    b_c, c_c = (torch.from_numpy(rng.standard_normal((b, c, n))
                                 .astype(np.float32)) for _ in range(2))
    s0 = torch.from_numpy(rng.standard_normal((b, nh, hp, n))
                          .astype(np.float32))
    a = -torch.from_numpy(rng.uniform(0.5, 2.0, nh).astype(np.float32))
    d_skip = torch.ones(nh)
    # finite regime: the same bits as the reference's formula
    dt = torch.from_numpy(rng.uniform(0.001, 0.1, (b, c, nh))
                          .astype(np.float32))
    got = TS._ssd_chunk_body(a, d_skip, s0, x_c, b_c, c_c, dt)
    want = _ssd_reference_formula(a, d_skip, s0, x_c, b_c, c_c, dt)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # past the overflow (a chunk's decay ~ 160): the reference's formula is
    # NaN, the masked body finite
    dt = torch.full((b, c, nh), 10.0)
    _, ref_y = _ssd_reference_formula(a, d_skip, s0, x_c, b_c, c_c, dt)
    _, y = TS._ssd_chunk_body(a, d_skip, s0, x_c, b_c, c_c, dt)
    assert torch.isnan(ref_y).any() and torch.isfinite(y).all()


def test_mamba2_past_the_overflow_equals_the_recurrence():
    # dt_bias 10 (softplus ~ 10 a token): the reference's SSD overflows to
    # NaN; the port's forward equals its own step recurrence (decode)
    jcfg, tcfg, p = _params(ZAMBA)
    p = dict(p, dt_bias=np.full_like(p["dt_bias"], 10.0))
    x = _x(jcfg, 32, seed=9)
    jo = JS.mamba2_forward(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                           jcfg)
    assert bool(jnp.isnan(jo).any())
    tp = bridge.to_torch(p)
    with torch.no_grad():
        got = TS.mamba2_forward(tp, torch.from_numpy(x), tcfg)
        state = TS.mamba2_init_state(None, tcfg, 2)
        steps = []
        for t in range(32):
            y, state = TS.mamba2_decode(tp, torch.from_numpy(x[:, t:t + 1]),
                                        state, tcfg)
            steps.append(y)
    assert torch.isfinite(got).all()
    assert rel(got, torch.cat(steps, dim=1)) <= 1e-4
