"""Algorithm 2 on llama smoke: the port's ``compress_model`` against the JAX
package's, on the zoo recipe (``zoo.SMOKE_COMPRESS``: ratio 0.6,
``rank_multiple=1``, microbatch 2, one refine epoch), fused and sequential.

Two calibration sets:

* ``numpy``: 8 × 32 tokens drawn with numpy, uniform over the vocabulary.
  Every tap's activation covariance has full rank there (256 rows for at
  most 160 columns), so the solve is well conditioned and the port must
  match the reference tightly: composed maps to 1e-3 relative Frobenius,
  refine MSEs to rtol 1e-3, ppl to 0.5 %.
* ``zoo``: ``zoo.SMOKE_CALIB`` (4 × 32 tokens from ``repro.data``), the
  conformance harness's own set.  It holds only 40 distinct tokens, so
  layer 0's qkv covariance has rank 40 of 64 and every ``ffn/down_in``
  covariance rank ≤ 128 of 160.  The reference whitens with an eigenvalue
  floor of 1e-6·λmax, which magnifies fp32 rounding in the null directions
  about 1000-fold; those directions are fixed by rounding alone, and
  held-out tokens read them.  Two witnesses on this set:

  - the JAX package against itself: the same four sequences with the two
    in each microbatch swapped (the same sums in another order) move its
    ppl from 445.96 to 442.58, 0.76 %, more than the 0.5 % that the
    well-conditioned set is held to;
  - the port with its ``eigh``/``svd`` taken from JAX: on the two orders
    the port's ppl is 442.78 / 447.22 against the reference's 445.96 /
    442.58 — gaps of either sign, means 0.16 % apart.  With torch's own
    LAPACK the port reads 453.73 / 448.30, 1.74 % / 1.29 % above: a
    one-signed offset of the linear-algebra library in the null
    directions, plus the rounding spread of the first witness.

  So this set holds the port's ppl to 2.5 % of the reference's on both
  orders (the measured gaps are 1.74 % and 1.29 %; the compression itself
  moves ppl by 9.5 %, 492.68 dense to 445.96), and the port on JAX's
  linear algebra to 0.5 % in the mean over the orders.
* ``width``: llama smoke widened to d_model 512 (8 × 512 numpy tokens),
  where one refine epoch raises the unit MSE in the JAX package itself;
  the port must do the same, alike.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import zoo
from repro.core.pipeline import CompressConfig as JCompressConfig
from repro.core.pipeline import compress_model as j_compress
from repro.core.pipeline import compress_ratio_report as j_ratio
from repro.data import calibration_set, make_batch_iterator
from repro.models import model as JM
from repro_torch import bridge
from repro_torch import configs as TC
from repro_torch.core import pipeline as TP
from repro_torch.models import model as TM

PATHS = ["attn.wq", "attn.wk", "attn.wv", "attn.wo", "ffn.gate", "ffn.up",
         "ffn.down"]


def _setup():
    cfg = zoo.smoke_cfg("llama-7b")
    tcfg = TC.get_smoke_config("llama-7b").replace(dtype="float32")
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, tcfg, params


def _port_ppl(tparams, tcfg, batches):
    with torch.no_grad():
        tot = sum(float(TM.loss_fn(tparams, tcfg,
                                   {k: torch.from_numpy(np.array(v))
                                    for k, v in b.items()})[0])
                  for b in batches)
    return float(np.exp(tot / len(batches)))


def _jax_ppl(params, cfg, batches):
    tot = sum(float(JM.loss_fn(params, cfg,
                               {k: jnp.asarray(v) for k, v in b.items()})[0])
              for b in batches)
    return float(np.exp(tot / len(batches)))


@pytest.fixture(scope="module", params=["fused", "sequential"])
def numpy_run(request):
    cfg, tcfg, params = _setup()
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, size=(8, 32), dtype=np.int32)
    evals = []
    for _ in range(2):
        t = rng.integers(0, cfg.vocab_size, size=(8, 65), dtype=np.int32)
        evals.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    recipe = dict(zoo.SMOKE_COMPRESS, calib_mode=request.param)
    jc, jrep = j_compress(params, cfg, {"tokens": jnp.asarray(toks)},
                          JCompressConfig(**recipe))
    tparams = bridge.to_torch(jax.tree.map(np.asarray, params))
    before = bridge.to_numpy(tparams)
    stages = {}
    tc, trep = TP.compress_model(tparams, tcfg, {"tokens": toks},
                                 TP.CompressConfig(**recipe), device="cpu",
                                 stage_times=stages)
    return dict(cfg=cfg, tcfg=tcfg, params=params, tparams=tparams,
                before=before, jc=jc, jrep=jrep, tc=tc, trep=trep,
                evals=evals, stages=stages)


def test_composed_maps_match(numpy_run):
    js = numpy_run["jc"]["stages"][0][0]
    ts = numpy_run["tc"]["stages"][0][0]
    for path in PATHS:
        a, b = path.split(".")
        want = np.einsum("lnk,lkm->lnm", np.asarray(js[a][b]["v"]),
                         np.asarray(js[a][b]["u"]))
        got = torch.einsum("lnk,lkm->lnm", ts[a][b]["v"],
                           ts[a][b]["u"]).numpy()
        for layer in range(want.shape[0]):
            err = (np.linalg.norm(got[layer] - want[layer])
                   / np.linalg.norm(want[layer]))
            assert err <= 1e-3, (path, layer, err)


def test_refine_mse_match(numpy_run):
    for ju, tu in zip(numpy_run["jrep"]["units"], numpy_run["trep"]["units"]):
        for key in ("pre_refine_mse", "post_refine_mse"):
            np.testing.assert_allclose(tu[key], ju[key], rtol=1e-3)
        assert tu["refine_steps"] == ju["refine_steps"]
        assert tu["tapped_forwards"] == ju["tapped_forwards"]
        assert [lin["rank"] for lin in tu["linears"]] == \
            [lin["rank"] for lin in ju["linears"]]


def test_report_key_sets(numpy_run):
    jrep, trep = numpy_run["jrep"], numpy_run["trep"]
    assert set(trep) == set(jrep)
    for key in ("calibration", "refinement", "config"):
        assert set(trep[key]) == set(jrep[key]), key
    for ju, tu in zip(jrep["units"], trep["units"]):
        assert set(tu) == set(ju)
        for jl, tl in zip(ju["linears"], tu["linears"]):
            assert set(tl) == set(jl)
    assert trep["calibration"]["tapped_forwards"] == \
        jrep["calibration"]["tapped_forwards"]


def test_stage_times_cover_every_stage(numpy_run):
    stages = numpy_run["stages"]
    assert set(stages) == set(TP.STAGES)
    assert all(t >= 0.0 for t in stages.values())
    assert stages["solve"] > 0.0 and stages["refine"] > 0.0


def test_ppl_matches_reference(numpy_run):
    want = _jax_ppl(numpy_run["jc"], numpy_run["cfg"], numpy_run["evals"])
    got = _port_ppl(numpy_run["tc"], numpy_run["tcfg"], numpy_run["evals"])
    assert abs(got / want - 1) <= 5e-3, (got, want)


def test_params_untouched_and_ratio_report(numpy_run):
    after = bridge.to_numpy(numpy_run["tparams"])
    for a, b in zip(jax.tree.leaves(after),
                    jax.tree.leaves(numpy_run["before"])):
        assert a.tobytes() == b.tobytes()
    want = j_ratio(numpy_run["params"], numpy_run["jc"])
    got = TP.compress_ratio_report(numpy_run["tparams"], numpy_run["tc"])
    assert got == want


def _swap_in_microbatch(tokens, microbatch):
    """The same sequences, reversed inside each microbatch: every microbatch
    holds the same rows, so only the order of the sums changes."""
    order = np.concatenate([np.arange(i, i + microbatch)[::-1]
                            for i in range(0, len(tokens), microbatch)])
    return tokens[order]


def _jax_linalg(monkeypatch):
    """Route the port's ``torch.linalg.eigh``/``svd`` through JAX's (the
    reference's LAPACK), fp32, on the CPU."""
    def eigh(a):
        lam, q = jnp.linalg.eigh(jnp.asarray(a.numpy()))
        return torch.from_numpy(np.array(lam)), torch.from_numpy(np.array(q))

    def svd(a, full_matrices=True):
        out = jnp.linalg.svd(jnp.asarray(a.numpy()),
                             full_matrices=full_matrices)
        return tuple(torch.from_numpy(np.array(x)) for x in out)

    monkeypatch.setattr(torch.linalg, "eigh", eigh)
    monkeypatch.setattr(torch.linalg, "svd", svd)


@pytest.fixture(scope="module")
def zoo_runs():
    cfg, tcfg, params = _setup()
    tparams = bridge.to_torch(jax.tree.map(np.asarray, params))
    toks = np.asarray(calibration_set(cfg, zoo.SMOKE_CALIB["n"],
                                      zoo.SMOKE_CALIB["seq_len"])["tokens"])
    data = make_batch_iterator(cfg, 8, 64, seed=99)
    evals = [{k: np.asarray(v) for k, v in next(data).items()}
             for _ in range(2)]
    recipe = zoo.SMOKE_COMPRESS
    runs = {}
    for order, t in (("zoo", toks),
                     ("swapped", _swap_in_microbatch(
                         toks, recipe["microbatch"]))):
        jc, jrep = j_compress(params, cfg, {"tokens": jnp.asarray(t)},
                              JCompressConfig(**recipe))
        tc, trep = TP.compress_model(tparams, tcfg, {"tokens": t},
                                     TP.CompressConfig(**recipe),
                                     device="cpu")
        with pytest.MonkeyPatch.context() as mp:
            _jax_linalg(mp)
            tcj, _ = TP.compress_model(tparams, tcfg, {"tokens": t},
                                       TP.CompressConfig(**recipe),
                                       device="cpu")
        runs[order] = dict(jax=_jax_ppl(jc, cfg, evals),
                           port=_port_ppl(tc, tcfg, evals),
                           port_jax_linalg=_port_ppl(tcj, tcfg, evals),
                           jrep=jrep, trep=trep)
    return runs


def test_zoo_recipe_ppl(zoo_runs):
    run = zoo_runs["zoo"]
    for order in ("zoo", "swapped"):
        got, want = zoo_runs[order]["port"], zoo_runs[order]["jax"]
        assert abs(got / want - 1) <= 2.5e-2, (order, got, want)
    # the first unit sees identical streams on both sides: its pre-refine
    # MSE is a function of the calibration data only
    np.testing.assert_allclose(run["trep"]["units"][0]["pre_refine_mse"],
                               run["jrep"]["units"][0]["pre_refine_mse"],
                               rtol=5e-3)


def test_zoo_reference_rounding_spread(zoo_runs):
    # the witness: a reorder of the same sums moves the reference's own ppl
    # by more than the 0.5 % the well-conditioned set is held to
    a, b = zoo_runs["zoo"]["jax"], zoo_runs["swapped"]["jax"]
    assert abs(a / b - 1) >= 5e-3, (a, b)


def test_zoo_port_on_reference_linalg(zoo_runs):
    # on JAX's eigh/svd the port's one-signed offset is gone: the mean ppl
    # over the two orders is within 0.5 % of the reference's mean
    orders = ("zoo", "swapped")
    got = np.mean([zoo_runs[o]["port_jax_linalg"] for o in orders])
    want = np.mean([zoo_runs[o]["jax"] for o in orders])
    assert abs(got / want - 1) <= 5e-3, (got, want)


# measured (CPU): unit 0 pre/post within 1.5e-5 relative, unit 1 pre 3.3e-3
# and post 8.5e-3.  Unit 1 reads unit 0's refined output, which one Adam
# step has moved by about lr in every coordinate, whatever its gradient's
# size, and its MSE amplifies the rounding it is fed
def test_refine_at_width_matches_reference():
    d_model, heads, d_ff, seq = 512, 8, 1376, 512
    kw = dict(d_model=d_model, num_heads=heads, num_kv_heads=heads,
              head_dim=d_model // heads, d_ff=d_ff)
    cfg = zoo.smoke_cfg("llama-7b").replace(**kw)
    tcfg = TC.get_smoke_config("llama-7b").replace(dtype="float32", **kw)
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (8, seq),
                                             dtype=np.int32)
    recipe = dict(ratio=0.6, rank_multiple=8, microbatch=4,
                  calib_mode="fused", refine_epochs=1)
    _, jrep = j_compress(params, cfg, {"tokens": jnp.asarray(toks)},
                         JCompressConfig(**recipe))
    _, trep = TP.compress_model(
        bridge.to_torch(jax.tree.map(np.asarray, params)), tcfg,
        {"tokens": toks}, TP.CompressConfig(**recipe), device="cpu")
    ju, tu = jrep["units"], trep["units"]
    # unit 0 sees identical inputs on both sides
    for key in ("pre_refine_mse", "post_refine_mse"):
        np.testing.assert_allclose(tu[0][key], ju[0][key], rtol=1e-3)
    np.testing.assert_allclose(tu[1]["pre_refine_mse"],
                               ju[1]["pre_refine_mse"], rtol=1e-2)
    np.testing.assert_allclose(tu[1]["post_refine_mse"],
                               ju[1]["post_refine_mse"], rtol=2e-2)
    # refinement raises every unit's MSE in the reference, and in the port
    for rep in (ju, tu):
        for unit in rep:
            assert unit["post_refine_mse"] > 2 * unit["pre_refine_mse"], unit
